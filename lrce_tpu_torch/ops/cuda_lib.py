"""Build and load the port's CUDA kernels (``lrce_tpu_torch/csrc``).

The sources have a plain C interface and include no PyTorch header. One
``nvcc`` per source compiles them all at once (in parallel), a final
``nvcc`` links them into one shared library, and ``ctypes`` loads it. The
build runs at first use, into ``lrce_tpu_torch/_build/`` (ignored by git),
under a name that carries a hash of the sources, so an edited source is
rebuilt and an unchanged one is not. Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("swin_common.cu", "swin_block.cu", "back_half.cu",
           "window_attn.cu", "attn_fwd.cu", "attn_bwd.cu", "mlp_bwd.cu",
           "ln_mlp.cu", "gemm.cu")
HEADERS = ("swin_common.cuh", "hopper.cuh", "gemm_tile.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of every exported function; every pointer and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints
_SIGNATURES = {
    "lrce_swin_block_fwd": (
        [_P, _P] + [_I] * 12 + [_I, _F] + [_P] * 18 + [_I, _I] + [_P] * 3
        + [_P]),
    "lrce_back_half": [_P] * 3 + [_I] * 11 + [_F] + [_P] * 10 + [_P],
    "lrce_fused_mlp": [_P, _P, _I, _I, _F] + [_P] * 6 + [_P],
    "lrce_window_attn_fwd": (
        [_P, _P] + [_I] * 11 + [_I, _F] + [_P] * 10 + [_I] + [_P] * 2 + [_P]),
    "lrce_window_attn_core": [_P] * 6 + [_I] * 6 + [_P],
    "lrce_attn_bwd": (
        [_P, _P] + [_I] * 11 + [_I, _F] + [_P] * 7 + [_P] * 5 + [_P] * 9
        + [_I, _I, _P]),
    "lrce_mlp_bwd": (
        [_P, _P] + [_I] * 6 + [_F] + [_P] * 6 + [_P] * 5 + [_P] * 5
        + [_I, _I, _P]),
    "lrce_gemm": [_P, _P, _P] + [_I] * 5 + [_P, _P, _I, _P, _P],
    "lrce_gemm_tn": [_P, _P, _P] + [_I] * 4 + [_P, _P],
    "lrce_tmap_encode_ns": [_I, _P],
    "lrce_ln_rows": [_P, _P] + [_I] * 11 + [_F] + [_P, _P] + [_I] + [_P],
    "lrce_ln_mlp_fwd": (
        [_P, _P] + [_I] * 7 + [_F] + [_P] * 7 + [_P] * 4 + [_P]),
}


class Library(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when the library was already built
    build_log: str         # nvcc's output (ptxas register / spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands at once; raise if any fails. Returns their output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return "".join(logs)


def build() -> tuple[Path, float, str]:
    """Compile the sources for sm_90a unless this exact build exists.
    Returns (library path, seconds spent compiling, compiler output)."""
    path = BUILD_DIR / f"liblrce_kernels_{_digest()}.so"
    if path.exists():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(CSRC / s),
                     "-o", str(o)] for s, o in zip(SOURCES, objs)])
    tmp = path.with_suffix(f".{tag}")
    log += _run_all([[nvcc, *ARCH_FLAGS, *LINK_FLAGS, "-o", str(tmp),
                      *map(str, objs)]])
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    os.replace(tmp, path)   # atomic: concurrent builders never see half a file
    return path, seconds, log


@functools.cache
def library() -> Library:
    """The loaded kernel library, built on first use."""
    path, seconds, log = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lrce_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lrce_cuda_error_string.restype = ctypes.c_char_p
    return Library(lib, path, seconds, log)


def check(name: str, code: int) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if code != 0:
        msg = library().lib.lrce_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
