"""Build and load the port's CUDA kernels (``lrce_tpu_torch/csrc``).

The sources have a plain C interface and include no PyTorch header, so
``nvcc`` builds them into one shared library in a few seconds; ``ctypes``
loads it. The build runs at first use, into ``lrce_tpu_torch/_build/``
(ignored by git), under a name that carries a hash of the sources, so an
edited source is rebuilt and an unchanged one is not. Nothing here runs when
the module is imported.
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
SOURCES = ("swin_common.cu", "swin_block.cu", "window_attn.cu")
HEADERS = ("swin_common.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of every exported function; every pointer and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints
_SIGNATURES = {
    "lrce_swin_block_fwd": (
        [_P, _P] + [_I] * 12 + [_I, _F] + [_P] * 16 + [_P] * 3 + [_P]),
    "lrce_window_attn_fwd": (
        [_P, _P] + [_I] * 8 + [_I, _F] + [_P] * 8 + [_P] * 2 + [_P]),
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
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile the sources for sm_90a unless this exact build exists.
    Returns (library path, seconds spent compiling, compiler output)."""
    path = BUILD_DIR / f"liblrce_kernels_{_digest()}.so"
    if path.exists():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
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
