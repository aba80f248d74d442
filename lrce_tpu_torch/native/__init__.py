"""ctypes bindings for the port's native C++ host runtime (the ``.cpp``
files beside this module), with the functions of ``lrce_tpu/native``.

Two shared libraries are built at first use by ``g++`` directly, into
``lrce_tpu_torch/_build/`` (ignored by git) under names that carry a hash
of their sources and flags, so an edited source is rebuilt:

  - ``liblrce_native_<hash>.so`` (wordpiece, gifdec, image):
    ``NativeWordPiece`` (the ASCII fast path of the tokenizer),
    ``gif_probe`` / ``gif_decode`` (a GIF decoder of its own) and
    ``resize_bilinear`` (PIL's antialiased bilinear resize, byte-exact);
  - ``liblrce_video_<hash>.so`` (video, image; linked against libav*):
    ``video_probe`` / ``video_decode_sampled`` for .avi / .mp4.

A failed build logs the compiler's output once and its loader returns
None, so callers take the Python / PIL / cv2 path; a failed video build
leaves the core library usable. Nothing is built when the module is
imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np

from lrce_tpu_torch.utils.logging import get_logger

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
BUILD_TIMEOUT_S = 300


class _Spec(NamedTuple):
    name: str
    sources: Tuple[str, ...]
    libs: Tuple[str, ...]


CORE = _Spec("liblrce_native", ("wordpiece.cpp", "gifdec.cpp", "image.cpp"),
             ())
VIDEO = _Spec("liblrce_video", ("video.cpp", "image.cpp"),
              ("-lavformat", "-lavcodec", "-lavutil", "-lswscale"))


class Built(NamedTuple):
    lib: Optional[ctypes.CDLL]   # None when the build or the load failed
    path: Path
    build_seconds: float         # 0.0 when the library was already built


def _library_path(spec: _Spec) -> Path:
    h = hashlib.sha256()
    for name in spec.sources:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + spec.libs).encode())
    return BUILD_DIR / f"{spec.name}_{h.hexdigest()[:16]}.so"


def _build(spec: _Spec) -> Tuple[Path, float]:
    """Compile ``spec`` unless this exact build exists. Raises RuntimeError
    with the compiler's output when it fails."""
    path = _library_path(spec)
    if path.exists():
        return path, 0.0
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
           *(str(NATIVE_DIR / s) for s in spec.sources), *spec.libs]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode})"
                               f":\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)   # atomic: no concurrent build sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return path, time.perf_counter() - t0


_P = ctypes.c_void_p
_I = ctypes.c_int
_S = ctypes.c_char_p
_IP = ctypes.POINTER(ctypes.c_int)
_LP = ctypes.POINTER(ctypes.c_long)
_BP = ctypes.POINTER(ctypes.c_ubyte)

# (restype, argtypes) of every exported function
_SIGNATURES = {
    CORE.name: {
        "wp_load": (_P, [_S]),
        "wp_free": (None, [_P]),
        "wp_encode": (_I, [_P, _S, _S, _I, _I, _I, _LP, _LP, _LP]),
        "gif_probe": (_I, [_S, _IP, _IP, _IP]),
        "gif_decode": (_I, [_S, _BP, _I]),
        "resize_bilinear_u8": (_I, [_BP, _I, _I, _I, _BP, _I, _I]),
    },
    VIDEO.name: {
        "video_probe": (_I, [_S, _IP, _IP, _IP]),
        "video_decode_sampled": (_I, [_S, _IP, _I, _BP, _I, _I]),
    },
}

_lock = threading.Lock()


@functools.cache
def _load_once(spec: _Spec) -> Built:
    path = _library_path(spec)
    try:
        path, seconds = _build(spec)
        lib = ctypes.CDLL(str(path))
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as err:
        get_logger(__name__).warning(
            f"native library {spec.name} unavailable, the Python path "
            f"serves instead: {err}")
        return Built(None, path, 0.0)
    for fn_name, (restype, argtypes) in _SIGNATURES[spec.name].items():
        fn = getattr(lib, fn_name)
        fn.restype = restype
        fn.argtypes = argtypes
    return Built(lib, path, seconds)


def built(spec: _Spec = CORE) -> Built:
    """``spec``'s library, built and loaded on the first call (one attempt
    a process), with the seconds that call spent compiling."""
    with _lock:
        return _load_once(spec)


def load_native() -> Optional[ctypes.CDLL]:
    """The core library (tokenizer, GIF decoder, resize), or None."""
    return built(CORE).lib


def native_available() -> bool:
    return load_native() is not None


def _require_native() -> ctypes.CDLL:
    lib = load_native()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


class NativeWordPiece:
    """C++ WordPiece handle over a vocab.txt; ASCII-only fast path."""

    def __init__(self, vocab_path: str):
        self._lib = _require_native()
        self._handle = self._lib.wp_load(vocab_path.encode())
        if not self._handle:
            raise RuntimeError(f"failed to load vocab {vocab_path}")

    def encode(self, text: str, text_pair: Optional[str] = None,
               max_length: Optional[int] = None,
               truncation: bool = False):
        """Returns (ids, mask, types) int64 arrays, or None when the input
        needs the Python Unicode path."""
        cap = max(256, (max_length or 0) + 8)
        while True:
            ids = np.zeros(cap, np.int64)
            mask = np.zeros(cap, np.int64)
            types = np.zeros(cap, np.int64)
            n = self._lib.wp_encode(
                self._handle, text.encode(),
                text_pair.encode() if text_pair is not None else None,
                max_length or 0, int(truncation), cap,
                ids.ctypes.data_as(_LP), mask.ctypes.data_as(_LP),
                types.ctypes.data_as(_LP))
            if n < 0:
                return None
            if n <= cap:
                return ids[:n], mask[:n], types[:n]
            cap = n     # nothing was written: again, with room for n

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.wp_free(self._handle)


def gif_probe(path: str) -> Tuple[int, int, int]:
    """(width, height, frame count) of a GIF."""
    lib = _require_native()
    w, h, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.gif_probe(path.encode(), ctypes.byref(w), ctypes.byref(h),
                       ctypes.byref(n))
    if rc < 0:
        raise IOError(f"gif_probe({path}) failed: {rc}")
    return w.value, h.value, n.value


def gif_decode(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Decode all (or the first max_frames) frames -> (N, H, W, 3) uint8."""
    lib = _require_native()
    w, h, n = gif_probe(path)
    if max_frames is not None:
        n = min(n, max_frames)
    out = np.empty((n, h, w, 3), np.uint8)
    rc = lib.gif_decode(path.encode(), out.ctypes.data_as(_BP), n)
    if rc < 0:
        raise IOError(f"gif_decode({path}) failed: {rc}")
    return out[:rc]


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL-exact bilinear resize of (H, W, C) uint8 to size=(H', W')."""
    lib = _require_native()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((size[0], size[1], c), np.uint8)
    rc = lib.resize_bilinear_u8(img.ctypes.data_as(_BP), h, w, c,
                                out.ctypes.data_as(_BP), size[0], size[1])
    if rc != 0:
        raise RuntimeError("resize_bilinear_u8 failed")
    return out


# ---------------------------------------------------------------------------
# Video decode (its own library, linked against the system libav*): a host
# without libavformat keeps the core library and falls back to cv2 for
# .avi / .mp4.
# ---------------------------------------------------------------------------

def load_native_video() -> Optional[ctypes.CDLL]:
    return built(VIDEO).lib


def video_available() -> bool:
    return load_native_video() is not None


def _require_video() -> ctypes.CDLL:
    lib = load_native_video()
    if lib is None:
        raise RuntimeError("native video library unavailable")
    return lib


def video_probe(path: str) -> Tuple[int, int, int]:
    """Decodable frame count + native dims -> (n_frames, width, height)."""
    lib = _require_video()
    n, w, h = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.video_probe(path.encode(), ctypes.byref(n), ctypes.byref(w),
                         ctypes.byref(h))
    if rc != 0:
        raise IOError(f"video_probe({path}) failed: {rc}")
    return n.value, w.value, h.value


def video_decode_sampled(path: str, indices: np.ndarray,
                         size: Tuple[int, int]) -> np.ndarray:
    """Decode the (sorted unique, ascending) frame ``indices`` and resize
    each to size=(H', W') -> (len(indices), H', W', 3) uint8. Byte-exact
    with cv2's ffmpeg backend (the same libavcodec decode)."""
    lib = _require_video()
    idx = np.ascontiguousarray(indices, np.int32)
    out = np.empty((len(idx), size[0], size[1], 3), np.uint8)
    rc = lib.video_decode_sampled(path.encode(), idx.ctypes.data_as(_IP),
                                  len(idx), out.ctypes.data_as(_BP),
                                  size[0], size[1])
    if rc != 0:
        raise IOError(f"video_decode_sampled({path}): {rc} wanted frames "
                      "unreadable" if rc > 0 else
                      f"video_decode_sampled({path}) failed: {rc}")
    return out
