"""ctypes bindings for the native asset library (port of
funky_tpu/utils/native.py:1-101).

On first use this builds the repository's native/ sources (fr_native.cpp:
PNG and the sRGB table, fr_jpeg.cpp: baseline JPEG) with native/Makefile
into funky_tpu_torch/build/native/, under a file lock so that concurrent
processes build once. Where g++, make or zlib is missing every entry
point returns None and the numpy decoders serve, as in the JAX package.
A host asset path: nothing here touches a device.
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
_SO = _BUILD_DIR / "build" / "libfr_native.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> None:
    """make with native/Makefile in the build directory. OUT is absolute:
    VPATH would otherwise find native/build's library as the target."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _SO.exists():
            subprocess.run(["make", "-C", str(_BUILD_DIR), "-f",
                            str(_NATIVE_DIR / "Makefile"),
                            f"VPATH={_NATIVE_DIR}", f"OUT={_SO}"],
                           check=True, capture_output=True, timeout=120)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    int_p = ctypes.POINTER(ctypes.c_int)
    for name in ("fr_png_info", "fr_jpeg_info"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, int_p, int_p]
        fn.restype = ctypes.c_int
    for name in ("fr_png_decode_rgba", "fr_jpeg_decode_rgba"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.fr_srgb_lut.argtypes = [ctypes.c_void_p]
    lib.fr_srgb_lut.restype = None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not _SO.exists():
            _build()
        _lib = _bind(ctypes.CDLL(str(_SO)))
    except (OSError, subprocess.SubprocessError, AttributeError):
        # no make, g++ or zlib, a failed build, or a library that does not
        # load: the numpy decoders serve
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _decode(info, decode, data: bytes) -> Optional[np.ndarray]:
    w, h = ctypes.c_int(), ctypes.c_int()
    if info(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value, 4), np.uint8)
    if decode(data, len(data), out.ctypes.data_as(ctypes.c_void_p)) != 0:
        return None
    return out


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> (H, W, 4) uint8 RGBA, or None if unsupported."""
    lib = _load()
    if lib is None:
        return None
    return _decode(lib.fr_png_info, lib.fr_png_decode_rgba, data)


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> (H, W, 4) uint8 RGBA, or None if unsupported."""
    lib = _load()
    if lib is None:
        return None
    return _decode(lib.fr_jpeg_info, lib.fr_jpeg_decode_rgba, data)


def srgb_lut() -> Optional[np.ndarray]:
    """The 256-entry sRGB -> linear table (f32), or None."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(256, np.float32)
    lib.fr_srgb_lut(out.ctypes.data_as(ctypes.c_void_p))
    return out
