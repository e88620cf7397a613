"""Native (C++) runtime components: threaded prefetching frame loader.

Build-on-first-use: g++ compiles pngio.cpp + loader.cpp into
_native.so next to this file (rebuilt when sources are newer; the
file is git-ignored).  The odometry driver uses the native loader when
it builds; io/png.py (zlib + numpy) is the fallback, so the framework
works without a toolchain.  `build_error()` says why a build failed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "_native.so")
_SOURCES = [os.path.join(_DIR, f) for f in ("pngio.cpp", "loader.cpp")]
_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build():
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        *_SOURCES, "-lz", "-pthread", "-o", _SO,
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            stale = not os.path.exists(_SO) or any(
                os.path.getmtime(s) > os.path.getmtime(_SO) for s in _SOURCES
            )
            if stale:
                _build()
            lib = ctypes.CDLL(_SO)
            lib.png_probe.restype = ctypes.c_int
            lib.png_probe.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            lib.png_decode.restype = ctypes.c_int
            lib.png_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ]
            lib.loader_create.restype = ctypes.c_void_p
            lib.loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.loader_next.restype = ctypes.c_int
            lib.loader_next.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.loader_destroy.restype = None
            lib.loader_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception as e:  # toolchain missing / build failed
            _build_error = str(e)
        return _lib


def build_error():
    """None once the library loaded, else why it could not."""
    get_lib()
    return _build_error


def decode_png(path):
    """Decode a PNG via the native decoder -> ndarray (u8 [H,W,C] or
    u16 [H,W]).  Raises on failure."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    data = open(path, "rb").read()
    w = ctypes.c_int()
    h = ctypes.c_int()
    ch = ctypes.c_int()
    depth = ctypes.c_int()
    rc = lib.png_probe(data, len(data), ctypes.byref(w), ctypes.byref(h),
                       ctypes.byref(ch), ctypes.byref(depth))
    if rc != 0:
        raise ValueError(f"png_probe({path}) failed: {rc}")
    shape = (h.value, w.value, ch.value) if ch.value > 1 else (h.value, w.value)
    out = np.empty(shape, np.uint8 if depth.value == 8 else np.uint16)
    rc = lib.png_decode(data, len(data), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"png_decode({path}) failed: {rc}")
    return out


class PrefetchLoader:
    """Iterate decoded (rgb [H,W,3] u8, depth [H,W] u16) frame pairs,
    decoded ahead of time by native worker threads."""

    def __init__(self, rgb_paths, depth_paths, width, height,
                 depth_width=None, depth_height=None, workers=2, ahead=8):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        if len(rgb_paths) != len(depth_paths):
            raise ValueError("path list length mismatch")
        self._lib = lib
        self._n = len(rgb_paths)
        self._w, self._h = width, height
        self._dw = depth_width or width
        self._dh = depth_height or height
        self._rgb_arr = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in rgb_paths]
        )
        self._dep_arr = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in depth_paths]
        )
        self._handle = lib.loader_create(
            self._rgb_arr, self._dep_arr, self._n,
            width, height, self._dw, self._dh, workers, ahead,
        )
        if not self._handle:
            raise RuntimeError("loader_create failed")

    def __len__(self):
        return self._n

    def next(self):
        """Returns (index, rgb, depth); raises StopIteration at end."""
        rgb = np.empty((self._h, self._w, 3), np.uint8)
        dep = np.empty((self._dh, self._dw), np.uint16)
        rc = self._lib.loader_next(
            self._handle,
            rgb.ctypes.data_as(ctypes.c_void_p),
            dep.ctypes.data_as(ctypes.c_void_p),
        )
        if rc == -1:
            raise StopIteration
        if rc < 0:
            raise IOError(f"native loader error {rc}")
        return rc, rgb, dep

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return self.next()
        except StopIteration:
            raise
