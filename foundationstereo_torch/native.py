"""ctypes bindings for the native C++ data-path functions (``native/stereo_io.cpp``).

The port's copy of the JAX package's ``native.py``: the repo's shared
source, read and never edited, is built with ``g++`` on first use into
``foundationstereo_torch/_build/`` (the library's name carries the hash of
the source), and exposed through numpy-friendly wrappers. Every function
has a numpy or PIL fallback in the data pipeline
(``train/dataloader.py``), taken when the library cannot be built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "stereo_io.cpp"
_BUILD = Path(__file__).resolve().parent / "_build"
_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"stereo_io-{digest}.so"


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
                os.close(fd)
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-o", tmp, str(_SRC), "-lpthread"],
                    check=True, capture_output=True)
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.decode_disparity_u8.argtypes = [u8p, ctypes.c_int64, ctypes.c_double, f32p]
            lib.encode_disparity_u8.argtypes = [f32p, ctypes.c_int64, ctypes.c_double, u8p]
            lib.resize_bilinear_f32.argtypes = [f32p] + [ctypes.c_int] * 3 + [f32p] + [ctypes.c_int] * 2
            lib.resize_nearest_f32.argtypes = [f32p] + [ctypes.c_int] * 3 + [f32p] + [ctypes.c_int] * 2
            lib.warp_affine_reflect_f32.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                                    ctypes.c_int, ctypes.c_double,
                                                    ctypes.c_double, ctypes.c_double, f32p]
            lib.normalize_imagenet_u8.argtypes = [u8p, ctypes.c_int64, f32p]
            _lib = lib
        except Exception:  # noqa: BLE001 — toolchain unavailable -> fallback
            _build_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_disparity(disp_u8: np.ndarray, scale: float = 1000.0) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(disp_u8, dtype=np.uint8)
    h, w = src.shape[:2]
    out = np.empty((h, w), np.float32)
    lib.decode_disparity_u8(_u8(src), h * w, float(scale), _f32(out))
    return out


def encode_disparity(disp: np.ndarray, scale: float = 1000.0) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(disp, dtype=np.float32)
    h, w = src.shape[:2]
    out = np.empty((h, w, 3), np.uint8)
    lib.encode_disparity_u8(_f32(src), h * w, float(scale), _u8(out))
    return out


def resize_bilinear(img: np.ndarray, wh: tuple[int, int]) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(img, dtype=np.float32)
    if src.ndim == 2:
        src = src[..., None]
    sh, sw, c = src.shape
    w, h = wh
    out = np.empty((h, w, c), np.float32)
    lib.resize_bilinear_f32(_f32(src), sh, sw, c, _f32(out), h, w)
    return out[..., 0] if img.ndim == 2 else out


def resize_nearest(img: np.ndarray, wh: tuple[int, int]) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(img, dtype=np.float32)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    sh, sw, c = src.shape
    w, h = wh
    out = np.empty((h, w, c), np.float32)
    lib.resize_nearest_f32(_f32(src), sh, sw, c, _f32(out), h, w)
    return out[..., 0] if squeeze else out


def warp_affine_reflect(img: np.ndarray, tx: float, ty: float,
                        angle_deg: float) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(img, dtype=np.float32)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    h, w, c = src.shape
    out = np.empty_like(src)
    lib.warp_affine_reflect_f32(_f32(src), h, w, c, float(tx), float(ty),
                                float(angle_deg), _f32(out))
    return out[..., 0] if squeeze else out


def normalize_imagenet(img_u8: np.ndarray) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(img_u8, dtype=np.uint8)
    h, w, c = src.shape
    assert c == 3
    out = np.empty((h, w, 3), np.float32)
    lib.normalize_imagenet_u8(_u8(src), h * w, _f32(out))
    return out
