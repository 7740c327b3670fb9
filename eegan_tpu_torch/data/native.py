"""ctypes bindings for the native host image ops (``data/csrc/image_ops.cpp``).

The port's counterpart of ``eegan_tpu/data/native.py``. The shared library
is built on first use with ``g++ -O3 -fopenmp`` into
``build/eegan_tpu_torch/libimage_ops-<hash>.so`` at the repository root (the
hash covers the source and the flags, so an edited source rebuilds); the
source stays untouched. As in the JAX package, every consumer falls back to
the PIL path when the toolchain or the library is unavailable: that is the
reference's data semantics, and the native path gives the same pixels.
This is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "image_ops.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "eegan_tpu_torch"
_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libimage_ops-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """g++ into a temporary name, then an atomic rename (several processes
    may build at once)."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        print(f"native image ops unavailable ({e}); using the PIL path")
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.is_file() and not _build(path):
            return None
        lib = ctypes.CDLL(str(path))
        u8p, f32p, ip = (ctypes.POINTER(ctypes.c_uint8),
                         ctypes.POINTER(ctypes.c_float),
                         ctypes.POINTER(ctypes.c_int))
        c_int = ctypes.c_int
        lib.resize_bilinear_u8_f32.argtypes = [
            u8p, c_int, c_int, c_int, f32p, c_int, c_int]
        lib.batch_pyramid_varsize.argtypes = [
            ctypes.POINTER(u8p), ip, c_int, c_int, c_int, c_int, ip, ip,
            c_int, ctypes.POINTER(f32p)]
        lib.batch_pyramid_varsize_u8.argtypes = [
            ctypes.POINTER(u8p), ip, c_int, c_int, c_int, c_int, ip, ip,
            c_int, ctypes.POINTER(u8p)]
        for fn in (lib.resize_bilinear_u8_f32, lib.batch_pyramid_varsize,
                   lib.batch_pyramid_varsize_u8):
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def resize_bilinear(img: np.ndarray, out_hw) -> np.ndarray:
    """uint8 (H, W, C) -> float32 (h, w, C) in [0, 255], Pillow-style filter."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native image ops are not built")
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3:
        raise ValueError(f"expected (H, W, C) uint8, got {img.shape}")
    h, w, c = img.shape
    oh, ow = out_hw
    out = np.empty((oh, ow, c), np.float32)
    lib.resize_bilinear_u8_f32(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), oh, ow)
    return out


def batch_pyramid_varsize(images, crops: np.ndarray, target: int, base: int,
                          sizes: Sequence[int],
                          as_uint8: bool = False) -> List[np.ndarray]:
    """Batch augment over differently-sized decoded uint8 images.

    images: list of (H_i, W_i, C) uint8 arrays; crops: (B, 3) int32
    (y, x, flip) in the shorter-side=``target`` resized frame.
    Per image: resize shorter side to `target`, crop `base`², optional
    hflip, per-branch resize + normalise to [-1, 1] float32 — or, with
    ``as_uint8``, Pillow-rounded uint8 in [0, 255] (the step normalises on
    the device). OpenMP-parallel, one C call per batch.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native image ops are not built")
    b = len(images)
    c = images[0].shape[2]
    images = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    if any(im.ndim != 3 or im.shape[2] != c for im in images):
        raise ValueError("images must be (H, W, C) with one C")
    crops = np.ascontiguousarray(crops, dtype=np.int32)
    if crops.shape != (b, 3):
        raise ValueError(f"crops {crops.shape}, expected {(b, 3)}")
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * b)(
        *[im.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for im in images])
    dims = np.ascontiguousarray(
        [[im.shape[0], im.shape[1]] for im in images], dtype=np.int32)
    sizes_arr = np.ascontiguousarray(sizes, dtype=np.int32)
    out_dtype = np.uint8 if as_uint8 else np.float32
    ctype = ctypes.c_uint8 if as_uint8 else ctypes.c_float
    outs = [np.empty((b, s, s, c), out_dtype) for s in sizes]
    optrs = (ctypes.POINTER(ctype) * len(outs))(
        *[o.ctypes.data_as(ctypes.POINTER(ctype)) for o in outs])
    fn = lib.batch_pyramid_varsize_u8 if as_uint8 else lib.batch_pyramid_varsize
    fn(ptrs, dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), b, c,
       target, base, crops.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
       sizes_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(sizes),
       optrs)
    return outs
