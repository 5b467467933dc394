"""ctypes bindings of the port's native labeller (csrc/ccl.cpp), the
counterpart of segmentation_pipeline_tpu/native/__init__.py without its
NIfTI reader.

The library (with its ``component_counts`` entry, typed but unwrapped as
in the JAX package) is built by g++ at first use into build/torch_kernels/
(ops/build.py::load_host). A failed build raises with the compiler's log;
nothing falls back to another implementation.

- ``connected_components_native``: foreground components of a 3-D mask at
  connectivity 1, 2 or 3 (6/18/26 neighbours), numbered 1..N by first
  occurrence in C order, the labels of scipy.ndimage.label.
- ``grey_dilation_native``: grey dilation with the 6-neighbour cross and
  its centre.
- ``confusion_joint_hist_native``: the (L+1) x (L+1) joint histogram of
  two label maps through a value LUT.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np

from .ops import build

SOURCE = "ccl.cpp"
_LOCK = threading.Lock()
_LIB = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def library() -> ctypes.CDLL:
    """The labeller's library, built and typed on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = build.load_host(SOURCE)
            lib.label_components.restype = ctypes.c_int32
            lib.label_components.argtypes = [ctypes.POINTER(ctypes.c_uint8), _I32P,
                                             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                             ctypes.c_int]
            lib.grey_dilate_cross.restype = None
            lib.grey_dilate_cross.argtypes = [_I32P, _I32P, ctypes.c_int64, ctypes.c_int64,
                                              ctypes.c_int64]
            lib.component_counts.restype = None
            lib.component_counts.argtypes = [_I32P, ctypes.c_int64, _I64P, ctypes.c_int32]
            lib.confusion_joint_hist.restype = None
            lib.confusion_joint_hist.argtypes = [_I32P, _I32P, ctypes.c_int64, _I32P,
                                                 ctypes.c_int64, ctypes.c_int32, _I64P]
            _LIB = lib
        return _LIB


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def connected_components_native(mask: np.ndarray, connectivity: int = 3
                                ) -> Tuple[np.ndarray, int]:
    """(labels int32, number of components) of the foreground (mask > 0) of
    a (W, H, D) volume."""
    if connectivity not in (1, 2, 3):
        raise ValueError(f"connectivity must be 1, 2 or 3; got {connectivity}")
    img = np.ascontiguousarray(np.asarray(mask) > 0, dtype=np.uint8)
    out = np.empty(img.shape, dtype=np.int32)
    W, H, D = img.shape
    num = library().label_components(_ptr(img, ctypes.c_uint8), _ptr(out, ctypes.c_int32),
                                     W, H, D, connectivity)
    return out, int(num)


def grey_dilation_native(img: np.ndarray) -> np.ndarray:
    """Grey dilation of a (W, H, D) integer volume with the cross footprint,
    computed in int32 and returned in img's dtype."""
    src = np.ascontiguousarray(img, dtype=np.int32)
    out = np.empty_like(src)
    W, H, D = src.shape
    library().grey_dilate_cross(_ptr(src, ctypes.c_int32), _ptr(out, ctypes.c_int32), W, H, D)
    return out.astype(np.asarray(img).dtype)


def confusion_joint_hist_native(target: np.ndarray, pred: np.ndarray, lut: np.ndarray,
                                L: int) -> np.ndarray:
    """(L+1) x (L+1) int64 counts of (target bucket, prediction bucket):
    ``lut`` maps a value to its bucket; values outside [0, len(lut)) go to
    bucket L. Both maps are read as int32."""
    t = np.ascontiguousarray(np.asarray(target).reshape(-1), dtype=np.int32)
    p = np.ascontiguousarray(np.asarray(pred).reshape(-1), dtype=np.int32)
    if t.size != p.size:
        raise ValueError(f"target and prediction differ in size: {t.size} and {p.size}")
    lut = np.ascontiguousarray(lut, dtype=np.int32)
    counts = np.zeros((L + 1) * (L + 1), dtype=np.int64)
    library().confusion_joint_hist(_ptr(t, ctypes.c_int32), _ptr(p, ctypes.c_int32),
                                   ctypes.c_int64(t.size), _ptr(lut, ctypes.c_int32),
                                   ctypes.c_int64(lut.size), ctypes.c_int32(L),
                                   _ptr(counts, ctypes.c_int64))
    return counts.reshape(L + 1, L + 1)
