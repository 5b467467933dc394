"""ctypes bindings of the port's native host code, the counterpart of
segmentation_pipeline_tpu/native/__init__.py: the labeller (csrc/ccl.cpp)
and the NIfTI reader (csrc/nifti_io.cpp, linked with zlib).

Each library (the labeller's with its ``component_counts`` entry, typed but
unwrapped as in the JAX package) is built by g++ at first use into
build/torch_kernels/ (ops/build.py::load_host). A failed build raises with
the compiler's log; nothing falls back to another implementation.

- ``connected_components_native``: foreground components of a 3-D mask at
  connectivity 1, 2 or 3 (6/18/26 neighbours), numbered 1..N by first
  occurrence in C order, the labels of scipy.ndimage.label.
- ``grey_dilation_native``: grey dilation with the 6-neighbour cross and
  its centre.
- ``confusion_joint_hist_native``: the (L+1) x (L+1) joint histogram of
  two label maps through a value LUT.
- ``nifti_read_raw_native``: a NIfTI-1 file's header bytes and raw voxel
  payload, inflated and copied in C with the GIL released, or None for a
  file the reader refuses (core/nifti.py then reads it with numpy).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from .ops import build

SOURCE = "ccl.cpp"
NIFTI_SOURCE = "nifti_io.cpp"
_LOCK = threading.Lock()
_LIB = None
_NIFTI_LIB = None

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


def nifti_library() -> ctypes.CDLL:
    """The NIfTI reader's library, built and typed on first call."""
    global _NIFTI_LIB
    with _LOCK:
        if _NIFTI_LIB is None:
            lib = build.load_host(NIFTI_SOURCE, libs=("-lz",))
            lib.nifti_read_header.restype = ctypes.c_int
            lib.nifti_read_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                                              ctypes.POINTER(ctypes.c_uint8)]
            lib.nifti_read_payload.restype = ctypes.c_int64
            lib.nifti_read_payload.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                                               ctypes.c_int64]
            _NIFTI_LIB = lib
        return _NIFTI_LIB


def nifti_read_raw_native(path) -> Optional[Tuple[bytes, np.ndarray]]:
    """(the first 352 bytes of the header, the raw voxel payload as uint8)
    of the NIfTI-1 file ``path``; None when the reader refuses the file (it
    cannot be opened, it is not a little-endian NIfTI-1 file, or its
    payload is short), which core/nifti.py then reads with numpy."""
    lib = nifti_library()
    encoded = str(path).encode()
    header = np.zeros(16, dtype=np.float64)
    raw352 = np.zeros(352, dtype=np.uint8)
    if lib.nifti_read_header(encoded, _ptr(header, ctypes.c_double),
                             _ptr(raw352, ctypes.c_uint8)) != 0:
        return None
    ndim = int(header[0])
    count = 1
    for d in header[1:1 + max(ndim, 3)]:
        count *= max(int(d), 1)
    n_bytes = count * (int(header[9]) // 8)
    payload = np.empty(n_bytes, dtype=np.uint8)
    if lib.nifti_read_payload(encoded, _ptr(payload, ctypes.c_uint8), n_bytes) != n_bytes:
        return None
    return raw352.tobytes(), payload
