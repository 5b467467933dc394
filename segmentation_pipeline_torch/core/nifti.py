"""Minimal, dependency-free NIfTI-1 reader/writer.

A copy of segmentation_pipeline_tpu/core/nifti.py without its native C++
fast path: numpy only. Supports .nii and .nii.gz,
the standard scalar dtypes, scl_slope/scl_inter scaling, and sform/qform
affines. Data convention matches torchio: arrays are returned channel-first
(C, W, H, D); the NIfTI 4th dimension maps to C.
"""
from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

# NIfTI-1 datatype codes <-> numpy dtypes
_DTYPE_FROM_CODE = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODE_FROM_DTYPE = {np.dtype(v): k for k, v in _DTYPE_FROM_CODE.items()}

HEADER_SIZE = 348


def _quaternion_to_affine(b: float, c: float, d: float, qfac: float,
                          pixdim: np.ndarray, offsets: Tuple[float, float, float]) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    spacing = np.array([pixdim[0], pixdim[1], pixdim[2] * (qfac if qfac != 0 else 1.0)])
    affine = np.eye(4)
    affine[:3, :3] = R * spacing[None, :]
    affine[:3, 3] = offsets
    return affine


def _read_bytes(path) -> bytes:
    path = str(path)
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def read_nifti(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read a NIfTI-1 file. Returns (data, affine).

    data has shape (C, W, H, D) — channel-first like torchio — and affine is a
    float64 (4, 4) voxel->world matrix (RAS+ if the file says so).
    """
    raw = _read_bytes(path)
    if len(raw) < HEADER_SIZE:
        raise ValueError(f"{path}: file too small to be NIfTI-1")

    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    swap = sizeof_hdr != HEADER_SIZE
    endian = ">" if swap else "<"
    if swap and struct.unpack_from(">i", raw, 0)[0] != HEADER_SIZE:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")

    dim = np.array(struct.unpack_from(f"{endian}8h", raw, 40))
    datatype = struct.unpack_from(f"{endian}h", raw, 70)[0]
    pixdim = np.array(struct.unpack_from(f"{endian}8f", raw, 76))
    vox_offset = struct.unpack_from(f"{endian}f", raw, 108)[0]
    scl_slope = struct.unpack_from(f"{endian}f", raw, 112)[0]
    scl_inter = struct.unpack_from(f"{endian}f", raw, 116)[0]
    qform_code = struct.unpack_from(f"{endian}h", raw, 252)[0]
    sform_code = struct.unpack_from(f"{endian}h", raw, 254)[0]
    quatern = struct.unpack_from(f"{endian}3f", raw, 256)
    qoffset = struct.unpack_from(f"{endian}3f", raw, 268)
    srow_x = struct.unpack_from(f"{endian}4f", raw, 280)
    srow_y = struct.unpack_from(f"{endian}4f", raw, 296)
    srow_z = struct.unpack_from(f"{endian}4f", raw, 312)
    magic = raw[344:348]

    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    ndim = int(dim[0])
    shape = tuple(int(s) for s in dim[1 : 1 + ndim])
    if ndim < 3:
        shape = shape + (1,) * (3 - ndim)

    if datatype not in _DTYPE_FROM_CODE:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPE_FROM_CODE[datatype])
    if swap:
        dtype = dtype.newbyteorder(">")

    count = int(np.prod(shape))
    offset = int(vox_offset) if vox_offset >= HEADER_SIZE else HEADER_SIZE
    arr = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    arr = arr.reshape(shape, order="F")
    if swap:
        arr = arr.astype(arr.dtype.newbyteorder("="))

    # NIfTI-1 spec: scl_slope == 0 (or NaN) means IGNORE the scaling
    # fields entirely — applying a leftover scl_inter there would offset
    # every voxel (nibabel behavior matched)
    if (scl_slope != 0.0 and not np.isnan(scl_slope)
            and (scl_slope != 1.0 or scl_inter != 0.0)):
        arr = arr.astype(np.float32) * scl_slope + scl_inter

    # sform preferred, then qform, then pixdim-diagonal
    if sform_code > 0:
        affine = np.eye(4)
        affine[0] = srow_x
        affine[1] = srow_y
        affine[2] = srow_z
    elif qform_code > 0:
        qfac = pixdim[0] if pixdim[0] in (-1.0, 1.0) else 1.0
        affine = _quaternion_to_affine(*quatern, qfac, pixdim[1:4], qoffset)
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])

    # channel-first (C, W, H, D): 4th NIfTI dim -> channels
    if arr.ndim == 3:
        data = arr[None]
    elif arr.ndim == 4:
        data = np.transpose(arr, (3, 0, 1, 2))
    else:
        # collapse trailing dims into channels
        spatial = arr.shape[:3]
        data = arr.reshape(spatial + (-1,), order="F")
        data = np.transpose(data, (3, 0, 1, 2))

    return np.ascontiguousarray(data), affine.astype(np.float64)


def write_nifti(path, data: np.ndarray, affine: np.ndarray) -> None:
    """Write channel-first (C, W, H, D) data with a (4, 4) sform affine."""
    data = np.asarray(data)
    if data.ndim == 3:
        data = data[None]
    if data.ndim != 4:
        raise ValueError(f"expected (C, W, H, D) data, got shape {data.shape}")

    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _CODE_FROM_DTYPE:
        data = data.astype(np.float32)
    datatype = _CODE_FROM_DTYPE[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8

    C = data.shape[0]
    spatial = data.shape[1:]
    if C == 1:
        ndim, shape = 3, spatial
        arr = data[0]
    else:
        ndim, shape = 4, spatial + (C,)
        arr = np.transpose(data, (1, 2, 3, 0))

    affine = np.asarray(affine, dtype=np.float64)
    spacing = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    dim = [ndim] + list(shape) + [1] * (7 - len(shape))
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, bitpix)
    pixdim = [1.0] + list(spacing) + [1.0] * 4
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code = SCANNER_ANAT
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(arr).tobytes(order="F")
    path = str(path)
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
