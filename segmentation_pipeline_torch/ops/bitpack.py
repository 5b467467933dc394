"""Bit-packed label-id transfer, ported from segmentation_pipeline_tpu/ops/bitpack.py.

Hard segmentations need ceil(log2(C)) bits per voxel, but a uint8 fetch
ships 8. Packing on the device before the device-to-host copy cuts the
transfer 8x for binary masks, 4x for up to 4 classes and 2x for up to 16.
The bit fields are little-endian within each byte, as in the JAX package, so
the packed bytes are the same. Round trips are bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bits_for", "pack_ids", "unpack_ids", "fetch_ids"]


def bits_for(n_classes: int) -> int:
    """Bits per voxel needed for class ids 0..n_classes-1 (1, 2, 4 or 8)."""
    if n_classes <= 2:
        return 1
    if n_classes <= 4:
        return 2
    if n_classes <= 16:
        return 4
    return 8


def pack_ids(ids: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Pack integer class ids into a flat uint8 tensor on ids' device.

    ids: any-shape integer tensor with values in [0, n_classes). Returns
    ceil(ids.numel() * bits / 8) bytes, voxel j of a byte in bits
    [bits * j, bits * (j + 1)). With n_classes > 16 this is a uint8 cast.
    """
    bits = bits_for(n_classes)
    flat = ids.to(torch.uint8).reshape(-1)
    if bits == 8:
        return flat
    per = 8 // bits
    pad = (-flat.numel()) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    g = flat.reshape(-1, per)
    out = g[:, 0].clone()
    for j in range(1, per):
        out |= g[:, j] << (bits * j)
    return out


def unpack_ids(packed: np.ndarray, n_classes: int, shape) -> np.ndarray:
    """Host-side inverse of pack_ids -> uint8 ids of the given shape."""
    packed = np.asarray(packed, dtype=np.uint8)
    bits = bits_for(n_classes)
    if bits == 8:
        return packed.reshape(shape)
    per = 8 // bits
    mask = np.uint8((1 << bits) - 1)
    cols = [(packed >> np.uint8(bits * j)) & mask for j in range(per)]
    flat = np.stack(cols, axis=1).reshape(-1)
    n = int(np.prod(shape))
    return flat[:n].reshape(shape)


def fetch_ids(ids_dev: torch.Tensor, n_classes: int) -> np.ndarray:
    """One packed device-to-host copy of label ids -> host uint8 ids of the
    same shape, equal to ``ids_dev.cpu().numpy()`` as uint8."""
    shape = tuple(ids_dev.shape)
    packed = pack_ids(ids_dev, n_classes).cpu().numpy()
    return unpack_ids(packed, n_classes, shape)
