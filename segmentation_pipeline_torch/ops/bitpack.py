"""Bit-packed label-id transfer, ported from segmentation_pipeline_tpu/ops/bitpack.py.

Hard segmentations need ceil(log2(C)) bits per voxel, but a uint8 fetch
ships 8. Packing on the device before the device-to-host copy cuts the
transfer 8x for binary masks, 4x for up to 4 classes and 2x for up to 16.
The bit fields are little-endian within each byte, as in the JAX package, so
the packed bytes are the same. Round trips are bit-exact.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["idx_dtype_for", "argmax_ids", "bits_for", "pack_ids", "unpack_ids",
           "start_fetch", "fetch_ids"]


def idx_dtype_for(n_channels: int) -> torch.dtype:
    """Smallest integer dtype holding channel indices (device-argmax fetch)."""
    return torch.uint8 if n_channels <= 255 else torch.int32


def argmax_ids(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The argmax over the channel axis ``dim`` as label ids of
    ``idx_dtype_for(C)``, on x's device."""
    return torch.argmax(x, dim=dim).to(idx_dtype_for(x.shape[dim]))


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


def start_fetch(t: torch.Tensor, n_classes: Optional[int] = None
                ) -> Callable[[], np.ndarray]:
    """Queue what precedes the host copy of ``t`` and return ``finish()``,
    which copies it and returns host numpy. With ``n_classes``, ``t`` holds
    label ids and goes bit-packed when the classes fit uint8, as a plain
    copy otherwise: the one fetch policy of every device-argmax path.

    On a CUDA tensor the copy runs on a side stream that waits for an event
    recorded here, so work queued on the device between this call and
    ``finish()`` (the next subject's window) does not delay it."""
    post = np.asarray
    if n_classes is not None and n_classes <= 255:
        shape = tuple(t.shape)
        t = pack_ids(t, n_classes)
        post = lambda host: unpack_ids(host, n_classes, shape)  # noqa: E731
    t = t.contiguous()
    if t.device.type != "cuda":
        return lambda: post(t.numpy())
    ready = torch.cuda.Event()
    ready.record()

    def finish():
        stream = torch.cuda.Stream(device=t.device)
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            host = t.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        t.record_stream(stream)
        done.synchronize()
        return post(host.numpy())

    return finish


def fetch_ids(ids_dev: torch.Tensor, n_classes: int) -> np.ndarray:
    """Label ids to the host now (``start_fetch``'s policy): host ids of the
    same shape, equal to ``ids_dev.cpu().numpy()``, uint8 when the classes
    fit it."""
    return start_fetch(ids_dev, n_classes)()
