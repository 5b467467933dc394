"""The yardstick's peaks and the operations and bytes of the port's hand
kernels, from their shapes alone.

Peaks are one NVIDIA H100 SXM's published dense rates: 989 TFLOP/s in
bfloat16 and 495 TFLOP/s in TF32 (the tensor-core rate a float32 conv can
reach, whatever an implementation spends to keep float32 accuracy), and
3.35 TB/s of HBM. A kernel's bound is the larger of its operations over
the peak and its bytes over the bandwidth, each input byte read once and
each output byte written once.
"""
from __future__ import annotations

from typing import Dict, Tuple

PEAK_FLOPS = {"torch.float32": 495e12, "torch.bfloat16": 989e12}
PEAK_BYTES = 3.35e12
ITEM_BYTES = {"torch.float32": 4, "torch.bfloat16": 2}

# a launch key of ops/conv3x3.py's counters: (dtype, N, W, H, D, c_in, c_out)
Key = Tuple[str, int, int, int, int, int, int]


def conv3x3_flops(key: Key) -> float:
    """2 per multiply-add of a 3^3 stride-1 conv from c_in to c_out
    channels at every voxel (forward, input gradient and weight gradient
    alike)."""
    _, n, w, h, d, cin, cout = key
    return 2.0 * n * w * h * d * cin * cout * 27


def conv3x3_bytes(kind: str, key: Key) -> float:
    """forward: x in, the kernel in, y out; dX (keyed by the cotangent's
    channels first): g in, the kernel in, dx out; dW: x and g in, the
    kernel's gradient out."""
    dtype, n, w, h, d, cin, cout = key
    voxels = n * w * h * d
    elements = voxels * cin + voxels * cout + 27 * cin * cout
    return float(elements * ITEM_BYTES[dtype])


def conv3x3_bound_s(kind: str, key: Key) -> float:
    return max(conv3x3_flops(key) / PEAK_FLOPS[key[0]],
               conv3x3_bytes(kind, key) / PEAK_BYTES)


def bound_and_flops(counts: Dict[str, Dict[Key, int]], kinds=("fwd", "dx", "dw")):
    """Summed bound seconds and FLOPs of the counted launches of ``kinds``."""
    bound = flops = 0.0
    for kind in kinds:
        for key, n in counts[kind].items():
            bound += n * conv3x3_bound_s(kind, key)
            flops += n * conv3x3_flops(key)
    return bound, flops
