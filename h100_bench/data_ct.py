"""What the Swin UNETR cell feeds both sides, made from ``--seed``:
synthetic abdominal CT volumes as the BTCV recipe's transforms leave them
(1.5 x 1.5 x 2.0 mm, HU clipped to [-175, 250] and scaled to [0, 1]), and
random weights for every entry of the network's state dict, on the card.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

HU_RANGE = (-175.0, 250.0)
# (HU, semi-axes as shares of the body's, centre as shares of the grid): the
# organs a BTCV volume shows, roughly placed
ORGANS = ((60.0, (0.35, 0.30, 0.30), (0.35, 0.45, 0.50)),   # liver
          (45.0, (0.12, 0.10, 0.15), (0.70, 0.40, 0.55)),   # spleen
          (150.0, (0.08, 0.07, 0.12), (0.38, 0.62, 0.45)),  # right kidney
          (150.0, (0.08, 0.07, 0.12), (0.65, 0.62, 0.45)),  # left kidney
          (200.0, (0.03, 0.03, 0.45), (0.52, 0.58, 0.50)),  # aorta
          (30.0, (0.15, 0.06, 0.10), (0.55, 0.45, 0.35)),   # pancreas
          (-60.0, (0.20, 0.15, 0.20), (0.50, 0.30, 0.70)))  # fat and bowel gas


def ct_volume(rng: np.random.Generator, grid: Sequence[int],
              spacing: Sequence[float]) -> np.ndarray:
    """One abdominal CT (1, W, H, D) in [0, 1]: air outside an elliptic body
    (fat rim, soft tissue), organs of their own density with a random shift
    and size, a spine of bone behind them, 20 HU of noise; clipped to
    [-175, 250] HU and scaled to [0, 1] as ``ScaleIntensityRanged`` does."""
    W, H, D = grid
    axes = [(np.arange(n, dtype=np.float32) - (n - 1) / 2) / (n / 2) for n in grid]
    w, h, d = np.meshgrid(*axes, indexing="ij", sparse=True)
    body = (w / 0.92) ** 2 + (h / 0.80) ** 2
    hu = np.where(body <= 1.0, 40.0, -1000.0).astype(np.float32)
    hu[(body > 0.85) & (body <= 1.0)] = -90.0
    for density, semi, centre in ORGANS:
        jitter = rng.uniform(0.85, 1.15, 3)
        c = [2 * (ci + rng.uniform(-0.03, 0.03)) - 1 for ci in centre]
        r2 = sum(((a - ca) / (s * j)) ** 2 for a, ca, s, j in zip((w, h, d), c, semi, jitter))
        hu = np.where(r2 <= 1.0, np.float32(density), hu)
    spine = (w / 0.07) ** 2 + ((h - 0.55) / 0.09) ** 2 <= 1.0
    hu = np.where(spine, np.float32(700.0), hu)
    hu += rng.normal(0.0, 20.0, (W, H, D)).astype(np.float32)
    lo, hi = HU_RANGE
    return ((np.clip(hu, lo, hi) - lo) / (hi - lo)).astype(np.float32)[None]


def _law(name: str, shape, template: Dict[str, torch.Tensor]) -> tuple:
    """(law, a, b) of one state-dict entry of Swin UNETR: conv and linear
    weights and their biases U(-1/sqrt(fan_in), +) (torch's init; the
    transposed convs' fan-in is their input channels), LayerNorm scales
    U(0.8, 1.2) and shifts N(0, 0.1), the relative position bias tables
    N(0, 0.5), so that the learned bias moves the attention as a trained
    one's does."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "relative_position_bias_table":
        return "normal", 0.0, 0.5
    kernel = template.get(name[:-len("bias")] + "weight") if leaf == "bias" else None
    if leaf == "weight" and len(shape) >= 2 or kernel is not None and kernel.dim() >= 2:
        weight = template[name] if leaf == "weight" else kernel
        fan_in = weight.shape[0] if ".transp_conv." in name else int(np.prod(weight.shape[1:]))
        bound = 1.0 / float(np.sqrt(fan_in))
        return "uniform", -bound, bound
    if leaf == "weight":
        return "uniform", 0.8, 1.2
    return "normal", 0.0, 0.1


def swin_weights(template: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """Random float32 weights for every entry of ``template`` from ``seed``,
    on ``device``: one uniform and one normal draw from a ``torch.Generator``
    there, cut into the entries in name order."""
    names = sorted(template)
    laws = {n: _law(n, tuple(template[n].shape), template) for n in names}
    sizes = {"uniform": 0, "normal": 0}
    for name in names:
        sizes[laws[name][0]] += template[name].numel()
    g = torch.Generator(device=device).manual_seed(int(seed))
    pools = {"uniform": torch.rand(sizes["uniform"], generator=g, device=device),
             "normal": torch.randn(sizes["normal"], generator=g, device=device)}
    used = {"uniform": 0, "normal": 0}
    out = {}
    for name in names:
        law, a, b = laws[name]
        n = template[name].numel()
        v = pools[law][used[law]:used[law] + n]
        used[law] += n
        v = a + (b - a) * v if law == "uniform" else a + b * v
        out[name] = v.reshape(template[name].shape).contiguous()
    return out
