"""The dmri_hippo training augmentation (``main_config.py``'s ``training``
pipeline: random flips, elastic deformation, bias field, rescale to [0, 1]
at the 0.01/99.9 percentiles, gamma, rescale to [-1, 1], blur and noise in
a random order, then the model-io rescale at 0.5/99.5) in plain PyTorch on
channels-last (N, W, H, D, C) batches with (N, W, H, D) class ids, as the
program's device augmentation computes it: trilinear image and nearest
label warps with an edge clamp (nearest rounds half to even), cubic
B-spline control grids, an order-3 polynomial log bias field over
[-1, 1]^3, percentiles by linear interpolation of the sorted voxels,
separable Gaussian blur (truncate 4 sigma, edges repeated).

``draw`` takes the random numbers of a batch from a ``torch.Generator`` in
the program's slot order (every slot always drawn, so the stream is the
same whichever stages are on); ``augment`` is deterministic given them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from scipy import ndimage

F32 = torch.float32
# the trilinear blend's corners in the order the taps are summed
CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1),
           (1, 1, 1))
BIAS_TERMS = [(i, j, k) for i in range(4) for j in range(4 - i) for k in range(4 - i - j)]


def config(spacing: Tuple[float, float, float]) -> Dict:
    """The published pipeline's parameters, the elastic displacement (7.5
    mm) and the blur's std (up to 1 mm) in voxels of ``spacing``."""
    return dict(flip_p=0.5, elastic_p=0.5, elastic_cp=(7, 7, 4), locked_borders=1,
                max_displacement=tuple(7.5 / s for s in spacing), bias_p=0.5,
                bias_range=(-0.5, 0.5), mid_percentiles=(0.01, 99.9), gamma_p=0.8,
                log_gamma=(-0.3, 0.3), blur_p=0.2, blur_std=(0.0, 1.0),
                spacing=tuple(spacing), noise_p=0.3, noise_std=0.035,
                final_percentiles=(0.5, 99.5))


def _uniform(g, shape, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo


def draw(g: torch.Generator, n: int, spatial, channels: int, cfg: Dict) -> Dict:
    d = {"flip": _uniform(g, (n, 3)), "affine_gate": _uniform(g, (n,))}
    _uniform(g, (n, 3))  # the affine slot's scales and angles (dmri has no affine)
    _uniform(g, (n, 3))
    d["elastic_gate"] = _uniform(g, (n,))
    d["elastic"] = _uniform(g, (n, 3, *cfg["elastic_cp"]), -1.0, 1.0)
    d["bias_gate"] = _uniform(g, (n,))
    d["bias"] = _uniform(g, (n, len(BIAS_TERMS)), *cfg["bias_range"])
    d["gamma_gate"] = _uniform(g, (n,))
    d["gamma"] = torch.exp(_uniform(g, (n,), *cfg["log_gamma"]))
    d["noise_gate"] = _uniform(g, (n,))
    d["noise_sigma"] = _uniform(g, (n,), 0.0, cfg["noise_std"])
    d["noise"] = torch.randn((n, *spatial, channels), generator=g, device=g.device)
    d["blur_gate"] = _uniform(g, (n,))
    d["blur"] = _uniform(g, (n, 3, channels), *cfg["blur_std"])
    d["order"] = _uniform(g, (n,))
    _uniform(g, (n,))  # the permutation slot (dmri permutes nothing)
    torch.randint(0, 6, (n,), generator=g, device=g.device)
    return d


def _sample(x: torch.Tensor, coords: torch.Tensor, nearest: bool) -> torch.Tensor:
    """x (W, H, D, C) at coords (3, W, H, D), edges clamped."""
    W, H, D, _ = x.shape
    c = [coords[0].clamp(0, W - 1), coords[1].clamp(0, H - 1), coords[2].clamp(0, D - 1)]
    if nearest:
        i = [torch.round(a).long() for a in c]
        return x[i[0], i[1], i[2]]
    lo = [torch.floor(a) for a in c]
    f = [(a - b)[..., None] for a, b in zip(c, lo)]
    lo = [b.long() for b in lo]
    hi = [(b + 1).clamp(max=s - 1) for b, s in zip(lo, (W, H, D))]
    out = None
    for bits in CORNERS:
        term = x[tuple(hi[a] if bits[a] else lo[a] for a in range(3))]
        for a in range(3):
            term = term * (f[a] if bits[a] else 1 - f[a])
        out = term if out is None else out + term
    return out


def _bspline_matrix(n_cp: int, size: int) -> torch.Tensor:
    """(size, n_cp): cubic B-spline interpolation (prefiltered, edges
    nearest) of each control point's unit vector at linspace(0, n_cp - 1,
    size)."""
    pos = np.linspace(0, n_cp - 1, size)[None]
    eye = np.eye(n_cp)
    return torch.from_numpy(np.stack(
        [ndimage.map_coordinates(eye[j], pos, order=3, mode="nearest") for j in range(n_cp)],
        axis=1).astype(np.float32))


def _elastic(x, y, u, cfg):
    W, H, D = x.shape[:3]
    grid = u * torch.tensor(cfg["max_displacement"], dtype=F32, device=u.device).view(3, 1, 1, 1)
    lb = cfg["locked_borders"]
    mask = torch.zeros(u.shape[1:], dtype=torch.bool, device=u.device)
    mask[lb:-lb, lb:-lb, lb:-lb] = True
    field = grid * mask
    for axis, size in zip((1, 2, 3), (W, H, D)):
        M = _bspline_matrix(field.shape[axis], size).to(u.device)
        shape = [1, 1, 1, 1]
        shape[axis] = size
        acc = None
        for i in range(M.shape[1]):
            term = field.narrow(axis, i, 1) * M[:, i].view(shape)
            acc = term if acc is None else acc + term
        field = acc
    ident = torch.stack(torch.meshgrid(*[torch.arange(s, dtype=F32, device=u.device)
                                         for s in (W, H, D)], indexing="ij"))
    coords = ident + field
    return _sample(x, coords, False), _sample(y[..., None], coords, True)[..., 0]


def _bias(x, coeffs):
    W, H, D = x.shape[:3]
    dev = x.device
    xs = torch.linspace(-1, 1, W, device=dev).view(-1, 1, 1)
    ys = torch.linspace(-1, 1, H, device=dev).view(1, -1, 1)
    zs = torch.linspace(-1, 1, D, device=dev).view(1, 1, -1)
    field = torch.zeros((W, H, D), dtype=F32, device=dev)
    for c, (i, j, k) in zip(coeffs, BIAS_TERMS):
        field = field + c * (xs ** i) * (ys ** j) * (zs ** k)
    return x * torch.exp(field)[..., None]


def _percentile_pair(flat: torch.Tensor, percentiles):
    """Linear interpolation of the sorted values (V, C) at two
    percentiles, positions in float32."""
    a = torch.sort(flat, dim=0).values
    count = a.shape[0]
    q = torch.tensor(percentiles, dtype=F32) / 100.0
    pos = q * torch.tensor(count - 1, dtype=F32)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    return [a[int(low[i].clamp(0, count - 1))] * lw[i].item()
            + a[int(high[i].clamp(0, count - 1))] * hw[i].item() for i in range(2)]


def _rescale(x, out_min, out_max, percentiles=None):
    flat = x.reshape(-1, x.shape[-1])
    if percentiles is None:
        lo, hi = flat.amin(0), flat.amax(0)
    else:
        lo, hi = _percentile_pair(flat, percentiles)
    x = torch.minimum(torch.maximum(x, lo), hi)
    span = hi - lo
    scale = torch.where(span > 1e-12, (out_max - out_min) / span, 0.0)
    return (x - lo) * scale + out_min


def _blur(x, sigmas_mm, cfg):
    radius = max(1, int(4.0 * cfg["blur_std"][1] / min(cfg["spacing"]) + 0.5))
    offs = torch.arange(-radius, radius + 1, dtype=F32, device=x.device).view(-1, 1)
    sigmas = sigmas_mm / torch.tensor(cfg["spacing"], dtype=F32, device=x.device).view(3, 1)
    for axis in range(3):
        sigma = sigmas[axis]  # (C,)
        w = torch.exp(-0.5 * (offs / sigma.clamp_min(1e-6)[None]) ** 2)
        w = torch.where(offs.abs() <= torch.floor(4.0 * sigma + 0.5)[None], w, 0.0)
        w = w / w.sum(0, keepdim=True)
        size = x.shape[axis]
        i = torch.arange(-radius, size + radius, device=x.device) % (2 * size)
        i = torch.where(i < size, i, 2 * size - 1 - i)
        xp = x.index_select(axis, i)
        acc = None
        for t in range(2 * radius + 1):
            term = w[t] * xp.narrow(axis, t, size)
            acc = term if acc is None else acc + term
        x = acc
    return x


def augment_one(x: torch.Tensor, y: torch.Tensor, d: Dict, k: int, cfg: Dict):
    """Sample ``k`` of the batch: x (W, H, D, C) float32, y (W, H, D) ids."""
    for axis in range(3):
        if d["flip"][k, axis] < cfg["flip_p"]:
            x, y = x.flip(axis), y.flip(axis)
    if d["elastic_gate"][k] < cfg["elastic_p"]:
        x, y = _elastic(x, y, d["elastic"][k], cfg)
    if d["bias_gate"][k] < cfg["bias_p"]:
        x = _bias(x, d["bias"][k])
    x = _rescale(x, 0.0, 1.0, cfg["mid_percentiles"])
    if d["gamma_gate"][k] < cfg["gamma_p"]:
        x = torch.sign(x) * x.abs() ** d["gamma"][k]
    x = _rescale(x, -1.0, 1.0)

    def noise(x):
        return x + d["noise_sigma"][k] * d["noise"][k] if d["noise_gate"][k] < cfg["noise_p"] \
            else x

    def blur(x):
        return _blur(x, d["blur"][k], cfg) if d["blur_gate"][k] < cfg["blur_p"] else x

    x = noise(blur(x)) if d["order"][k] < 0.5 else blur(noise(x))
    return _rescale(x, -1.0, 1.0, cfg["final_percentiles"]), y


def augment(g: torch.Generator, X: torch.Tensor, y: torch.Tensor, cfg: Dict):
    """The batch's draws from ``g``, then each sample augmented."""
    d = draw(g, X.shape[0], tuple(X.shape[1:4]), X.shape[-1], cfg)
    outs = [augment_one(X[k].float(), y[k], d, k, cfg) for k in range(X.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
