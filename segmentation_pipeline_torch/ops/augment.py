"""Batched device augmentation of channels-last training batches.

Ported from segmentation_pipeline_tpu/ops/augment.py: the stochastic
transforms of the two training configurations (permute, flip, affine,
elastic, bias field, gamma, blur, noise and the interleaved rescales) as
PyTorch ops over (N, W, H, D, C) batches on the batch's device. Labels ride
along with nearest-neighbour warps, as uint8 class ids (N, W, H, D) or as
one-hot channels.

The draws are apart from the arithmetic. ``draw_augmentation`` makes every
random number of a batch from one ``torch.Generator``, slot by slot in the
JAX package's key-slot order; ``apply_augmentation`` is deterministic given
the draws; ``augment_batch`` is the two in turn. A gated op runs only on the
samples whose gate is on (an index subset, written back), so a skipped
sample keeps its input exactly, as JAX's per-sample ``lax.cond`` does; the
gates cross to the host once per batch to pick the subsets. The pipeline
computes in float32 and returns the input dtype.

The warps gather all eight corner taps through one flat index, with JAX's
corner and blend order and edge clamp (no ``grid_sample``, whose coordinate
normalization and nearest rounding differ at ties and edges); nearest
rounds half to even, as ``jnp.rint``.
"""
from __future__ import annotations

from functools import lru_cache
from itertools import permutations
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..transforms.random_spatial import ElasticDeformation, _as_range
from ..utils.timer import span

_F32 = torch.float32


# ---------------------------------------------------------------------------
# sampling helpers
# ---------------------------------------------------------------------------

def _sample(volumes: torch.Tensor, coords: torch.Tensor, nearest: bool = False,
            gather_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Batched ``trilinear_sample``: volumes (n, W, H, D, C) at coords
    (n, 3, w, h, d) -> (n, w, h, d, C). ``gather_dtype`` rounds the image
    taps to that dtype before the float32 blend."""
    n, W, H, D, C = volumes.shape
    src = volumes if gather_dtype is None else volumes.to(gather_dtype)
    flat = src.reshape(n * W * H * D, C)
    offset = (torch.arange(n, device=volumes.device) * (W * H * D)).view(n, 1, 1, 1)
    cw = coords[:, 0].clamp(0, W - 1)
    ch = coords[:, 1].clamp(0, H - 1)
    cd = coords[:, 2].clamp(0, D - 1)

    def base(a, b, c):
        return (a * H + b) * D + c + offset

    if nearest:
        iw, ih, id_ = (torch.round(c).long() for c in (cw, ch, cd))
        return flat[base(iw, ih, id_)]

    w0, h0, d0 = (torch.floor(c) for c in (cw, ch, cd))
    fw = (cw - w0)[..., None]
    fh = (ch - h0)[..., None]
    fd = (cd - d0)[..., None]
    w0, h0, d0 = w0.long(), h0.long(), d0.long()
    w1 = (w0 + 1).clamp(max=W - 1)
    h1 = (h0 + 1).clamp(max=H - 1)
    d1 = (d0 + 1).clamp(max=D - 1)
    idx = torch.stack([base(w0, h0, d0), base(w1, h0, d0), base(w0, h1, d0),
                       base(w0, h0, d1), base(w1, h1, d0), base(w1, h0, d1),
                       base(w0, h1, d1), base(w1, h1, d1)])
    g = flat[idx]  # (8, n, w, h, d, C): one gather
    return (g[0] * (1 - fw) * (1 - fh) * (1 - fd)
            + g[1] * fw * (1 - fh) * (1 - fd)
            + g[2] * (1 - fw) * fh * (1 - fd)
            + g[3] * (1 - fw) * (1 - fh) * fd
            + g[4] * fw * fh * (1 - fd)
            + g[5] * fw * (1 - fh) * fd
            + g[6] * (1 - fw) * fh * fd
            + g[7] * fw * fh * fd)


def trilinear_sample(volume: torch.Tensor, coords: torch.Tensor,
                     nearest: bool = False) -> torch.Tensor:
    """Sample (W, H, D, C) at fractional coords (3, w, h, d) with edge clamp;
    ``nearest=True`` for label volumes."""
    return _sample(volume[None], coords[None], nearest)[0]


def _identity_coords(spatial: Tuple[int, int, int], device) -> torch.Tensor:
    grids = torch.meshgrid(*[torch.arange(s, dtype=_F32, device=device) for s in spatial],
                           indexing="ij")
    return torch.stack(grids)  # (3, W, H, D)


# ---------------------------------------------------------------------------
# the ops, each batched over the samples it is given
# ---------------------------------------------------------------------------

_SPATIAL_PERMS = tuple(permutations((0, 1, 2)))  # identity first


def draw_affine_matrix(generator: torch.Generator, n: int, scales=0.2,
                       degrees=45.0) -> torch.Tensor:
    """(n, 3, 3) random rotation and scale matrices A = Rx Ry Rz diag(scale)
    (tio.RandomAffine): scale U(1-s, 1+s), angles U(-d, d) per axis;
    ``scales``/``degrees`` accept (lo, hi)."""
    scale = _uniform(generator, (n, 3), *_as_range(scales, center=1.0))
    angles = torch.deg2rad(_uniform(generator, (n, 3), *_as_range(degrees)))
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[:, 0]), torch.zeros_like(c[:, 0])
    rx = torch.stack([one, zero, zero, zero, c[:, 0], -s[:, 0],
                      zero, s[:, 0], c[:, 0]], 1).view(-1, 3, 3)
    ry = torch.stack([c[:, 1], zero, s[:, 1], zero, one, zero,
                      -s[:, 1], zero, c[:, 1]], 1).view(-1, 3, 3)
    rz = torch.stack([c[:, 2], -s[:, 2], zero, s[:, 2], c[:, 2], zero,
                      zero, zero, one], 1).view(-1, 3, 3)
    return rx @ ry @ rz @ torch.diag_embed(scale)


def _label_background(y: torch.Tensor) -> torch.Tensor:
    """Fill for out-of-bounds label voxels: 0 for a single channel (ids or
    a mask), class 0 for one-hot labels."""
    fill = torch.zeros(y.shape[-1], dtype=y.dtype, device=y.device)
    if y.shape[-1] > 1:
        fill[0] = 1
    return fill


def _affine_pad_vector(xx: torch.Tensor, pad_value):
    """Out-of-bounds fill per sample and channel of (n, W, H, D, C): a float
    pads with that constant; 'minimum', 'mean', and 'otsu' (the mean below
    the channel mean) per channel as (n, 1, 1, 1, C)."""
    if not isinstance(pad_value, str):
        return pad_value
    flat = xx.reshape(xx.shape[0], -1, xx.shape[-1]).float()
    if pad_value == "minimum":
        out = flat.amin(dim=1)
    elif pad_value == "mean":
        out = flat.mean(dim=1)
    elif pad_value == "otsu":
        m = flat.mean(dim=1)
        mask = flat < m[:, None, :]
        cnt = mask.sum(dim=1).clamp_min(1)
        out = (flat * mask).sum(dim=1) / cnt
    else:
        raise ValueError(f"Unsupported affine pad mode {pad_value!r}: use a "
                         f"float or 'minimum'/'mean'/'otsu'")
    return out.to(xx.dtype).view(xx.shape[0], 1, 1, 1, -1)


def _affine_coords_oob(A: torch.Tensor, spatial: Tuple[int, int, int]):
    """Warp coords (n, 3, W, H, D) and out-of-bounds mask (n, W, H, D) of
    the matrices A (n, 3, 3) about the volume centre, in float32."""
    W, H, D = spatial
    A = A.to(_F32)
    center = [(s - 1) / 2 for s in spatial]
    t = [center[i] - (A[:, i, 0] * center[0] + A[:, i, 1] * center[1]
                      + A[:, i, 2] * center[2]) for i in range(3)]
    dev = A.device
    aw = torch.arange(W, dtype=_F32, device=dev).view(1, W, 1, 1)
    ah = torch.arange(H, dtype=_F32, device=dev).view(1, 1, H, 1)
    ad = torch.arange(D, dtype=_F32, device=dev).view(1, 1, 1, D)
    v = lambda a: a.view(-1, 1, 1, 1)  # noqa: E731
    cs = [v(A[:, i, 0]) * aw + v(A[:, i, 1]) * ah + v(A[:, i, 2]) * ad + v(t[i])
          for i in range(3)]
    oob = ((cs[0] < 0) | (cs[0] > W - 1) | (cs[1] < 0) | (cs[1] > H - 1)
           | (cs[2] < 0) | (cs[2] > D - 1))
    return torch.stack(cs, 1), oob


def _affine_warp(A, x, y, pad_value=0.0, gather_dtype=None):
    """Affine warp of (n, W, H, D, C) images (and labels, nearest) by A
    (n, 3, 3); out-of-bounds voxels take the pad and the label background."""
    coords, oob = _affine_coords_oob(A, x.shape[1:4])
    pv = _affine_pad_vector(x, pad_value)
    x_out = torch.where(oob[..., None], pv,
                        _sample(x, coords, gather_dtype=gather_dtype)).to(x.dtype)
    if y is None:
        return x_out, None
    y_out = torch.where(oob[..., None], _label_background(y), _sample(y, coords, True))
    return x_out, y_out


@lru_cache(maxsize=64)
def _bspline_basis(n_cp: int, size: int, device: torch.device) -> torch.Tensor:
    """(size, n_cp) cubic-B-spline interpolation matrix, the operator the
    host ElasticDeformation contracts with, on ``device``."""
    return torch.from_numpy(ElasticDeformation._bspline_matrix(n_cp, size)).to(device)


def elastic_dense_field(grid: torch.Tensor, spatial: Tuple[int, int, int]) -> torch.Tensor:
    """Upsample control grids (..., 3, cw, ch, cd) to dense fields
    (..., 3, W, H, D) by separable cubic-B-spline contraction. Each axis
    sums its control points in order with elementwise ops (no BLAS), so the
    field, and the nearest-neighbour label warp it drives, is the same bits
    on the card and on the CPU."""
    out = grid
    for axis, size in zip((-3, -2, -1), spatial):
        M = _bspline_basis(int(out.shape[axis]), int(size), grid.device)  # (size, n_cp)
        shape = [1] * out.dim()
        shape[axis] = int(size)
        acc = None
        for i in range(M.shape[1]):
            term = out.narrow(axis, i, 1) * M[:, i].view(shape)
            acc = term if acc is None else acc + term
        out = acc
    return out


def _elastic_grid(u: torch.Tensor, max_displacement, locked_borders: int) -> torch.Tensor:
    """Control grids from U(-1, 1) draws (n, 3, cw, ch, cd): scaled per axis
    by ``max_displacement`` (voxels), outer ``locked_borders`` planes zero."""
    md = torch.as_tensor(max_displacement, dtype=_F32, device=u.device).reshape(-1)
    grid = u * md.expand(3).view(1, 3, 1, 1, 1)
    if locked_borders:
        lb = locked_borders
        mask = torch.zeros(u.shape[2:], dtype=torch.bool, device=u.device)
        mask[lb:-lb, lb:-lb, lb:-lb] = True
        grid = grid * mask
    return grid


def _elastic_warp(grid, x, y):
    spatial = x.shape[1:4]
    coords = _identity_coords(spatial, x.device) + elastic_dense_field(grid, spatial)
    x_out = _sample(x, coords)
    return x_out, (_sample(y, coords, True) if y is not None else None)


def _bias_terms(order: int):
    return [(i, j, k) for i in range(order + 1) for j in range(order + 1 - i)
            for k in range(order + 1 - i - j)]


def bias_field(coefficients: torch.Tensor, spatial: Tuple[int, int, int],
               order: int = 3) -> torch.Tensor:
    """Log bias fields (n, W, H, D) of the polynomial coefficients
    (n, n_terms) over [-1, 1]^3."""
    dev = coefficients.device
    xs = torch.linspace(-1, 1, spatial[0], device=dev).view(1, -1, 1, 1)
    ys = torch.linspace(-1, 1, spatial[1], device=dev).view(1, 1, -1, 1)
    zs = torch.linspace(-1, 1, spatial[2], device=dev).view(1, 1, 1, -1)
    field = torch.zeros((coefficients.shape[0], *spatial), dtype=_F32, device=dev)
    for idx, (i, j, k) in enumerate(_bias_terms(order)):
        field = field + coefficients[:, idx].view(-1, 1, 1, 1) * (xs ** i) * (ys ** j) * (zs ** k)
    return field


def apply_gamma(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """sign(x) |x| ** gamma of (n, W, H, D, C) with one gamma per sample."""
    return torch.sign(x) * x.abs() ** gamma.view(-1, 1, 1, 1, 1)


def _symmetric_index(size: int, radius: int, device) -> torch.Tensor:
    """Indices of numpy's 'symmetric' (edge-repeating) padding by
    ``radius`` on both sides, for any radius: period 2 * size."""
    i = torch.arange(-radius, size + radius, device=device) % (2 * size)
    return torch.where(i < size, i, 2 * size - 1 - i)


def gaussian_blur(x: torch.Tensor, sigmas_vox: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable Gaussian blur of (n, W, H, D, C) with per-sample, per-axis,
    per-channel sigmas (n, 3, C) in voxels: scipy.ndimage.gaussian_filter
    (truncate 4, mode 'reflect': the edge voxel repeats), kernel support
    floor(4 sigma + 0.5) within the ``radius`` taps; sigma 0 is the
    identity."""
    offs = torch.arange(-radius, radius + 1, dtype=_F32, device=x.device).view(1, -1, 1)
    n, C = x.shape[0], x.shape[-1]
    for axis in range(3):
        sigma = sigmas_vox[:, axis].to(_F32)  # (n, C)
        sig = sigma.clamp_min(1e-6)
        support = torch.floor(4.0 * sigma + 0.5)
        w = torch.exp(-0.5 * (offs / sig[:, None, :]) ** 2)
        w = torch.where(offs.abs() <= support[:, None, :], w, 0.0)
        w = (w / w.sum(dim=1, keepdim=True)).to(x.dtype)  # (n, taps, C)
        size = x.shape[1 + axis]
        xp = x.index_select(1 + axis, _symmetric_index(size, radius, x.device))
        acc = None
        for t in range(2 * radius + 1):
            term = w[:, t].view(n, 1, 1, 1, C) * xp.narrow(1 + axis, t, size)
            acc = term if acc is None else acc + term
        x = acc
    return x


def _percentiles(flat: torch.Tensor, percentiles) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.percentile`` with linear interpolation over dim 1 of flat
    (n, V, C), in its float32 arithmetic; one sort, at any size (torch's
    quantile refuses inputs above 2**24 elements)."""
    a = torch.sort(flat, dim=1).values
    count = a.shape[1]
    q = torch.tensor(percentiles, dtype=_F32) / 100.0
    pos = q * torch.tensor(count - 1, dtype=_F32)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    out = []
    for i in range(len(percentiles)):
        lo_i = int(low[i].clamp(0, count - 1))
        hi_i = int(high[i].clamp(0, count - 1))
        out.append(a[:, lo_i] * lw[i].item() + a[:, hi_i] * hw[i].item())
    return out[0], out[1]


def rescale_intensity(x: torch.Tensor, out_min=-1.0, out_max=1.0,
                      percentiles=(0.0, 100.0), per_channel=True) -> torch.Tensor:
    """Percentile-clamped linear rescale of (n, W, H, D, C), per sample and,
    with ``per_channel``, per channel (tio.RescaleIntensity per image before
    ConcatenateImages); (0, 100) uses min/max."""
    n, C = x.shape[0], x.shape[-1]
    flat = x.reshape(n, -1, C) if per_channel and C > 1 else x.reshape(n, -1, 1)
    p_lo, p_hi = percentiles
    if p_lo <= 0.0 and p_hi >= 100.0:
        lo, hi = flat.amin(dim=1), flat.amax(dim=1)
    else:
        lo, hi = _percentiles(flat, percentiles)
    lo, hi = lo.view(n, 1, 1, 1, -1), hi.view(n, 1, 1, 1, -1)
    x = torch.minimum(torch.maximum(x, lo), hi)
    span = hi - lo
    scale = torch.where(span > 1e-12, (out_max - out_min) / span, 0.0)
    return (x - lo) * scale + out_min


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

DEFAULT_CONFIG = dict(
    # stage order mirrors the reference training pipelines: permute -> flip
    # -> affine/elastic -> bias -> mid rescale -> gamma -> pre-noise rescale
    # -> blur/noise -> final (model-io) rescale
    permute_p=0.0,
    flip_axes=(0, 1, 2), flip_p=0.5,
    # "independent": affine and elastic gate independently (affine_p /
    # elastic_p). "oneof": tio.OneOf({elastic, affine}, p=oneof_p): with
    # prob oneof_p apply exactly one of them, affine with prob
    # oneof_affine_weight.
    spatial_mode="independent",
    oneof_p=0.75, oneof_affine_weight=0.8,
    affine_p=0.6, affine_scales=0.2, affine_degrees=45.0,
    affine_batching="map", affine_pad=0.0,
    elastic_p=0.0, elastic_max_displacement=7.5,
    elastic_cp=(7, 7, 7), elastic_locked_borders=1,
    bias_p=0.5, bias_coefficients=0.5, bias_order=3,
    mid_rescale=(0.0, 1.0), mid_rescale_percentiles=(0.01, 99.9),
    gamma_p=0.8, log_gamma=(-0.3, 0.3),
    pre_noise_rescale=(-1.0, 1.0),
    blur_p=0.0, blur_std=(0.0, 1.0), blur_spacing=(1.0, 1.0, 1.0),
    # "blur_noise" | "noise_blur" | "random" (dmri's OneOf over the two
    # orders); msseg2 blurs then adds noise
    blur_noise_order="blur_noise",
    noise_p=0.35, noise_std=0.1,
    rescale=(-1.0, 1.0), rescale_percentiles=(0.5, 99.5),
    # "bfloat16" rounds the affine warp's image taps to bf16 before the
    # float32 blend; None = exact float32 taps
    warp_gather_dtype=None,
)

# What training/auto_augment.py derives from the two configurations'
# declared pipelines (up to blur_spacing and elastic_max_displacement, which
# depend on the dataset's spacing).
DMRI_REFERENCE_CONFIG = dict(
    flip_axes=(0, 1, 2), flip_p=0.5,
    affine_p=0.0,
    elastic_p=0.5, elastic_cp=(7, 7, 4), elastic_locked_borders=1,
    elastic_max_displacement=(7.5, 7.5, 7.5),
    bias_p=0.5, bias_coefficients=(-0.5, 0.5),
    mid_rescale=(0.0, 1.0), mid_rescale_percentiles=(0.01, 99.9),
    gamma_p=0.8, log_gamma=(-0.3, 0.3),
    pre_noise_rescale=(-1.0, 1.0),
    blur_p=0.2, blur_std=(0.0, 1.0), blur_noise_order="random",
    noise_p=0.3, noise_std=0.035,
    rescale=(-1.0, 1.0), rescale_percentiles=(0.5, 99.5),
)
MSSEG2_REFERENCE_CONFIG = dict(
    permute_p=1.0,
    flip_axes=(0, 1, 2), flip_p=0.5,
    spatial_mode="oneof", oneof_p=0.75, oneof_affine_weight=0.8,
    affine_scales=(0.8, 1.2), affine_degrees=(-45.0, 45.0), affine_pad="otsu",
    elastic_cp=(7, 7, 7), elastic_locked_borders=2,
    elastic_max_displacement=(7.5, 7.5, 7.5),
    bias_p=0.5, bias_coefficients=(-0.5, 0.5),
    mid_rescale=(0.0, 1.0), mid_rescale_percentiles=(0.01, 99.9),
    gamma_p=0.8, log_gamma=(-0.3, 0.3),
    pre_noise_rescale=(-1.0, 1.0),
    blur_p=0.2, blur_std=(0.0, 1.0), blur_noise_order="blur_noise",
    noise_p=0.35, noise_std=0.1,
    rescale=(-1.0, 1.0), rescale_percentiles=(0.05, 99.5),
)

def resolve_config(config: Optional[Dict] = None) -> Dict:
    """DEFAULT_CONFIG overridden by ``config``; unknown keys and values
    raise (a typo would silently weaken the augmentation)."""
    cfg = dict(DEFAULT_CONFIG)
    if config:
        unknown = set(config) - set(DEFAULT_CONFIG)
        if unknown:
            raise ValueError(
                f"Unknown augment_batch config keys {sorted(unknown)} — "
                f"a typo here would silently weaken the augmentation")
        cfg.update(config)
    if cfg["spatial_mode"] not in ("independent", "oneof"):
        raise ValueError(f"spatial_mode={cfg['spatial_mode']!r}: use "
                         f"'independent' or 'oneof'")
    if cfg["blur_noise_order"] not in ("blur_noise", "noise_blur", "random"):
        raise ValueError(f"blur_noise_order={cfg['blur_noise_order']!r}: use "
                         f"'blur_noise', 'noise_blur' or 'random'")
    if cfg["affine_batching"] not in ("map", "vmap"):
        raise ValueError(f"affine_batching={cfg['affine_batching']!r}: use 'map' or "
                         f"'vmap' (the same results)")
    if cfg["warp_gather_dtype"] not in (None, "float32", "f32", "bfloat16", "bf16"):
        raise ValueError(
            f"warp_gather_dtype={cfg['warp_gather_dtype']!r} not supported: use "
            f"'bfloat16' ('bf16') or None/'float32'")
    return cfg


def _spatial_possible(cfg: Dict) -> Tuple[bool, bool]:
    if cfg["spatial_mode"] == "oneof":
        w_aff = cfg["oneof_affine_weight"]
        return cfg["oneof_p"] > 0 and w_aff > 0, cfg["oneof_p"] > 0 and w_aff < 1
    return cfg["affine_p"] > 0, cfg["elastic_p"] > 0


def _uniform(generator, shape, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def draw_augmentation(generator: torch.Generator, n: int, spatial: Tuple[int, int, int],
                      channels: int, config: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """Every random number of a batch of ``n`` samples of ``spatial`` x
    ``channels``, on the generator's device: one draw per key slot of
    segmentation_pipeline_tpu/ops/augment.py:580-584, in its order, all
    slots always (a stage switched on never moves another's draws). Gate
    uniforms, flip uniforms (n, 3), affine matrices (n, 3, 3), U(-1, 1)
    control grids (n, 3, *elastic_cp), bias coefficients, gammas, noise
    sigmas (n,) and fields (n, *spatial, channels), blur stds in mm
    (n, 3, channels), the blur/noise order uniforms and permutation ids."""
    cfg = resolve_config(config)
    g = generator
    draws = {"flip": _uniform(g, (n, 3)), "affine_gate": _uniform(g, (n,))}
    draws["affine"] = draw_affine_matrix(g, n, cfg["affine_scales"], cfg["affine_degrees"])
    draws["elastic_gate"] = _uniform(g, (n,))
    draws["elastic"] = _uniform(g, (n, 3, *cfg["elastic_cp"]), -1.0, 1.0)
    draws["bias_gate"] = _uniform(g, (n,))
    draws["bias"] = _uniform(g, (n, len(_bias_terms(cfg["bias_order"]))),
                             *_as_range(cfg["bias_coefficients"]))
    draws["gamma_gate"] = _uniform(g, (n,))
    draws["gamma"] = torch.exp(_uniform(g, (n,), *cfg["log_gamma"]))
    draws["noise_gate"] = _uniform(g, (n,))
    std = cfg["noise_std"]
    s_lo, s_hi = (0.0, float(std)) if not isinstance(std, (tuple, list)) \
        else (float(std[0]), float(std[1]))
    draws["noise_sigma"] = _uniform(g, (n,), s_lo, s_hi)
    draws["noise"] = torch.randn((n, *spatial, channels), generator=g, device=g.device)
    draws["blur_gate"] = _uniform(g, (n,))
    b = cfg["blur_std"]
    b_lo, b_hi = _as_range(b) if isinstance(b, (tuple, list)) else (0.0, float(b))
    draws["blur"] = _uniform(g, (n, 3, channels), b_lo, b_hi)
    draws["order"] = _uniform(g, (n,))
    draws["permute_gate"] = _uniform(g, (n,))
    draws["permute"] = torch.randint(0, len(_SPATIAL_PERMS), (n,), generator=g, device=g.device)
    return draws


def _host_gates(draws: Dict[str, torch.Tensor], cfg: Dict) -> Dict[str, np.ndarray]:
    """Every per-sample decision of the batch, fetched to the host in one
    copy: the index subsets of the gated ops."""
    if cfg["spatial_mode"] == "oneof":
        applied = draws["affine_gate"] < cfg["oneof_p"]
        pick_affine = draws["elastic_gate"] < cfg["oneof_affine_weight"]
        do_affine, do_elastic = applied & pick_affine, applied & ~pick_affine
    else:
        do_affine = draws["affine_gate"] < cfg["affine_p"]
        do_elastic = draws["elastic_gate"] < cfg["elastic_p"]
    columns = {"affine": do_affine, "elastic": do_elastic,
               "bias": draws["bias_gate"] < cfg["bias_p"],
               "gamma": draws["gamma_gate"] < cfg["gamma_p"],
               "noise": draws["noise_gate"] < cfg["noise_p"],
               "blur": draws["blur_gate"] < cfg["blur_p"],
               "blur_first": draws["order"] < 0.5,
               "permute": draws["permute_gate"] < cfg["permute_p"]}
    flips = draws["flip"] < cfg["flip_p"]
    stacked = torch.cat([torch.stack(list(columns.values()), 1).long(), flips.long(),
                         draws["permute"].long()[:, None]], 1)
    with span("augment.read", wait=True):  # waits for the draws on the device
        stacked = stacked.cpu().numpy()
    out = {k: stacked[:, i].astype(bool) for i, k in enumerate(columns)}
    out["flip"] = stacked[:, len(columns):len(columns) + 3].astype(bool)
    out["permute_id"] = stacked[:, -1]
    return out


def _apply(x, y, mask: np.ndarray, fn):
    """Run ``fn`` on the samples of ``mask`` only and write the results
    back in place; the others keep their values exactly."""
    if not mask.any():
        return
    idx = torch.from_numpy(np.flatnonzero(mask)).to(x.device)
    x_new, y_new = fn(x[idx], None if y is None else y[idx])
    x[idx] = x_new
    if y is not None and y_new is not None:
        y[idx] = y_new


def apply_augmentation(X: torch.Tensor, y: Optional[torch.Tensor],
                       draws: Dict[str, torch.Tensor], config: Optional[Dict] = None):
    """The augmentation of a channels-last batch at the given draws
    (``draw_augmentation``'s, on X's device). X: (N, W, H, D, C) float; y:
    None, (N, W, H, D, C_label) one-hot or int channels, or (N, W, H, D)
    uint8 class ids; every label form warps nearest-neighbour. Returns
    (X', y') with X' in X's dtype and y' in y's form. Deterministic."""
    cfg = resolve_config(config)
    if cfg["permute_p"] > 0 and not (X.shape[1] == X.shape[2] == X.shape[3]):
        raise ValueError(
            f"permute_p > 0 needs cubic spatial dims, got {tuple(X.shape[1:4])} — permute "
            f"non-cubic volumes in the host pipeline (device patch augmentation is the "
            f"cubic case)")
    in_dtype = X.dtype
    X = X.to(_F32, copy=True)
    ids_in = y is not None and y.dim() == 4
    if y is not None:
        y = (y[..., None] if ids_in else y).clone()
    gates = _host_gates(draws, cfg)
    affine_possible, elastic_possible = _spatial_possible(cfg)
    keep = lambda fn: lambda x, yy: (fn(x), yy)  # noqa: E731  (image-only ops)

    if cfg["permute_p"] > 0:
        for k, perm in enumerate(_SPATIAL_PERMS[1:], start=1):
            dims = (0, *(1 + a for a in perm), 4)
            _apply(X, y, gates["permute"] & (gates["permute_id"] == k),
                   lambda x, yy, d=dims: (x.permute(d).contiguous(),
                                          None if yy is None else yy.permute(d).contiguous()))
    for axis in cfg["flip_axes"]:
        _apply(X, y, gates["flip"][:, axis],
               lambda x, yy, a=1 + axis: (x.flip(a), None if yy is None else yy.flip(a)))

    if affine_possible:
        gd = torch.bfloat16 if cfg["warp_gather_dtype"] in ("bfloat16", "bf16") else None
        idx = torch.from_numpy(np.flatnonzero(gates["affine"])).to(X.device)
        A = draws["affine"][idx]
        _apply(X, y, gates["affine"],
               lambda x, yy: _affine_warp(A, x, yy, cfg["affine_pad"], gd))
    if elastic_possible:
        idx = torch.from_numpy(np.flatnonzero(gates["elastic"])).to(X.device)
        grid = _elastic_grid(draws["elastic"][idx], cfg["elastic_max_displacement"],
                             cfg["elastic_locked_borders"])
        _apply(X, y, gates["elastic"], lambda x, yy: _elastic_warp(grid, x, yy))

    def subset(name, mask):
        return draws[name][torch.from_numpy(np.flatnonzero(mask)).to(X.device)]

    if cfg["bias_p"] > 0:
        coeffs = subset("bias", gates["bias"])
        _apply(X, y, gates["bias"], keep(lambda x: x * torch.exp(
            bias_field(coeffs, x.shape[1:4], cfg["bias_order"]))[..., None]))
    if cfg["mid_rescale"] is not None:
        X = rescale_intensity(X, *cfg["mid_rescale"], cfg["mid_rescale_percentiles"])
    if cfg["gamma_p"] > 0:
        gamma = subset("gamma", gates["gamma"])
        _apply(X, y, gates["gamma"], keep(lambda x: apply_gamma(x, gamma)))
    if cfg["pre_noise_rescale"] is not None:
        X = rescale_intensity(X, *cfg["pre_noise_rescale"])

    spacing = torch.tensor(cfg["blur_spacing"], dtype=_F32, device=X.device).view(1, 3, 1)
    b_std = cfg["blur_std"]
    b_hi = _as_range(b_std)[1] if isinstance(b_std, (tuple, list)) else float(b_std)
    radius = max(1, int(4.0 * b_hi / float(min(cfg["blur_spacing"])) + 0.5))

    def noise(mask):
        if cfg["noise_p"] <= 0:
            return
        mask = mask & gates["noise"]
        sigma, field = subset("noise_sigma", mask), subset("noise", mask)
        _apply(X, y, mask, keep(lambda x: x + sigma.view(-1, 1, 1, 1, 1) * field))

    def blur(mask):
        if cfg["blur_p"] <= 0:
            return
        mask = mask & gates["blur"]
        sigmas = subset("blur", mask) / spacing
        _apply(X, y, mask, keep(lambda x: gaussian_blur(x, sigmas, radius)))

    everyone = np.ones(X.shape[0], dtype=bool)
    order = cfg["blur_noise_order"]
    if cfg["blur_p"] <= 0 or order == "blur_noise":
        blur(everyone)
        noise(everyone)
    elif order == "noise_blur":
        noise(everyone)
        blur(everyone)
    else:  # "random": per sample, a fair coin picks the order
        first = gates["blur_first"]
        blur(first)
        noise(first)
        noise(~first)
        blur(~first)

    if cfg["rescale"] is not None:
        X = rescale_intensity(X, *cfg["rescale"], cfg["rescale_percentiles"])
    if y is not None and ids_in:
        y = y[..., 0]
    return X.to(in_dtype), y


def augment_batch(generator: torch.Generator, X: torch.Tensor,
                  y: Optional[torch.Tensor] = None, config: Optional[Dict] = None,
                  shard=None):
    """Augment a channels-last batch: ``draw_augmentation`` from
    ``generator`` (on X's device), then ``apply_augmentation``. ``config``
    overrides DEFAULT_CONFIG; training/auto_augment.py derives it from a
    declared host pipeline. With a ``shard`` (parallel.mesh.BatchShard) X
    and y hold a rank's rows of a global batch: the draws of the whole
    global batch are made and the rows' draws applied, so the rows come out
    as the one-device batch's do."""
    cfg = resolve_config(config)
    n = X.shape[0] if shard is None else shard.n_global
    draws = draw_augmentation(generator, n, tuple(X.shape[1:4]), X.shape[-1], cfg)
    if shard is not None:
        draws = {k: v[shard.rows] for k, v in draws.items()}
    return apply_augmentation(X, y, draws, cfg)
