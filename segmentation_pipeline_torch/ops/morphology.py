"""Device morphology: connected components, the label cleanups and binary
dilation, ported from segmentation_pipeline_tpu/ops/morphology.py.

Connected components run as min-label propagation: each sweep takes the
minimum label over the neighbourhood, hooks every improvement into the
union-find slot of the voxel's old root and chases pointers twice, so a
smaller id that reaches a converged region snaps the whole stale tree in the
next sweep (about 6 sweeps where plain propagation needs hundreds). The
labels are component-unique (the smallest flat voxel index + 1), not
compact. The neighbourhood is taken from shifted slices of the padded
volume. Each loop reads one convergence flag from the device per sweep and
nothing else; ``connected_components_device.sweeps`` counts the sweeps.

The cleanups (``remove_holes_device``, ``keep_components_device``,
``remove_small_components_device`` and their chain,
``apply_device_postprocess``) give exactly the host post_processing
functions' labels (tests/test_torch_morphology.py).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_INF = 2 ** 30


def _offsets(connectivity: int):
    """The neighbour offsets (dw, dh, dd) of the 6- (1), 18- (2) or 26- (3)
    neighbourhood."""
    return [(dw, dh, dd) for dw in (-1, 0, 1) for dh in (-1, 0, 1) for dd in (-1, 0, 1)
            if 0 < abs(dw) + abs(dh) + abs(dd) <= connectivity]


def _neighbour_reduce(values: torch.Tensor, connectivity: int, reduce, fill: int) -> torch.Tensor:
    """``reduce`` of each voxel with its neighbours, out of bounds ``fill``.
    values: (W, H, D) int32."""
    padded = F.pad(values, (1, 1, 1, 1, 1, 1), value=fill)
    W, H, D = values.shape
    best = values
    for dw, dh, dd in _offsets(connectivity):
        best = reduce(best, padded[1 + dw:1 + dw + W, 1 + dh:1 + dh + H, 1 + dd:1 + dd + D])
    return best


def _neighbour_min(labels: torch.Tensor, connectivity: int) -> torch.Tensor:
    return _neighbour_reduce(labels, connectivity, torch.minimum, _INF)


def _neighbour_max(values: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """Grey dilation including the centre (skimage's dilation footprint),
    out of bounds -inf."""
    return _neighbour_reduce(values, connectivity, torch.maximum, -_INF)


def connected_components_device(mask: torch.Tensor, connectivity: int = 3,
                                max_iterations: int = 256) -> torch.Tensor:
    """Label a (W, H, D) mask on its device: int32, 0 for background, the
    smallest flat voxel index + 1 of its component for foreground. Stops
    when a sweep changes no label, after at most ``max_iterations`` sweeps."""
    mask = mask > 0
    W, H, D = mask.shape
    n = W * H * D
    flat_ids = torch.arange(1, n + 1, dtype=torch.int32, device=mask.device).reshape(W, H, D)
    inf = torch.full((), _INF, dtype=torch.int32, device=mask.device)
    labels = torch.where(mask, flat_ids, inf)
    for _ in range(max_iterations):
        connected_components_device.sweeps += 1
        new = torch.where(mask, torch.minimum(labels, _neighbour_min(labels, connectivity)), inf)
        new_flat, old_flat = new.reshape(-1), labels.reshape(-1)
        # hooking: each voxel's improved label into its old root's slot;
        # masked voxels write INF into slot n-1, a no-op for min
        slot = torch.where(old_flat < _INF, (old_flat - 1).clamp(0, n - 1),
                           torch.full_like(old_flat, n - 1))
        flat = new_flat.clone().scatter_reduce_(0, slot.long(), new_flat, "amin")
        for _ in range(2):
            chased = torch.where(new < _INF, flat[(new - 1).clamp(0, n - 1).long()], inf)
            new = torch.minimum(new, chased)
            flat = torch.minimum(flat, new.reshape(-1))
        new = torch.where(mask, new, inf)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return torch.where(mask, labels, torch.zeros_like(labels))


connected_components_device.sweeps = 0


def compact_labels(device_labels) -> Tuple[np.ndarray, int]:
    """Renumber device labels to 1..N by first occurrence, on the host."""
    arr = device_labels.cpu().numpy() if torch.is_tensor(device_labels) \
        else np.asarray(device_labels)
    uniques, inverse = np.unique(arr, return_inverse=True)
    has_bg = uniques[0] == 0
    new_ids = np.arange(len(uniques), dtype=np.int32) + (0 if has_bg else 1)
    return new_ids[inverse].reshape(arr.shape), int(len(uniques) - (1 if has_bg else 0))


def _component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Voxels per component id of non-compact labels ((W*H*D + 1,) int64),
    background's slot 0 set to 0."""
    n = labels.numel()
    sizes = torch.bincount(labels.reshape(-1).clamp(0, n).long(), minlength=n + 1)
    sizes[0] = 0
    return sizes


def _bg_hole_mask(img: torch.Tensor, hole_size: int, cc_max_iterations: int) -> torch.Tensor:
    """skimage.remove_small_holes' holes: background components
    (connectivity 1) of at most ``hole_size`` voxels."""
    mask = img > 0
    bg_cc = connected_components_device(~mask, connectivity=1,
                                        max_iterations=cc_max_iterations)
    small = _component_sizes(bg_cc)[bg_cc.clamp(0, bg_cc.numel()).long()] <= hole_size
    return ~mask & small & (bg_cc > 0)


def remove_holes_device(img: torch.Tensor, hole_size: int, max_dilations: int = 100,
                        cc_max_iterations: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """post_processing.remove_holes on the device: fill the background
    components of at most ``hole_size`` voxels, hole voxels taking their
    labels from iterated grey dilation of the labels around them. img:
    (W, H, D) integer ids. Returns (filled int32, holes' voxels int64).

    The labelling runs once, outside the dilation loop: filling turns only
    hole voxels into foreground, so the large background components neither
    split nor merge and what remains of a hole still qualifies; the host's
    per-iteration hole set is ``holes0 & still background``."""
    img = img.to(torch.int32)
    holes0 = _bg_hole_mask(img, hole_size, cc_max_iterations)
    total = holes0.sum()
    for _ in range(max_dilations):
        remaining = holes0 & (img == 0)
        if not bool(remaining.any()):
            break
        img = torch.where(remaining, _neighbour_max(img, 1), img)
    return img, total


def _analyze(cur: torch.Tensor, num: int, cc_max_iterations: int):
    """The keep mask of keep_components over {background} and the
    26-connected foreground components: a voxel is kept when its
    component's size reaches the (num+1)-th largest. Also the number of
    components and background's size and the threshold."""
    cc = connected_components_device(cur > 0, connectivity=3, max_iterations=cc_max_iterations)
    sizes = _component_sizes(cc)
    n_fg = (sizes > 0).sum()
    bg_count = cur.numel() - sizes.sum()
    # background competes for a keep slot, as in the host's rank over the
    # labels including 0
    sizes[0] = bg_count
    n_comp = n_fg + (bg_count > 0).long()
    thr = torch.clamp(torch.topk(sizes, num + 1).values[-1], min=1)
    keep = sizes[cc.clamp(0, cc.numel()).long()] >= thr
    return keep, n_comp, bg_count, thr


def keep_components_device(img: torch.Tensor, num: int, num_classes: int = 256,
                           max_dilations: int = 100, cc_max_iterations: int = 256):
    """post_processing.keep_components on the device: keep the ``num + 1``
    largest of {background} and the 26-connected components of img > 0, and
    fill the removed voxels by grey-dilating the size ranks of the
    survivors into them. img: (W, H, D) ids below ``num_classes``. Returns
    (img int32, components removed, voxels removed).

    Components tied at the threshold size are all kept (the host keeps the
    later-labelled ones up to ``num + 1`` ranks). When background holds a
    keep slot the host's loop comes to ``where(remove, 0, img)`` in one
    pass: a removed component touches no survivor, so the only label its
    voxels can take is background's. Otherwise the survivors dilate
    outward, sweep by sweep, as on the host."""
    img = img.to(torch.int32)
    keep0, n_comp0, bg_count0, thr0 = _analyze(img, num, cc_max_iterations)
    remove0 = ~keep0
    comp_removed = torch.clamp(n_comp0 - 1 - num, min=0)
    elems_removed = remove0.sum()
    if bool(bg_count0 >= thr0):
        return torch.where(remove0, torch.zeros_like(img), img), comp_removed, elems_removed
    cur = img
    arange = torch.arange(num_classes, device=img.device)
    for _ in range(max_dilations):
        keep, _, _, _ = _analyze(cur, num, cc_max_iterations)
        remove = ~keep
        done = bool(remove.sum() == 0)
        # the host's size ranks: (count, value) ascending, background
        # included; removed voxels enter the dilation at rank 0
        counts = torch.bincount(cur.reshape(-1).clamp(0, num_classes - 1).long(),
                                minlength=num_classes)
        order = torch.argsort(counts, stable=True)
        rank_of = torch.empty_like(order).scatter_(0, order, arange)
        ranks = rank_of[cur.long()]
        to_dilate = torch.where(remove, torch.zeros_like(ranks), ranks)
        dilated = _neighbour_max(to_dilate, 1)
        change = (dilated != to_dilate) & remove
        cur = order[torch.where(change, dilated, ranks)].to(torch.int32)
        if done:
            break
    return cur, comp_removed, elems_removed


def remove_small_components_device(img: torch.Tensor, component_size: int,
                                   max_dilations: int = 100, cc_max_iterations: int = 256):
    """post_processing.remove_small_components on the device: foreground
    components smaller than ``component_size`` are the holes of the
    inverted mask. Returns (img int32, removed voxels)."""
    img = img.to(torch.int32)
    holes_removed, counts = remove_holes_device((img == 0).to(torch.int32), component_size,
                                                max_dilations=max_dilations,
                                                cc_max_iterations=cc_max_iterations)
    return torch.where(holes_removed > 0, torch.zeros_like(img), img), counts


def apply_device_postprocess(ids: torch.Tensor, steps, num_classes: int) -> torch.Tensor:
    """An ordered [(op, arg), ...] cleanup chain on an argmax ids volume, on
    its device: 'remove_holes', 'keep_components',
    'remove_small_components'. Returns int32 ids."""
    for op, arg in steps:
        if op == "remove_holes":
            ids, _ = remove_holes_device(ids, int(arg))
        elif op == "keep_components":
            ids, _, _ = keep_components_device(ids, int(arg), num_classes=num_classes)
        elif op == "remove_small_components":
            ids, _ = remove_small_components_device(ids, int(arg))
        else:
            raise ValueError(f"Unknown device postprocess op {op!r}")
    return ids.to(torch.int32)


def binary_dilation_device(mask: torch.Tensor, connectivity: int = 1,
                           iterations: int = 1) -> torch.Tensor:
    """Binary dilation of a (W, H, D) mask with the 6/18/26 structuring
    element, ``iterations`` times."""
    out = mask > 0
    for _ in range(iterations):
        background = torch.where(out, 0, 1).to(torch.int32)
        out = out | ~_neighbour_min(background, connectivity).bool()
    return out
