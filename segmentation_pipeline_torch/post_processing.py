"""Connected-component label cleanup applied after inference, ported from
segmentation_pipeline_tpu/post_processing.py: keep the N largest components
while iteratively dilating survivors into removed voxels (so no holes
appear), fill small holes with dilation-based label assignment, and remove
small components by inverting.

Host-side, on the port's native labeller (native.py, csrc/ccl.cpp), as the
JAX package runs on its own: component labelling with full 26-connectivity
(skimage.morphology.label's default), holes at connectivity 1, and grey
dilation with the cross footprint (skimage.morphology.dilation's default).
The labels are scipy.ndimage's, so the outputs are those of the JAX
package's functions; outputs are the contract.
"""
from __future__ import annotations

import numpy as np

from .native import connected_components_native, grey_dilation_native


def _label(img: np.ndarray) -> np.ndarray:
    """Foreground components numbered 1..K in raster order of their first
    voxel."""
    labels, _ = connected_components_native(img > 0, connectivity=3)
    return labels


def _dilate_labels(img: np.ndarray) -> np.ndarray:
    """Grey dilation with the cross footprint, computed in int32."""
    return grey_dilation_native(img)


def _remove_small_holes(mask: np.ndarray, hole_size: int) -> np.ndarray:
    """skimage.remove_small_holes semantics: fill background components of
    at most ``hole_size`` voxels (connectivity 1)."""
    labels, num = connected_components_native(~mask, connectivity=1)
    if num == 0:
        return mask.copy()
    counts = np.bincount(labels.ravel())
    small = counts <= hole_size
    small[0] = False
    return mask | small[labels]


def unsort_by_size(img: np.ndarray, sorted_labels: np.ndarray) -> np.ndarray:
    """Invert :func:`sort_by_size`. ``img`` must hold the dense rank indices
    ``0..len(sorted_labels)-1`` that ``sort_by_size`` produced."""
    if img.size and (int(img.min()) < 0
                     or int(img.max()) >= len(sorted_labels)):
        raise ValueError(
            f"unsort_by_size expects dense rank indices in "
            f"[0, {len(sorted_labels)}); got range "
            f"[{int(img.min())}, {int(img.max())}]")
    return sorted_labels[img]


def sort_by_size(img: np.ndarray, descending: bool = False):
    """Relabel so that label rank follows component size; equal sizes keep
    the order of their label values (stable sort)."""
    unique_labels, unique_counts = np.unique(img, return_counts=True)
    ids = np.argsort(unique_counts, kind="stable")
    if descending:
        ids = ids[::-1]
    unique_labels = unique_labels[ids]
    unique_counts = unique_counts[ids]
    # LUT from label value to rank through searchsorted over the sorted
    # unique values (one volume pass)
    order = np.argsort(unique_labels, kind="stable")
    positions = np.searchsorted(unique_labels[order], img)
    out = order.astype(img.dtype)[positions]
    return out, unique_labels, unique_counts


def keep_components(img: np.ndarray, num: int, max_dilations: int = 100):
    """Keep the ``num`` largest connected components; removed voxels are
    filled by iteratively dilating the survivors into them."""
    img = img.copy()
    num_components_removed = num_elements_removed = 0
    for i in range(max_dilations):
        img_comp = _label(img)
        img_comp_sorted, _, _ = sort_by_size(img_comp, descending=True)
        keep = img_comp_sorted <= num
        remove = ~keep
        if i == 0:
            num_elements_removed = int(remove.sum())
            num_components_removed = max(0, int(img_comp_sorted.max()) - num)
        if remove.sum() == 0:
            break
        sorted_img, sorted_labels, _ = sort_by_size(img)
        to_dilate = sorted_img * keep
        dilated = _dilate_labels(to_dilate)
        change = (dilated != to_dilate) & remove
        sorted_img[change] = dilated[change]
        img = unsort_by_size(sorted_img, sorted_labels)
    return img, num_components_removed, num_elements_removed


def remove_holes(img: np.ndarray, hole_size: int, max_dilations: int = 100):
    """Fill holes of at most ``hole_size`` voxels; hole voxels take labels
    from iterative dilation of the surrounding labels."""
    img = img.copy()
    total_holes = 0
    for i in range(max_dilations):
        mask = img > 0
        small_holes = ~mask & _remove_small_holes(mask, hole_size)
        num_holes = int(small_holes.sum())
        if i == 0:
            total_holes = num_holes
        if num_holes == 0:
            break
        img[small_holes] = _dilate_labels(img)[small_holes]
    return img, total_holes


def remove_small_components(img: np.ndarray, component_size: int, max_dilations: int = 100):
    """Remove foreground components smaller than ``component_size`` by
    treating them as holes of the inverted mask."""
    img = img.copy()
    inverted = (img == 0).astype(img.dtype)
    holes_removed, counts = remove_holes(inverted, component_size,
                                         max_dilations=max_dilations)
    img[holes_removed.astype(bool)] = 0
    return img, counts
