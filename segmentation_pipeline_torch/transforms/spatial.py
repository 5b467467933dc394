"""Spatial transforms, ported from segmentation_pipeline_tpu/transforms/spatial.py:
``Crop``, ``Pad``, ``CropOrPad`` (with mask centring, and its exact inverse
``_UndoCropOrPad``), ``Flip``, ``resample_array``, ``Resample``, ``TargetResample``,
``CropToMask``, ``MinSizePad`` and ``EnforceConsistentAffine``. Every
transform keeps the affines, so world geometry, and with it the inversion
back to the original scanner grid, stays exact. Host-side numpy and
scipy.ndimage, as in the JAX package.
"""
from __future__ import annotations

import itertools
from statistics import mean, median
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage as ndi

from ..core.subject import LabelMap
from .base import SpatialTransform, Transform

TypeBounds = Tuple[int, int, int, int, int, int]  # w_ini, w_fin, h_ini, h_fin, d_ini, d_fin


def _parse_bounds(bounds) -> TypeBounds:
    if isinstance(bounds, int):
        return (bounds,) * 6
    bounds = tuple(int(b) for b in bounds)
    if len(bounds) == 3:
        return (bounds[0], bounds[0], bounds[1], bounds[1], bounds[2], bounds[2])
    if len(bounds) == 6:
        return bounds
    raise ValueError(f"Bounds must be an int, 3-tuple or 6-tuple, got {bounds}")


def _pad_value(data: np.ndarray, mode) -> float:
    if mode is None:
        return 0.0
    if isinstance(mode, (int, float)):
        return float(mode)
    if mode == "minimum":
        return float(data.min())
    if mode == "mean":
        return float(data.mean())
    if mode == "maximum":
        return float(data.max())
    if mode == "otsu":
        return float(_otsu_background_value(data))
    raise ValueError(f"Unsupported padding mode {mode!r}")


def _otsu_background_value(data: np.ndarray) -> float:
    """Mean of voxels below the Otsu threshold (torchio's 'otsu' pad value)."""
    x = np.asarray(data, dtype=np.float64).ravel()
    hist, edges = np.histogram(x, bins=256)
    centers = (edges[:-1] + edges[1:]) / 2
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    m0 = np.cumsum(hist * centers)
    mu0 = np.divide(m0, w0, out=np.zeros_like(m0), where=w0 > 0)
    mu1 = np.divide(m0[-1] - m0, w1, out=np.zeros_like(m0), where=w1 > 0)
    between = w0 * w1 * (mu0 - mu1) ** 2
    thresh = centers[int(np.argmax(between))]
    below = x[x < thresh]
    return below.mean() if below.size else x.min()


class Crop(SpatialTransform):
    """Crop by (w_ini, w_fin, h_ini, h_fin, d_ini, d_fin); inverse pads zeros."""

    def __init__(self, cropping, **kwargs):
        super().__init__(**kwargs)
        self.cropping = _parse_bounds(cropping)

    def apply_transform(self, subject):
        w0, w1, h0, h1, d0, d1 = self.cropping
        for image in self.get_images(subject):
            data = np.asarray(image.data)
            _, W, H, D = data.shape
            image.set_data(data[:, w0:W - w1 or None, h0:H - h1 or None, d0:D - d1 or None])
            affine = image.affine.copy()
            affine[:3, 3] = (affine @ np.array([w0, h0, d0, 1.0]))[:3]
            image.affine = affine
        return None

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        return Pad(self.cropping, **self._sel())


class Pad(SpatialTransform):
    """Pad by bounds with a padding mode; inverse crops."""

    def __init__(self, padding, padding_mode=0, **kwargs):
        super().__init__(**kwargs)
        self.padding = _parse_bounds(padding)
        self.padding_mode = padding_mode

    def apply_transform(self, subject):
        w0, w1, h0, h1, d0, d1 = self.padding
        for image in self.get_images(subject):
            data = np.asarray(image.data)
            if self.padding_mode == "edge":
                padded = np.pad(data, ((0, 0), (w0, w1), (h0, h1), (d0, d1)), mode="edge")
            else:
                value = _pad_value(data, self.padding_mode)
                if np.issubdtype(data.dtype, np.integer):
                    value = int(round(value))
                padded = np.pad(data, ((0, 0), (w0, w1), (h0, h1), (d0, d1)),
                                mode="constant", constant_values=value)
            image.set_data(padded)
            affine = image.affine.copy()
            affine[:3, 3] = (affine @ np.array([-w0, -h0, -d0, 1.0]))[:3]
            image.affine = affine
        return None

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        return Crop(self.padding, **self._sel())


class CropOrPad(SpatialTransform):
    """Crop and/or pad to a target shape, optionally centred on a mask's
    bounding box (tio.CropOrPad with mask_name). The applied crop and pad
    bounds are recorded per subject, so the inverse is exact for any input
    shape."""

    def __init__(self, target_shape, padding_mode=0, mask_name: Optional[str] = None, **kwargs):
        super().__init__(**kwargs)
        if isinstance(target_shape, int):
            target_shape = (target_shape,) * 3
        self.target_shape = tuple(int(s) for s in target_shape)
        self.padding_mode = padding_mode
        self.mask_name = mask_name

    def _center(self, subject, spatial_shape) -> Tuple[float, float, float]:
        if self.mask_name is not None and self.mask_name in subject:
            mask = np.asarray(subject[self.mask_name].data)[0] > 0
            if mask.any():
                coords = np.where(mask)
                return tuple((c.min() + c.max()) / 2 for c in coords)
        return tuple((s - 1) / 2 for s in spatial_shape)

    def apply_transform(self, subject):
        spatial_shape = subject.get_first_image().spatial_shape
        center = self._center(subject, spatial_shape)

        crop = [0] * 6
        pad = [0] * 6
        for axis in range(3):
            size = spatial_shape[axis]
            target = self.target_shape[axis]
            # the window [lo, hi) of length target centred on center
            lo = int(round(center[axis] - target / 2 + 0.5))
            hi = lo + target
            crop[2 * axis], crop[2 * axis + 1] = max(lo, 0), max(size - hi, 0)
            pad[2 * axis], pad[2 * axis + 1] = max(-lo, 0), max(hi - size, 0)

        if any(crop):
            Crop(tuple(crop), **self._selection_kwargs())(subject, record=False)
        if any(pad):
            Pad(tuple(pad), padding_mode=self.padding_mode, **self._selection_kwargs())(
                subject, record=False)
        return {"crop": tuple(crop), "pad": tuple(pad)}

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        args = args or {}
        return _UndoCropOrPad(args.get("crop", (0,) * 6), args.get("pad", (0,) * 6),
                              **self._sel())


class _UndoCropOrPad(SpatialTransform):
    def __init__(self, crop, pad, **kwargs):
        super().__init__(**kwargs)
        self.crop = crop
        self.pad = pad

    def apply_transform(self, subject):
        if any(self.pad):
            Crop(self.pad, **self._selection_kwargs())(subject, record=False)
        if any(self.crop):
            Pad(self.crop, **self._selection_kwargs())(subject, record=False)
        return None


class Flip(SpatialTransform):
    """Flip spatial axes, and the affine with them; self-inverse."""

    def __init__(self, axes, **kwargs):
        super().__init__(**kwargs)
        if isinstance(axes, int):
            axes = (axes,)
        self.axes = tuple(axes)

    def apply_transform(self, subject):
        for image in self.get_images(subject):
            data = np.asarray(image.data)
            for axis in self.axes:
                data = np.flip(data, axis=axis + 1)
            image.set_data(np.ascontiguousarray(data))
            affine = image.affine.copy()
            for axis in self.axes:
                size = image.data.shape[1 + axis]
                affine[:3, 3] = affine[:3, 3] + affine[:3, axis] * (size - 1)
                affine[:3, axis] = -affine[:3, axis]
            image.affine = affine
        return None

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        return Flip(self.axes, **self._sel())


def resample_array(
    data: np.ndarray,
    src_affine: np.ndarray,
    dst_affine: np.ndarray,
    dst_shape: Sequence[int],
    order: int,
    cval: float = 0.0,
) -> np.ndarray:
    """Resample (C, W, H, D) data from src grid to dst grid in world space."""
    M = np.linalg.inv(src_affine) @ dst_affine  # dst index -> src index
    out = np.empty((data.shape[0], *dst_shape), dtype=np.float32)
    matrix = M[:3, :3]
    offset = M[:3, 3]
    for c in range(data.shape[0]):
        out[c] = ndi.affine_transform(
            data[c].astype(np.float32), matrix, offset=offset,
            output_shape=tuple(dst_shape), order=order, mode="constant", cval=cval,
            prefilter=order > 1,
        )
    return out


_INTERP_ORDER = {"nearest": 0, "linear": 1, "bspline": 3, "cubic": 3}


class Resample(SpatialTransform):
    """Resample all images to a target spacing (tio.Resample semantics).

    target: float or 3-tuple spacing in mm, or the name of an image in the
    subject whose grid to match. Labels use nearest interpolation; scalars
    use ``image_interpolation``. ``scalars_only`` leaves label maps alone;
    ``pre_affine_name`` is kept as the JAX package keeps it (it moves
    nothing there either).
    """

    def __init__(self, target, image_interpolation: str = "linear",
                 pre_affine_name: Optional[str] = None, scalars_only: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.target = target
        self.image_interpolation = image_interpolation
        self.pre_affine_name = pre_affine_name
        self.scalars_only = scalars_only

    @staticmethod
    def parse_spacing(spacing):
        if isinstance(spacing, (int, float)):
            return (float(spacing),) * 3
        return tuple(float(s) for s in spacing)

    def _target_grid(self, subject, image):
        if isinstance(self.target, str) and self.target in subject:
            ref = subject[self.target]
            return ref.affine.copy(), ref.spatial_shape
        spacing = self.parse_spacing(self.target)
        affine = image.affine
        old_spacing = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
        directions = affine[:3, :3] / old_spacing[None, :]
        new_affine = affine.copy()
        new_affine[:3, :3] = directions * np.array(spacing)[None, :]
        old_shape = np.array(image.spatial_shape, dtype=np.float64)
        new_shape = np.ceil(old_shape * old_spacing / np.array(spacing) - 1e-6).astype(int)
        return new_affine, tuple(int(s) for s in new_shape)

    def apply_transform(self, subject):
        sources = {}
        for name, image in self.get_images_dict(subject).items():
            if self.scalars_only and isinstance(image, LabelMap):
                continue
            dst_affine, dst_shape = self._target_grid(subject, image)
            order = 0 if isinstance(image, LabelMap) else _INTERP_ORDER[self.image_interpolation]
            sources[name] = (image.affine.copy(), image.spatial_shape)
            data = resample_array(np.asarray(image.data), image.affine, dst_affine, dst_shape,
                                  order)
            if isinstance(image, LabelMap):
                data = np.rint(data).astype(np.int32)
            image.set_data(data)
            image.affine = dst_affine
        # recorded so that offline tools can resample back to the original grid
        return {"sources": sources}

    def is_invertible(self):
        return False


class TargetResample(Resample):
    """Resample to a target spacing only if outside tolerance, choosing a
    rational scale. ``target_spacing`` may also name a statistic of the
    first image's spacing ("mean", "median", "min", "max")."""

    SPACING_MODES = {"mean": mean, "median": median, "min": min, "max": max}

    def __init__(self, target_spacing, tolerance, image_interpolation: str = "linear",
                 pre_affine_name=None, scalars_only: bool = False, **kwargs):
        if isinstance(target_spacing, str) and target_spacing not in self.SPACING_MODES:
            raise ValueError(f"Spacing mode must be one of {tuple(self.SPACING_MODES)}")
        if not isinstance(target_spacing, str):
            target_spacing = Resample.parse_spacing(target_spacing)
        super().__init__(target=target_spacing, image_interpolation=image_interpolation,
                         pre_affine_name=pre_affine_name, scalars_only=scalars_only, **kwargs)
        self.target_spacing = target_spacing
        self.tolerance = Resample.parse_spacing(tolerance)

    @staticmethod
    def _snap_spacing(cur: float, tar: float, tol: float) -> float:
        """Smallest-denominator rational snap of the per-axis resample scale:
        walking denominators q = 1, 2, ..., round the scale ratio to the
        nearest q-th (upscaling snaps tar/cur to p/q; downscaling snaps
        cur/tar to p/q and uses its reciprocal) and accept the first spacing
        within tolerance of the target. Low-denominator rational scales keep
        resampled grid dimensions exact."""
        if abs(cur - tar) <= tol:
            return cur
        upscale = cur < tar
        ratio = (tar / cur) if upscale else (cur / tar)
        for q in itertools.count(1):
            snapped = round(ratio * q) / q
            spacing = cur * (snapped if upscale else 1.0 / snapped)
            if abs(spacing - tar) <= tol:
                return spacing

    def apply_transform(self, subject):
        current = subject.get_first_image().spacing
        if isinstance(self.target_spacing, str):
            t = self.SPACING_MODES[self.target_spacing](current)
            target = (t, t, t)
        else:
            target = self.target_spacing

        if all(abs(c - t) < tol for c, t, tol in zip(current, target, self.tolerance)):
            return None

        new_spacing = [self._snap_spacing(cur, tar, tol)
                       for cur, tar, tol in zip(current, target, self.tolerance)]

        resample = Resample(target=tuple(new_spacing),
                            image_interpolation=self.image_interpolation,
                            pre_affine_name=self.pre_affine_name,
                            scalars_only=self.scalars_only)
        return resample.apply_transform(subject)


class CropToMask(SpatialTransform):
    """Crop to the bounding box of a label mask."""

    def __init__(self, label_map_name: str, label_id: int = 1, label_channel: int = 0,
                 **kwargs):
        super().__init__(**kwargs)
        self.label_map_name = label_map_name
        self.label_id = label_id
        self.label_channel = label_channel

    def apply_transform(self, subject):
        if self.label_map_name not in subject:
            return None
        mask = np.asarray(subject[self.label_map_name].data)[self.label_channel] == self.label_id
        W, H, D = mask.shape
        if not mask.any():
            raise RuntimeError(
                f"CropToMask: mask '{self.label_map_name}' has no voxels with "
                f"label_id={self.label_id}; cannot crop")
        ws, hs, ds = np.where(mask)
        cropping = (
            int(ws.min()), int(W - ws.max() - 1),
            int(hs.min()), int(H - hs.max() - 1),
            int(ds.min()), int(D - ds.max() - 1),
        )
        Crop(cropping)(subject, record=False)
        return {"cropping": cropping}

    def is_invertible(self):
        return False


class MinSizePad(Transform):
    """Symmetric pad up to a minimum shape; its inverse crops the padding
    back off."""

    def __init__(self, min_size, padding_mode=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(min_size, int):
            self.min_size = (min_size,) * 3
        elif isinstance(min_size, tuple):
            self.min_size = min_size
        else:
            raise KeyError("min_size must be an int or tuple")
        self.padding_mode = padding_mode

    def apply_transform(self, subject):
        _, W, H, D = subject.get_first_image().shape
        padding = []
        for size, target in zip((W, H, D), self.min_size):
            if size < target:
                diff = target - size
                half = diff // 2
                padding += [half, half + (diff % 2)]
            else:
                padding += [0, 0]
        padding = tuple(padding)
        if any(padding):
            Pad(padding, padding_mode=self.padding_mode,
                **self._sel())(subject, record=False)
        return {"padding": padding}

    def is_invertible(self):
        return True

    def inverse(self, args=None):
        padding = (args or {}).get("padding", (0,) * 6)
        return Crop(padding, **self._sel())


class EnforceConsistentAffine(Transform):
    """Copy a source image's affine to all images."""

    def __init__(self, source_image_name: str = None, **kwargs):
        super().__init__(**kwargs)
        self.source_image_name = source_image_name

    def apply_transform(self, subject):
        if self.source_image_name is not None and self.source_image_name not in subject:
            return None
        if self.source_image_name is not None:
            source = subject[self.source_image_name]
        else:
            source = subject.get_first_image()
        for name, image in self.get_images_dict(subject).items():
            if name == self.source_image_name:
                continue
            image.affine = source.affine.copy()
        return None


class CopyAffine(Transform):
    """Copy the named image's affine to all images (SubjectFolder's
    ``ref_img``)."""

    def __init__(self, target: str, **kwargs):
        super().__init__(**kwargs)
        self.target = target

    def apply_transform(self, subject):
        if self.target not in subject:
            return None
        source = subject[self.target]
        # honor include/exclude: CopyAffine(target, exclude=['mask']) must
        # leave 'mask' untouched
        for name, image in self.get_images_dict(subject).items():
            if name == self.target:
                continue
            image.affine = source.affine.copy()
        return None
