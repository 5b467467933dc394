"""Intensity transforms, ported from
segmentation_pipeline_tpu/transforms/intensity.py: the deterministic ones that
the dmri_hippo and msseg2 ``default`` pipelines apply (``ReplaceNan``,
``SetDataType``, ``RescaleIntensity``), ``ZNormalization`` and the random ones of msseg2's
``training`` pipeline (``RandomNoise``, ``RandomBlur``, ``RandomGamma``,
``RandomBiasField``), which draw from ``get_rng()``. Host-side numpy and
scipy.ndimage, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
from scipy import ndimage as ndi

from .base import IntensityTransform, RandomTransform, Transform


class ReplaceNan(Transform):
    """NaN -> constant on scalar images."""

    def __init__(self, replace_val: float = 0, **kwargs):
        super().__init__(**kwargs)
        self.replace_val = replace_val

    def apply_transform(self, subject):
        for image in self.get_images(subject, intensity_only=True):
            data = np.asarray(image.data)
            if np.issubdtype(data.dtype, np.floating):
                data = np.nan_to_num(data, nan=self.replace_val, copy=False)
            image.set_data(data)
        return None


class SetDataType(Transform):
    """Cast image data. Accepts numpy dtypes or the strings
    'float'/'float32'/'int32' etc."""

    def __init__(self, data_type, intensity_only: bool = True, **kwargs):
        super().__init__(**kwargs)
        if data_type in ("float", float):
            data_type = np.float32
        if data_type in ("int", int):
            data_type = np.int32
        self.data_type = np.dtype(data_type)
        self.intensity_only = intensity_only

    def apply_transform(self, subject):
        for image in self.get_images(subject, intensity_only=self.intensity_only):
            image.set_data(np.asarray(image.data).astype(self.data_type))
        return None


class RescaleIntensity(IntensityTransform):
    """Percentile-clamped linear rescale to an output range
    (tio.RescaleIntensity semantics: cutoffs from percentiles over the whole
    image, then an affine map to out_min_max)."""

    def __init__(self, out_min_max: Tuple[float, float] = (0.0, 1.0),
                 percentiles: Tuple[float, float] = (0.0, 100.0), **kwargs):
        super().__init__(**kwargs)
        self.out_min_max = tuple(out_min_max)
        self.percentiles = tuple(percentiles)

    @staticmethod
    def _percentiles(flat: np.ndarray, p_lo: float, p_hi: float):
        """Both percentiles from one multi-kth np.partition pass in the
        array's own dtype, with np.percentile's linear interpolation."""
        n = flat.size
        vals = []
        kths, plan = [], []
        for p in (p_lo, p_hi):
            pos = (n - 1) * (p / 100.0)
            lo_k = int(np.floor(pos))
            hi_k = min(int(np.ceil(pos)), n - 1)
            plan.append((lo_k, hi_k, pos - lo_k))
            kths += [lo_k, hi_k]
        part = np.partition(flat, sorted(set(kths)))
        for lo_k, hi_k, frac in plan:
            vals.append(float(part[lo_k]) * (1 - frac) + float(part[hi_k]) * frac)
        return vals[0], vals[1]

    def apply_transform(self, subject):
        out_min, out_max = self.out_min_max
        for image in self.get_images(subject):
            raw = image.data
            data = np.asarray(raw, dtype=np.float32)
            p_lo, p_hi = self.percentiles
            if p_lo <= 0.0 and p_hi >= 100.0:
                lo, hi = float(data.min()), float(data.max())
            else:
                lo, hi = self._percentiles(data.reshape(-1), p_lo, p_hi)
            # one owned copy, then in-place arithmetic
            data = np.clip(data, lo, hi, out=data if data is not raw else None)
            if hi - lo > 1e-12:
                data -= lo
                data *= (out_max - out_min) / (hi - lo)
                data += out_min
            else:
                data.fill(out_min)
            image.set_data(data)
        return None


class ZNormalization(IntensityTransform):
    """Zero mean and unit std, optionally over a masked region
    (``get_mask_from_masking_method``)."""

    def __init__(self, masking_method=None, **kwargs):
        super().__init__(**kwargs)
        self.masking_method = masking_method

    def apply_transform(self, subject):
        from .label import get_mask_from_masking_method

        for image in self.get_images(subject):
            data = np.asarray(image.data, dtype=np.float32)
            if self.masking_method is None:
                # the moments of the whole array, without a boolean-index copy
                mean, std = float(data.mean()), float(data.std())
                if std < 1e-12:
                    std = 1.0
                image.set_data((data - mean) / std)
                continue
            mask = get_mask_from_masking_method(self.masking_method, subject, data)
            values = data[mask]
            if values.size == 0:
                raise RuntimeError(
                    f"ZNormalization mask {self.masking_method!r} selects no voxels for image "
                    f"in subject {subject.get('name')!r} — normalizing would produce an "
                    f"all-NaN image")
            std = values.std()
            if std < 1e-12:
                std = 1.0
            image.set_data((data - values.mean()) / std)
        return None


class RandomNoise(RandomTransform, IntensityTransform):
    """Additive Gaussian noise; std sampled U(0, std) per image
    (tio.RandomNoise, main_config.py:86)."""

    def __init__(self, mean: float = 0.0, std: Union[float, Tuple[float, float]] = 0.25, **kwargs):
        super().__init__(**kwargs)
        self.mean = tuple(mean) if isinstance(mean, (tuple, list)) else mean
        self.std = tuple(std) if isinstance(std, (tuple, list)) else std

    def apply_transform(self, subject):
        for image in self.get_images(subject):
            if isinstance(self.std, tuple):
                std = self.rng.uniform(*self.std)
            else:
                std = self.rng.uniform(0.0, self.std)
            mean = self.rng.uniform(*self.mean) if isinstance(self.mean, tuple) else self.mean
            data = np.asarray(image.data, dtype=np.float32)
            noise = self.rng.normal(mean, max(std, 1e-12), size=data.shape).astype(np.float32)
            image.set_data(data + noise)
        return None


class RandomBlur(RandomTransform, IntensityTransform):
    """Gaussian blur with per-axis std (mm) sampled from a range
    (tio.RandomBlur, main_config.py:87)."""

    def __init__(self, std: Union[float, Tuple[float, float]] = (0.0, 2.0), **kwargs):
        super().__init__(**kwargs)
        self.std = tuple(std) if isinstance(std, (tuple, list)) else (0.0, std)

    def apply_transform(self, subject):
        for image in self.get_images(subject):
            std_mm = self.rng.uniform(self.std[0], self.std[1], size=3)
            spacing = np.array(image.spacing)
            sigma_vox = std_mm / spacing
            data = np.asarray(image.data, dtype=np.float32)
            out = np.stack([
                ndi.gaussian_filter(data[c], sigma=sigma_vox) for c in range(data.shape[0])
            ])
            image.set_data(out)
        return None


class RandomGamma(RandomTransform, IntensityTransform):
    """Gamma perturbation: gamma = exp(U(log_gamma)); sign-preserving power
    for negative-valued images (tio.RandomGamma, main_config.py:94)."""

    def __init__(self, log_gamma: Union[float, Tuple[float, float]] = (-0.3, 0.3), **kwargs):
        super().__init__(**kwargs)
        self.log_gamma = (tuple(log_gamma) if isinstance(log_gamma, (tuple, list))
                          else (-log_gamma, log_gamma))

    def apply_transform(self, subject):
        for image in self.get_images(subject):
            gamma = float(np.exp(self.rng.uniform(*self.log_gamma)))
            data = np.asarray(image.data, dtype=np.float32)
            if data.min() < 0:
                out = np.sign(data) * np.abs(data) ** gamma
            else:
                out = data ** gamma
            image.set_data(out.astype(np.float32))
        return None


class RandomBiasField(RandomTransform, IntensityTransform):
    """Multiplicative polynomial bias field: order-3 monomials with
    coefficients U(-c, c), field = exp(poly) over normalized coords
    (tio.RandomBiasField, main_config.py:92)."""

    def __init__(self, coefficients: Union[float, Tuple[float, float]] = 0.5, order: int = 3, **kwargs):
        super().__init__(**kwargs)
        self.coefficients = (tuple(coefficients)
                             if isinstance(coefficients, (tuple, list))
                             else (-coefficients, coefficients))
        self.order = order

    def apply_transform(self, subject):
        for image in self.get_images(subject):
            data = np.asarray(image.data, dtype=np.float32)
            shape = data.shape[1:]
            ranges = [np.linspace(-1.0, 1.0, s, dtype=np.float32) for s in shape]
            x = ranges[0][:, None, None]
            y = ranges[1][None, :, None]
            z = ranges[2][None, None, :]
            field = np.zeros(shape, dtype=np.float32)
            for i in range(self.order + 1):
                for j in range(self.order + 1 - i):
                    for k in range(self.order + 1 - i - j):
                        coeff = self.rng.uniform(*self.coefficients)
                        field += coeff * (x ** i) * (y ** j) * (z ** k)
            field = np.exp(field).astype(np.float32)
            image.set_data(data * field[None])
        return None
