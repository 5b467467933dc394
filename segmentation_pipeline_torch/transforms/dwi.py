"""Physics-aware DWI augmentation, ported from
segmentation_pipeline_tpu/transforms/dwi.py: regenerate the ``mean_dwi``
input from the full 4-D DWI series and its gradient table by averaging a
random subset of the diffusion directions. Host-side numpy on the
transforms' ``get_rng()``, as in the JAX package, so both packages draw the
same subsets from the same seed.
"""
from __future__ import annotations

from numbers import Number
from typing import Tuple, Union

import numpy as np

from .base import RandomTransform


def _shell(transform, subject):
    """The series image, its data (volumes, W, H, D), and the indices into
    the series and the unit gradient directions of the volumes whose
    b-value lies inside ``transform.bval_range``. The draws index the shell;
    only the volumes they pick are gathered from the series."""
    full_dwi_image = subject[transform.full_dwi_image_name]
    grad = np.asarray(full_dwi_image[transform.bvec_name])
    bvals = grad[:, 3]
    shell = np.flatnonzero((bvals > transform.bval_range[0]) & (bvals < transform.bval_range[1]))
    return full_dwi_image, np.asarray(full_dwi_image.data), shell, grad[shell, :3]


def _set_mean(transform, subject, full_dwi_image, mean_dwi):
    if transform.mean_dwi_image_name in subject:
        mean_image = subject[transform.mean_dwi_image_name]
    else:
        # a fresh container: a deep copy of the series only to overwrite its
        # data would copy every volume (and carry the series' file paths)
        mean_image = type(full_dwi_image)(tensor=mean_dwi, affine=full_dwi_image.affine.copy())
        subject.add_image(mean_image, transform.mean_dwi_image_name)
    mean_image.set_data(mean_dwi)


class ReconstructMeanDWI(RandomTransform):
    """The mean of a directionally biased random subset of DWIs: each
    volume is drawn with probability proportional to |bvec . direction|^
    directionality, maximized over random directions; the number of
    averaged volumes follows a power-law draw when given as a range."""

    def __init__(self, full_dwi_image_name: str = "full_dwi",
                 mean_dwi_image_name: str = "mean_dwi", bvec_name: str = "grad",
                 num_dwis: Union[int, Tuple[int, int]] = 15,
                 num_directions: Union[int, Tuple[int, int]] = 1,
                 directionality: Union[Number, Tuple[Number, Number]] = 4,
                 bval_range: Tuple[float, float] = (1e-5, 501.0), **kwargs):
        super().__init__(**kwargs)
        self.full_dwi_image_name = full_dwi_image_name
        self.mean_dwi_image_name = mean_dwi_image_name
        self.bvec_name = bvec_name
        self.num_dwis = num_dwis
        self.num_directions = num_directions
        self.directionality = directionality
        self.bval_range = bval_range

    def _sample_num_dwis(self) -> int:
        if isinstance(self.num_dwis, int):
            return self.num_dwis
        low, high = self.num_dwis
        sample = self.rng.random() ** 2  # biased toward few DWIs
        return int(sample * (high - low + 1) + low)

    def _sample_num_directions(self) -> int:
        if isinstance(self.num_directions, int):
            return self.num_directions
        return int(self.rng.integers(self.num_directions[0], self.num_directions[1] + 1))

    def _sample_directionality(self) -> float:
        if isinstance(self.directionality, tuple):
            return float(self.rng.uniform(*self.directionality))
        return float(self.directionality)

    def apply_transform(self, subject):
        if self.full_dwi_image_name not in subject:
            return None
        full_dwi_image, full_dwi, shell, bvecs = _shell(self, subject)

        num_dwis = self._sample_num_dwis()
        num_directions = self._sample_num_directions()
        directionality = self._sample_directionality()

        directions = self.rng.standard_normal((3, num_directions))
        directions = directions / np.linalg.norm(directions, axis=0, keepdims=True)
        probs = np.max(np.abs(bvecs @ directions) ** directionality, axis=1)
        probs = probs / probs.sum()

        indices = self.rng.choice(shell.shape[0], size=num_dwis, p=probs)
        mean_dwi = np.mean(full_dwi[shell[indices]], axis=0, keepdims=True).astype(np.float32)
        _set_mean(self, subject, full_dwi_image, mean_dwi)
        return {"indices": indices.tolist()}

    def is_invertible(self):
        return False


class ReconstructMeanDWIClassic(RandomTransform):
    """The mean of a random subset of the ``subset_size`` gradient
    directions nearest to a random one."""

    def __init__(self, full_dwi_image_name: str = "full_dwi",
                 mean_dwi_image_name: str = "mean_dwi", bvec_name: str = "grad",
                 subset_size: int = 15,
                 bval_range: Tuple[float, float] = (1e-5, 501.0), **kwargs):
        super().__init__(**kwargs)
        self.full_dwi_image_name = full_dwi_image_name
        self.mean_dwi_image_name = mean_dwi_image_name
        self.bvec_name = bvec_name
        self.subset_size = subset_size
        self.bval_range = bval_range

    def apply_transform(self, subject):
        if self.full_dwi_image_name not in subject:
            return None
        full_dwi_image, full_dwi, shell, bvecs = _shell(self, subject)

        rand_bvec = bvecs[self.rng.integers(bvecs.shape[0])]
        dist = np.sum((bvecs - rand_bvec) ** 2, axis=1)
        closest = np.argsort(dist)[: self.subset_size]

        n_select = int(self.rng.integers(1, self.subset_size))
        ids = self.rng.permutation(closest.shape[0])[:n_select]
        selected = closest[ids]
        mean_dwi = np.mean(full_dwi[shell[selected]], axis=0, keepdims=True).astype(np.float32)
        _set_mean(self, subject, full_dwi_image, mean_dwi)
        return {"indices": selected.tolist()}

    def is_invertible(self):
        return False
