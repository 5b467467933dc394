"""Random spatial augmentation, ported from
segmentation_pipeline_tpu/transforms/random_spatial.py: ``RandomFlip``,
``Affine`` and ``RandomAffine``, ``invert_displacement_field_voxels``,
``ElasticDeformation`` and ``RandomElasticDeformation``.

Each Random* transform samples its parameters from ``get_rng()`` and
dispatches a concrete transform (``Flip``, ``Affine``,
``ElasticDeformation``) onto the history tape, so the applied warp is
invertible: the affine by its inverse matrix, the elastic warp by the
inverse displacement field (Newton iteration). Host-side numpy and
scipy.ndimage, as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
from scipy import ndimage as ndi

from ..core.subject import LabelMap
from .base import RandomTransform, SpatialTransform
from .spatial import Flip, _pad_value


class RandomFlip(RandomTransform, SpatialTransform):
    """Flip each listed spatial axis independently with probability
    ``flip_probability`` (tio.RandomFlip semantics)."""

    def __init__(self, axes: Union[int, Sequence[int]] = 0, flip_probability: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        if isinstance(axes, int):
            axes = (axes,)
        self.axes = tuple(axes)
        self.flip_probability = flip_probability

    def __call__(self, subject, record: bool = True):
        if isinstance(subject, (list, tuple)):
            return [self(s, record=record) for s in subject]
        if self.p < 1.0 and self.rng.random() > self.p:
            return subject
        chosen = tuple(a for a in self.axes if self.rng.random() < self.flip_probability)
        if not chosen:
            return subject
        concrete = Flip(chosen, **self._sel())
        return concrete(subject, record=record)

    def apply_transform(self, subject):  # pragma: no cover
        raise RuntimeError("dispatches via __call__")


def _as_range(value, center: float = 0.0) -> Tuple[float, float]:
    if isinstance(value, (tuple, list)):
        if len(value) == 2:
            return float(value[0]), float(value[1])
        raise ValueError(f"Range must have 2 elements, got {value}")
    v = float(value)
    return center - v, center + v


def _interp_order(interpolation: str, is_label: bool) -> int:
    """scipy spline order for an interpolation name; labels always nearest.
    Mirrors spatial.py's Resample dispatch so 'nearest' means nearest here
    too (it previously fell through to cubic)."""
    if is_label or interpolation == "nearest":
        return 0
    if interpolation == "linear":
        return 1
    if interpolation in ("bspline", "cubic"):
        return 3
    raise ValueError(f"Unsupported interpolation {interpolation!r}")


class Affine(SpatialTransform):
    """Concrete affine resample about the image center.

    Output voxel ``o`` samples the input at ``c + A(o - c) - t/spacing``
    where ``A = diag(1/spacing) @ matrix @ diag(spacing)`` — i.e. ``matrix``
    is the mm-space linear part (output->input direction) and ``translation``
    is in mm, so rotations stay rigid under anisotropic voxels.  The
    counterpart of torchio's applied ``Affine`` (the object its RandomAffine
    records for inversion); exactly invertible on the coordinate grid:
    ``inverse()`` resamples by ``inv(matrix)`` / ``-inv(matrix) @ t``.
    Voxels that left the field of view under the forward warp come back as
    pad values — interpolation loss, not coordinate error.
    """

    def __init__(self, matrix, translation=(0.0, 0.0, 0.0),
                 image_interpolation: str = "linear",
                 default_pad_value: Union[str, float] = "minimum", **kwargs):
        super().__init__(**kwargs)
        self.matrix = np.asarray(matrix, dtype=np.float64).reshape(3, 3)
        self.translation = np.asarray(translation, dtype=np.float64).reshape(3)
        self.image_interpolation = image_interpolation
        self.default_pad_value = default_pad_value

    def apply_transform(self, subject):
        M = self.matrix
        translation = self.translation
        for image in self.get_images(subject):
            data = np.asarray(image.data)
            spatial = np.array(data.shape[1:], dtype=np.float64)
            center = (spatial - 1) / 2
            spacing = np.array(image.spacing)
            # Work in voxel space scaled by spacing so rotations are rigid in mm.
            A = np.diag(1.0 / spacing) @ M @ np.diag(spacing)
            offset = center - A @ center - translation / spacing

            is_label = isinstance(image, LabelMap)
            order = _interp_order(self.image_interpolation, is_label)
            cval = 0.0 if is_label else _pad_value(data, self.default_pad_value)

            src = data.astype(np.float32)
            out = np.stack([
                ndi.affine_transform(src[c], A, offset=offset, order=order,
                                     mode="constant", cval=cval, prefilter=order > 1)
                for c in range(data.shape[0])
            ])
            if is_label:
                out = np.rint(out).astype(data.dtype)
            image.set_data(out)
        return None

    def is_invertible(self) -> bool:
        return True

    def inverse(self, args=None) -> "Affine":
        # composing forward (M, t) with (inv(M), -inv(M) t) yields the exact
        # identity on output coordinates: p = c + A(c + A^-1(p-c) + A^-1 t/s
        # - c) - t/s = p (A^-1 = diag(1/s) inv(M) diag(s))
        M_inv = np.linalg.inv(self.matrix)
        return Affine(matrix=M_inv, translation=-M_inv @ self.translation,
                      image_interpolation=self.image_interpolation,
                      default_pad_value=self.default_pad_value, **self._sel())


class RandomAffine(RandomTransform, SpatialTransform):
    """Random rotation/scale/translation about the image center
    (tio.RandomAffine: scales=s -> U(1-s, 1+s), degrees=d -> U(-d, d) per
    axis, default_pad_value='otsu' pads scalars with the mean sub-Otsu
    background, msseg2.py:49).  Samples parameters, then dispatches a
    concrete invertible :class:`Affine` onto the tape."""

    def __init__(self, scales=0.1, degrees=10, translation=0,
                 image_interpolation: str = "linear",
                 default_pad_value: Union[str, float] = "minimum", **kwargs):
        super().__init__(**kwargs)
        self.scales = _as_range(scales, center=1.0)
        self.degrees = _as_range(degrees)
        self.translation = _as_range(translation)
        self.image_interpolation = image_interpolation
        self.default_pad_value = default_pad_value

    def __call__(self, subject, record: bool = True):
        if isinstance(subject, (list, tuple)):
            return [self(s, record=record) for s in subject]
        if self.p < 1.0 and self.rng.random() > self.p:
            return subject
        scales = self.rng.uniform(*self.scales, size=3)
        degrees = self.rng.uniform(*self.degrees, size=3)
        translation = self.rng.uniform(*self.translation, size=3)

        radians = np.deg2rad(degrees)
        cx, cy, cz = np.cos(radians)
        sx, sy, sz = np.sin(radians)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        M = Rx @ Ry @ Rz @ np.diag(scales)  # output-voxel -> input-voxel (mm)

        concrete = Affine(matrix=M, translation=translation,
                          image_interpolation=self.image_interpolation,
                          default_pad_value=self.default_pad_value,
                          **self._sel())
        return concrete(subject, record=record)

    def apply_transform(self, subject):  # pragma: no cover
        raise RuntimeError("dispatches via __call__")


def invert_displacement_field_voxels(field_vox: np.ndarray,
                                     max_iterations: int = 30,
                                     tol: float = 1e-3) -> np.ndarray:
    """Inverse of a (3, W, H, D) voxel displacement field by Newton iteration.

    Solves ``v(x) + u(x + v(x)) = 0`` per voxel: the composition
    ``x -> x + v(x) -> (x + v) + u(x + v)`` returns to ``x``, so warping by
    ``v`` exactly undoes the warp by ``u``.  Newton on the residual
    ``r = v + u(x+v)`` (Jacobian ``I + grad u``) converges wherever the
    forward warp is locally invertible (``det(I + grad u) > 0``) — a strictly
    weaker requirement than the plain fixed-point iteration's contraction
    condition ``sup|grad u| < 1``, which torchio-default-scale fields can
    violate.  ``max_iterations=0`` returns ``-u``, the negated-field
    approximation torchio uses.  Stops when the max residual falls below
    ``tol`` voxels; where the field genuinely folds (no inverse exists) the
    best iterate is kept.
    """
    v = -field_vox
    if max_iterations <= 0:
        return v
    idx = np.meshgrid(*[np.arange(s, dtype=np.float32)
                        for s in field_vox.shape[1:]], indexing="ij")
    # grad_u[a][b] = d u_a / d x_b on the voxel grid (2nd-order central)
    grad_u = [[np.gradient(field_vox[a], axis=b).astype(np.float32)
               for b in range(3)] for a in range(3)]

    def residual_at(v):
        coords = [idx[a] + v[a] for a in range(3)]
        u_at = np.stack([
            ndi.map_coordinates(field_vox[a], coords, order=1, mode="nearest")
            for a in range(3)
        ])
        return v + u_at, coords

    # per-voxel monotone damped Newton: each voxel only ever accepts a step
    # that reduces ITS residual; a rejected voxel halves its damping factor
    # for the next try (so it does not re-attempt the identical step), an
    # accepted one grows it back. Voxels in genuinely folded regions (the
    # forward warp destroyed the information; det(I+grad u) <= 0) stall at
    # their best iterate.
    step_clamp = 2.0
    damping = np.ones(field_vox.shape[1:], np.float32)
    for _ in range(max_iterations):
        r, coords = residual_at(v)
        resnorm = np.abs(r).max(axis=0)
        if float(resnorm.max()) < tol:
            break
        J = np.empty((*field_vox.shape[1:], 3, 3), np.float32)
        for a in range(3):
            for b in range(3):
                J[..., a, b] = ndi.map_coordinates(
                    grad_u[a][b], coords, order=1, mode="nearest")
        J[..., 0, 0] += 1.0
        J[..., 1, 1] += 1.0
        J[..., 2, 2] += 1.0
        # singular voxels (fold boundaries): identity -> plain damped step
        singular = np.abs(np.linalg.det(J)) < 1e-6
        J[singular] = np.eye(3, dtype=np.float32)
        dv = np.linalg.solve(J, np.moveaxis(r, 0, -1)[..., None])[..., 0]
        dv = np.moveaxis(dv, -1, 0)
        norm = np.sqrt((dv ** 2).sum(axis=0))
        dv *= damping * np.minimum(1.0, step_clamp / np.maximum(norm, 1e-12))
        v_cand = v - dv
        r_cand, _ = residual_at(v_cand)
        accept = np.abs(r_cand).max(axis=0) <= resnorm
        v = np.where(accept[None], v_cand, v)
        damping = np.where(accept, np.minimum(1.0, damping * 1.5),
                           damping * 0.5)
    return v


class ElasticDeformation(SpatialTransform):
    """Concrete b-spline free-form deformation from a fixed control grid.

    ``control_grid`` is a (3, cw, ch, cd) array of mm displacements spanning
    the image extent; the dense field ``u`` comes from separable cubic
    b-spline upsampling and each output voxel samples ``x + u(x)/spacing``.
    The counterpart of torchio's applied ``ElasticDeformation``; invertible:
    ``inverse()`` warps by the fixed-point inverse displacement field (exact
    to ``tol`` voxels where the forward warp stays within the volume —
    tighter than torchio's negated-field approximation, see PARITY.md).
    """

    def __init__(self, control_grid, image_interpolation: str = "linear",
                 invert: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.control_grid = np.asarray(control_grid, dtype=np.float32)
        self.image_interpolation = image_interpolation
        self.invert = invert

    @staticmethod
    def _bspline_matrix(n_cp: int, size: int) -> np.ndarray:
        """(size, n_cp) matrix of the 1D cubic-B-spline interpolation operator
        (prefilter + basis, mode='nearest') evaluated at the dense positions
        linspace(0, n_cp-1, size).  map_coordinates is linear in its input,
        so the matrix built from basis vectors reproduces it exactly."""
        pos = np.linspace(0, n_cp - 1, size, dtype=np.float64)[None]
        eye = np.eye(n_cp, dtype=np.float64)
        cols = [ndi.map_coordinates(eye[j], pos, order=3, mode="nearest")
                for j in range(n_cp)]
        return np.stack(cols, axis=1).astype(np.float32)

    @staticmethod
    def dense_field(control_grid: np.ndarray, spatial_shape: Tuple[int, int, int]) -> np.ndarray:
        """Upsample the (3, cw, ch, cd) control grid to (3, W, H, D) with
        cubic b-spline interpolation. Control points span the image extent.

        Tensor-grid B-spline interpolation is separable (prefilter and basis
        both factor per axis), so instead of a generic map_coordinates over
        W*H*D points (~1.4 s/axis at 160x192x160) this contracts the control
        grid with three small (S, n_cp) basis matrices (~milliseconds) —
        bit-equal to the map_coordinates result up to fp association."""
        cp = control_grid.shape[1:]
        Ms = [ElasticDeformation._bspline_matrix(c, s)
              for c, s in zip(cp, spatial_shape)]
        out = np.einsum("aijk,wi->awjk", control_grid.astype(np.float32), Ms[0])
        out = np.einsum("awjk,hj->awhk", out, Ms[1])
        out = np.einsum("awhk,dk->awhd", out, Ms[2])
        return np.ascontiguousarray(out, dtype=np.float32)

    def apply_transform(self, subject):
        field_cache = {}  # per (spatial, spacing): images usually share one
        for image in self.get_images(subject):
            data = np.asarray(image.data)
            spatial = data.shape[1:]
            spacing = np.array(image.spacing, dtype=np.float32)
            cache_key = (spatial, tuple(spacing.tolist()))
            field_vox = field_cache.get(cache_key)
            if field_vox is None:
                field_mm = self.dense_field(self.control_grid, spatial)
                field_vox = field_mm / spacing[:, None, None, None]
                if self.invert:
                    field_vox = invert_displacement_field_voxels(field_vox)
                field_cache[cache_key] = field_vox

            idx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in spatial], indexing="ij")
            sample_coords = [idx[a] + field_vox[a] for a in range(3)]

            is_label = isinstance(image, LabelMap)
            order = _interp_order(self.image_interpolation, is_label)
            src = data.astype(np.float32)
            out = np.stack([
                ndi.map_coordinates(src[c], sample_coords, order=order, mode="nearest")
                for c in range(data.shape[0])
            ])
            if is_label:
                out = np.rint(out).astype(data.dtype)
            image.set_data(out)
        return None

    def is_invertible(self) -> bool:
        return True

    def inverse(self, args=None) -> "ElasticDeformation":
        return ElasticDeformation(self.control_grid,
                                  image_interpolation=self.image_interpolation,
                                  invert=not self.invert, **self._sel())


class RandomElasticDeformation(RandomTransform, SpatialTransform):
    """B-spline free-form deformation: a coarse control grid of random
    displacements (mm), upsampled to a dense field, warps all images
    (tio.RandomElasticDeformation; num_control_points includes border points,
    locked_borders zeroes that many outer layers; main_config.py:90-91).
    Samples the control grid, then dispatches a concrete invertible
    :class:`ElasticDeformation` onto the tape."""

    def __init__(self, num_control_points: Union[int, Tuple[int, int, int]] = 7,
                 max_displacement: Union[float, Tuple[float, float, float]] = 7.5,
                 locked_borders: int = 2,
                 image_interpolation: str = "linear", **kwargs):
        super().__init__(**kwargs)
        if isinstance(num_control_points, int):
            num_control_points = (num_control_points,) * 3
        self.num_control_points = tuple(num_control_points)
        if isinstance(max_displacement, (int, float)):
            max_displacement = (float(max_displacement),) * 3
        self.max_displacement = tuple(max_displacement)
        self.locked_borders = locked_borders
        self.image_interpolation = image_interpolation

    def sample_control_grid(self) -> np.ndarray:
        grid = np.stack([
            self.rng.uniform(-d, d, size=self.num_control_points)
            for d in self.max_displacement
        ])  # (3, cp_w, cp_h, cp_d), displacements in mm
        lb = self.locked_borders
        if lb > 0:
            for axis in range(3):
                sl = [slice(None)] * 4
                sl[1 + axis] = slice(0, lb)
                grid[tuple(sl)] = 0
                sl[1 + axis] = slice(-lb, None)
                grid[tuple(sl)] = 0
        return grid

    def __call__(self, subject, record: bool = True):
        if isinstance(subject, (list, tuple)):
            return [self(s, record=record) for s in subject]
        if self.p < 1.0 and self.rng.random() > self.p:
            return subject
        concrete = ElasticDeformation(
            self.sample_control_grid(),
            image_interpolation=self.image_interpolation, **self._sel())
        return concrete(subject, record=record)

    def apply_transform(self, subject):  # pragma: no cover
        raise RuntimeError("dispatches via __call__")
