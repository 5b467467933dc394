"""Subject/Image data model, ported from segmentation_pipeline_tpu/core/subject.py.

An Image is a numpy array (C, W, H, D) + a (4, 4) affine + arbitrary metadata
(e.g. ``label_values``); a Subject is a dict of images and attributes plus an
applied-transform history tape. Everything here is host-side numpy; torch
tensors enter at ``collate_subjects`` and in ``Image.device_mirror``.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .nifti import read_nifti, write_nifti


class Image:
    """A lazily-loaded 3D medical image: data (C, W, H, D) + affine + metadata."""

    kind = "scalar"

    def __init__(self, *paths, tensor=None, affine=None, uniform: bool = False, **metadata):
        self.paths = [str(p) for p in paths]
        self._data: Optional[np.ndarray] = None
        self._affine: Optional[np.ndarray] = None
        # on-device views of this image's data, keyed by the consumer (see
        # device_mirror). Shared BY REFERENCE across copies/deepcopies so a
        # mirror built while predicting on a transient per-sweep copy
        # persists on the pristine dataset subject; any data reassignment
        # rebinds a fresh dict, detaching the stale entries.
        self._device_mirror: Dict[Any, Any] = {}
        self.metadata: Dict[str, Any] = dict(metadata)
        self.metadata.pop("uniform", None)

        if tensor is not None:
            tensor = np.asarray(tensor)
            if tensor.ndim == 3:
                tensor = tensor[None]
            if tensor.ndim != 4:
                raise ValueError(f"Image tensor must be (C, W, H, D); got {tensor.shape}")
            self._data = tensor
            self._affine = np.eye(4) if affine is None else np.asarray(affine, dtype=np.float64)
        elif affine is not None:
            self._affine = np.asarray(affine, dtype=np.float64)

    # ---- loading -------------------------------------------------------
    @property
    def loaded(self) -> bool:
        return self._data is not None

    def load(self) -> "Image":
        if self._data is None:
            if not self.paths:
                raise RuntimeError("Image has neither tensor data nor file paths")
            arrays = []
            affine = None
            for p in self.paths:
                arr, aff = read_nifti(p)
                arrays.append(arr)
                if affine is None:
                    affine = aff
            # multiple matched files concatenate on the channel axis
            # (ref subject_loaders.py ImageLoader docstring)
            self._data = arrays[0] if len(arrays) == 1 else np.concatenate(arrays, axis=0)
            self._affine = affine
            self._post_load()
        return self

    def _post_load(self):
        pass

    def unload(self):
        if self.paths:
            self._data = None
            self._device_mirror = {}

    # ---- data access ---------------------------------------------------
    @property
    def data(self) -> np.ndarray:
        """The raw (C, W, H, D) array. NOTE: this is the backing ndarray,
        not a copy — writing into it in place (``image.data[...] = v``)
        bypasses the setter and therefore the device-mirror invalidation.
        Assign through ``image.data = new`` / ``set_data`` instead (every
        in-repo transform does); in-place writes are additionally caught by
        the mirror's sampled fingerprint check on the next hit, but only
        probabilistically."""
        if self._data is None:
            self.load()
        return self._data

    @data.setter
    def data(self, value):
        value = np.asarray(value)
        if value.ndim == 3:
            value = value[None]
        self._data = value
        # detach (never mutate — copies may share it) any device mirrors of
        # the replaced data
        self._device_mirror = {}

    def set_data(self, value):
        self.data = value

    # max cached device views per image: each distinct (consumer, padding,
    # dtype) key pins another full-volume copy in device memory, so the cache
    # is a small LRU rather than unbounded. Raise/lower per deployment via
    # `Image.DEVICE_MIRROR_MAX = n`; 0 disables caching entirely.
    DEVICE_MIRROR_MAX = 2

    @staticmethod
    def _data_fingerprint(arr: np.ndarray):
        """Cheap sampled fingerprint of an array's contents: shape + dtype +
        a strided ~1k-element byte sample. Catches (probabilistically) the
        one way a device mirror can go stale — an in-place write through the
        raw ``data`` ndarray that bypasses the setter's invalidation."""
        step = max(1, arr.size // 1024)
        # .flat[::step] copies only the ~1k sampled elements (reshape(-1)
        # would copy the whole volume when non-contiguous)
        return (arr.shape, arr.dtype.str, hash(arr.flat[::step].tobytes()))

    def device_mirror(self, key, make):
        """Cached on-device view of this image's data.

        ``make(self.data)`` builds the view on a miss; ``key`` identifies the
        variant (dtype/padding/etc.). The cache survives copy/deepcopy (the
        dict is shared by reference — device arrays are immutable) and is
        dropped whenever ``data`` is reassigned. Entries carry a sampled
        fingerprint of the source data and rebuild when it changes (in-place
        writes that bypass the ``data`` setter); the cache holds at most
        ``DEVICE_MIRROR_MAX`` entries per image (LRU), bounding the device
        memory pinned per preloaded subject. Mirrors are not pickled (multiprocess
        workers re-upload).
        """
        if self.DEVICE_MIRROR_MAX <= 0:
            return make(self.data)
        entry = self._device_mirror.get(key)
        fp = self._data_fingerprint(self.data)
        if entry is not None and entry[1] == fp:
            # LRU refresh (the dict is insertion-ordered and shared across
            # copies; reordering it is safe — values are never written to)
            self._device_mirror.pop(key, None)
            self._device_mirror[key] = entry
            return entry[0]
        out = make(self.data)
        self._device_mirror.pop(key, None)
        self._device_mirror[key] = (out, fp)
        while len(self._device_mirror) > self.DEVICE_MIRROR_MAX:
            oldest = next(iter(self._device_mirror))
            del self._device_mirror[oldest]
        return out

    def clear_device_mirror(self):
        """Drop every cached device view (frees the device memory they pin
        once no other reference holds them)."""
        self._device_mirror.clear()

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_device_mirror"] = {}
        return state

    @property
    def tensor(self) -> np.ndarray:
        return self.data

    @property
    def affine(self) -> np.ndarray:
        if self._affine is None:
            self.load()
        return self._affine

    @affine.setter
    def affine(self, value):
        self._affine = np.asarray(value, dtype=np.float64)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def spatial_shape(self):
        return tuple(self.data.shape[1:])

    @property
    def num_channels(self) -> int:
        return self.data.shape[0]

    @property
    def spacing(self):
        aff = self.affine
        return tuple(float(s) for s in np.sqrt((aff[:3, :3] ** 2).sum(axis=0)))

    # ---- metadata dict-style access ------------------------------------
    def __getitem__(self, key):
        if key == "data":
            return self.data
        if key == "affine":
            return self.affine
        return self.metadata[key]

    def __setitem__(self, key, value):
        if key == "data":
            self.data = value
        elif key == "affine":
            self.affine = value
        else:
            self.metadata[key] = value

    def __contains__(self, key):
        return key in ("data", "affine") or key in self.metadata

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def items(self):
        return self.metadata.items()

    def keys(self):
        return self.metadata.keys()

    # ---- I/O -----------------------------------------------------------
    def save(self, path):
        write_nifti(path, self.data, self.affine)

    def as_subclass(self, cls: type) -> "Image":
        out = cls(*self.paths, **copy.deepcopy(self.metadata))
        out._data = self._data
        out._affine = self._affine
        out._device_mirror = self._device_mirror
        return out

    def __copy__(self):
        out = type(self)(*self.paths, **self.metadata)
        out._data = self._data
        out._affine = self._affine
        out._device_mirror = self._device_mirror
        return out

    def __deepcopy__(self, memo):
        out = type(self)(*self.paths, **copy.deepcopy(self.metadata, memo))
        out._data = None if self._data is None else self._data.copy()
        out._affine = None if self._affine is None else self._affine.copy()
        # deliberate deepcopy exception: mirrors reflect the same VALUES the
        # copied data holds and are never written to, so sharing the
        # dict lets per-sweep subject copies reuse (and persist) uploads
        out._device_mirror = self._device_mirror
        return out

    def __repr__(self):
        shape = self.shape if self.loaded else "unloaded"
        return f"{type(self).__name__}(shape={shape}, paths={self.paths})"


class ScalarImage(Image):
    kind = "scalar"

    def _post_load(self):
        if not np.issubdtype(self._data.dtype, np.floating):
            self._data = self._data.astype(np.float32)


class LabelMap(Image):
    kind = "label"

    def _post_load(self):
        if not np.issubdtype(self._data.dtype, np.integer):
            self._data = np.rint(self._data).astype(np.int32)


class Subject(dict):
    """A dict of images + attributes with an applied-transform history tape.

    Mirrors torchio.Subject semantics: dict access for both images and
    attributes, ``add_image``, ``get_images_dict``, ``get_composed_history``.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.history: List = []  # list of TransformRecord

    # dict's deepcopy does not carry custom attributes; do it explicitly
    def __deepcopy__(self, memo):
        out = Subject()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        out.history = copy.deepcopy(self.history, memo)
        return out

    def __reduce__(self):
        return (_rebuild_subject, (dict(self), self.history))

    # ---- images --------------------------------------------------------
    def get_images_dict(self, intensity_only: bool = False) -> Dict[str, Image]:
        return {
            k: v
            for k, v in self.items()
            if isinstance(v, Image) and (not intensity_only or v.kind == "scalar")
        }

    def get_first_image(self) -> Image:
        for v in self.values():
            if isinstance(v, Image):
                return v
        raise RuntimeError("Subject has no images")

    def add_image(self, image: Image, image_name: str):
        self[image_name] = image

    def remove_image(self, image_name: str):
        del self[image_name]

    @property
    def name(self):
        return self.get("name")

    @property
    def spatial_shape(self):
        return self.get_first_image().spatial_shape

    def load(self):
        for image in self.get_images_dict().values():
            image.load()
        return self

    def check_consistent_spatial_shape(self):
        shapes = {k: v.spatial_shape for k, v in self.get_images_dict().items()}
        if len(set(shapes.values())) > 1:
            raise RuntimeError(f"Inconsistent spatial shapes: {shapes}")

    # ---- history tape --------------------------------------------------
    def add_transform_record(self, record):
        self.history.append(record)

    def get_composed_history(self):
        """Returns the list of applied-transform records, oldest first."""
        return list(self.history)

    def clear_history(self):
        self.history = []

    def apply_inverse_transform(self, warn: bool = True) -> "Subject":
        """Undo the full history tape (newest first), returning a NEW Subject
        in the original space with an empty history. The transforms mutate in
        place, so the inversion runs on a deep copy and this subject is left
        untouched."""
        from ..transforms.base import invert_records

        out = copy.deepcopy(self)
        out = invert_records(out, out.history, warn=warn)
        out.clear_history()
        return out

    def __repr__(self):
        images = list(self.get_images_dict().keys())
        return f"Subject(name={self.get('name')!r}, images={images})"


def _rebuild_subject(data: dict, history: list) -> Subject:
    out = Subject(data)
    out.history = history
    return out


def collate_subjects(
    subjects: Sequence[Subject], image_names: Sequence[str], device=None,
    cache: bool = False,
) -> Dict[str, torch.Tensor]:
    """Stack named images across subjects into batched tensors on ``device``
    (the card unless the caller passes ``device="cpu"``): shape
    (N, C, W, H, D), float32 for float images and int32 for integer ones.

    ``cache=True`` uploads each image through its device mirror
    (``Image.device_mirror``), so re-collating unchanged subjects skips the
    host->device transfer and only pays an on-device stack.
    """
    device = resolve_device(device)

    def _cast(arr):
        arr = np.asarray(arr)
        if np.issubdtype(arr.dtype, np.integer):
            return arr.astype(np.int32)
        return arr.astype(np.float32)

    batch: Dict[str, Any] = {}
    for name in image_names:
        if cache:
            parts = [s[name].device_mirror(
                ("collate", str(device)),
                lambda d: torch.as_tensor(_cast(d), device=device))
                for s in subjects]
            batch[name] = torch.stack(parts, dim=0)
        else:
            stacked = np.stack(
                [_cast(s[name].data) for s in subjects], axis=0)
            batch[name] = torch.as_tensor(stacked, device=device)
    return batch


def slice_volume(data: np.ndarray, channel: int, plane: str, slice_id: int) -> np.ndarray:
    """Extract a 2D slice from (C, W, H, D) data."""
    arr = np.asarray(data)
    if plane in ("sagittal", "W", 0):
        return arr[channel, slice_id, :, :]
    if plane in ("coronal", "H", 1):
        return arr[channel, :, slice_id, :]
    if plane in ("axial", "D", 2):
        return arr[channel, :, :, slice_id]
    raise ValueError(f"Unknown plane {plane}")
