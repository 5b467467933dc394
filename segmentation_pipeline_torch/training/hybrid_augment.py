"""Per-batch host stage of the hybrid device-cache fast path.

Ported from segmentation_pipeline_tpu/training/hybrid_augment.py (one
device, no mesh). dmri_hippo's augmentation ablation puts
``ReconstructMeanDWI`` at the start of the stochastic window
(``research/dmri_hippo/configs/augmentation.py``, modes
``dwi_reconstruction`` and ``combined``). It has no device counterpart: it
resynthesizes the mean-DWI channel from the full 4-D DWI series, which never
reaches the device batch. ``derive_hybrid_augmentation``
(training/auto_augment.py) peels it off into a ``HybridSpec``; the device
cache holds every channel (the static draw of the pretransform), and for
each batch this stage

1. re-applies the peeled transforms to a shallow scratch copy of each
   pretransformed subject (it shares the series' buffer: transforms rebind
   image data, ``Image.set_data``, and never write into it);
2. re-applies the suffix's intensity finishers to the regenerated images
   only (the cache already holds them applied to the static channels);
3. uploads that channel block through pinned memory and splices it into the
   gathered cached X on the device, before the derived device augmentation
   runs.

The host sends the regenerated channels only (1 of 3 for dmri_hippo), not
the whole batch. Its work per subject of a batch is the peeled transforms
(for ``ReconstructMeanDWI``, a mean over the at most ``num_dwis`` volumes it
draws, gathered alone from the series) and the finishers on the regenerated
channels (for dmri_hippo, ``RescaleIntensity``'s percentiles).
"""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from ..core.subject import Image, Subject
from ..device import resolve_device
from .auto_augment import HybridSpec


class HybridHostAugment:
    """``apply(X_device, indices) -> X_device`` with the spec's channels
    regenerated on the host and spliced into X on the device.
    ``upload_bytes`` holds the bytes of the last uploaded block."""

    def __init__(self, subjects: Sequence[Subject], spec: HybridSpec, x_dtype=None,
                 device=None):
        self.subjects = list(subjects)
        self.spec = spec
        self.x_dtype = x_dtype
        self.device = resolve_device(device)
        self.upload_bytes = 0
        # the splice trusts the declared ConcatenateImages.image_channels:
        # check them once against the pretransformed data, or a mismatch
        # would write the block into the wrong channels of every batch
        if self.subjects:
            probe = self.subjects[0]
            for name, (off, n) in spec.slots.items():
                actual = int(np.asarray(probe[name].data).shape[0])
                if actual != n:
                    raise ValueError(
                        f"hybrid channel slots: image '{name}' has {actual} channel(s) but "
                        f"the ConcatenateImages declaration says {n} — fix image_channels "
                        f"in the model-io concat")
        self._slots = [spec.slots[name] for name in spec.image_order]

    # ---- host side -----------------------------------------------------
    @staticmethod
    def _scratch(subject: Subject) -> Subject:
        out = Subject()
        for k, v in subject.items():
            out[k] = copy.copy(v) if isinstance(v, Image) else v
        return out

    def regenerate(self, indices) -> torch.Tensor:
        """The (N, W, H, D, C_regenerated) host block in the cache's dtype."""
        blocks = []
        for i in indices:
            s = self._scratch(self.subjects[int(i)])
            for t in self.spec.peeled:
                t(s, record=False)
            for t in self.spec.finishers:
                t(s, record=False)
            arrs = [np.asarray(s[name].data, dtype=np.float32) for name in self.spec.image_order]
            blocks.append(np.concatenate(arrs, axis=0))  # (C_regenerated, W, H, D)
        block = torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.stack(blocks), 1, -1)))
        return block if self.x_dtype is None else block.to(self.x_dtype)

    # ---- device side ---------------------------------------------------
    def apply(self, X: torch.Tensor, indices) -> torch.Tensor:
        """Splice the regenerated block into the gathered batch X (N, W, H,
        D, C), in place; the upload does not block the host."""
        block = self.regenerate(indices)
        self.upload_bytes = block.nbytes
        if self.device.type == "cuda":
            block = block.pin_memory().to(self.device, non_blocking=True)
        else:
            block = block.to(self.device)
        src = 0
        for off, n in self._slots:
            X[..., off:off + n] = block[..., src:src + n].to(X.dtype)
            src += n
        return X
