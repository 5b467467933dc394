"""The whole NestedResUNet forward on a W-sharded volume, no patches.

Ported from segmentation_pipeline_tpu/parallel/sharded_model.py. The
volume's W axis is sharded over a mesh axis and stays sharded through the
whole network (models/components.py::spatially_sharded): every conv
halo-exchanges its one-row margin and runs on the hand kernels, pooling
stays on the slab (slab boundaries fall on even rows at every level), and
the align-corners upsample reads the global rows it needs from a one-row
halo. No rank holds the whole volume or any whole feature map.

Supported: models whose convs are 3^3/s1/p1, with AvgPool-2 down and
trilinear-2x up (NestedResUNet). W must divide by the axis's ranks x 8
(its three pooling levels).
"""
from __future__ import annotations

import torch

from ..models.components import spatially_sharded
from .mesh import Mesh


def spatial_sharded_inference(model, volume_cf, mesh: Mesh,
                              axis_name: str = "data") -> torch.Tensor:
    """A SegModel's eval-mode forward on a volume whose W axis is sharded
    over the mesh's ``axis_name``.

    volume_cf: this rank's slab (C, w, H, D) of one volume of W = w x ranks
    (``Mesh.w_slab``). Returns this rank's slab (C_out, w, H, D) of the
    float32 output on the model's device, the unsharded forward's up to the
    order of its sums. Every rank of the axis's line must call it."""
    ranks = mesh.shape[axis_name]
    volume = torch.as_tensor(volume_cf, dtype=torch.float32)
    W = volume.shape[1] * ranks
    levels = getattr(model.module, "pooling_levels", 3)
    if W % (ranks * 2 ** levels) != 0:
        raise ValueError(
            f"W={W} must be divisible by mesh_size*{2 ** levels} = {ranks * 2 ** levels} "
            f"(shard-aligned pooling at {levels} levels)")
    model.ensure_initialized()
    module = model.module
    module.eval()
    x = volume.to(model.device).permute(1, 2, 3, 0)[None].contiguous()
    with torch.inference_mode(), spatially_sharded(module, mesh, axis_name):
        out = module(x)
    return out[0].float().permute(3, 0, 1, 2)
