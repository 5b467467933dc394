"""Meshes over ``torch.distributed``, ported from
segmentation_pipeline_tpu/parallel: the mesh with its axis groups, its
checkpoint recipe, batch sharding and the collectives (mesh.py); the halo
exchange, the sharded conv and the sliding window with the patch grid or
the volume W-sharded over the ranks (halo.py); the whole NestedResUNet
forward on a W-sharded volume (sharded_model.py)."""
from .halo import (distributed_sliding_window, halo_exchange, sharded_conv3d,
                   sharded_volume_sliding_window)
from .mesh import (BatchShard, Mesh, MeshRecipe, all_gather_rows, all_reduce_sum, gather_w,
                   make_mesh, pad_batch_to_devices, shard_batch)
from .sharded_model import spatial_sharded_inference

__all__ = ["BatchShard", "Mesh", "MeshRecipe", "all_gather_rows", "all_reduce_sum",
           "distributed_sliding_window", "gather_w", "halo_exchange", "make_mesh",
           "pad_batch_to_devices", "shard_batch", "sharded_conv3d",
           "sharded_volume_sliding_window", "spatial_sharded_inference"]
