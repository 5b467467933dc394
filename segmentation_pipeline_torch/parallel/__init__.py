"""Data-parallel meshes over ``torch.distributed``, ported from
segmentation_pipeline_tpu/parallel: the mesh, its checkpoint recipe, batch
sharding and the collectives (mesh.py), and the sliding window with its
patch grid sharded over the ranks (halo.py). Spatial sharding (halo
exchange, W-sharded volumes) waits for ROADMAP Queue 1 item 10b."""
from .halo import distributed_sliding_window
from .mesh import (BatchShard, Mesh, MeshRecipe, all_gather_rows, all_reduce_sum,
                   make_mesh, pad_batch_to_devices, shard_batch)

__all__ = ["BatchShard", "Mesh", "MeshRecipe", "all_gather_rows", "all_reduce_sum",
           "distributed_sliding_window", "make_mesh", "pad_batch_to_devices", "shard_batch"]
