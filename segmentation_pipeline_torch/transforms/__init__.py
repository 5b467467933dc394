from .base import Transform, TransformRecord, get_rng, seed_all
from .spatial import EnforceConsistentAffine

__all__ = ["Transform", "TransformRecord", "get_rng", "seed_all", "EnforceConsistentAffine"]
