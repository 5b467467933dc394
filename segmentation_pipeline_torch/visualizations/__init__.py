"""Notebook exploration widgets, built from the port only."""
from .notebook import vis_features, vis_model, vis_subject

__all__ = ["vis_features", "vis_model", "vis_subject"]
