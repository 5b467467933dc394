"""The H100 benchmark of segmentation_pipeline_torch (see run.py)."""
