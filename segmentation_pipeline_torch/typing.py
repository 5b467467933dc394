"""Shared type aliases, as segmentation_pipeline_tpu/typing.py has them."""
from __future__ import annotations

import os
from typing import Union

PathLike = Union[str, os.PathLike]
