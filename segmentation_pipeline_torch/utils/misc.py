"""Small helpers copied from segmentation_pipeline_tpu/utils/misc.py."""
from __future__ import annotations


def as_list(x) -> list:
    if isinstance(x, list):
        return x
    if isinstance(x, tuple):
        return list(x)
    return [x]


def auto_str(obj) -> str:
    """repr built from __dict__."""
    params = ", ".join(f"{k}={v!r}" for k, v in vars(obj).items() if not k.startswith("_"))
    return f"{type(obj).__name__}({params})"
