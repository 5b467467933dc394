"""Introspection-based config harvesting, copied from
segmentation_pipeline_tpu/utils/config.py: objects exposing their __init__
signature values as a nested config dict.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict


def get_nested_config(obj, max_depth: int = 4) -> Any:
    """Recursively harvest constructor-parameter values from an object."""
    if max_depth <= 0:
        return repr(obj)
    if isinstance(obj, (int, float, str, bool, type(None))):
        return obj
    if isinstance(obj, (list, tuple)):
        return [get_nested_config(v, max_depth - 1) for v in obj]
    if isinstance(obj, dict):
        return {k: get_nested_config(v, max_depth - 1) for k, v in obj.items()}
    if hasattr(obj, "get_config"):
        return obj.get_config()
    if hasattr(obj, "__init__") and hasattr(obj, "__dict__"):
        try:
            sig = inspect.signature(type(obj).__init__)
        except (TypeError, ValueError):
            return repr(obj)
        out = {"__class__": type(obj).__name__}
        for name in sig.parameters:
            if name in ("self",) or not hasattr(obj, name):
                continue
            out[name] = get_nested_config(getattr(obj, name), max_depth - 1)
        return out
    return repr(obj)


class Config:
    """Mixin: expose constructor params as a config dict."""

    def get_config(self) -> Dict[str, Any]:
        sig = inspect.signature(type(self).__init__)
        out = {"__class__": type(self).__name__}
        for name in sig.parameters:
            if name == "self" or not hasattr(self, name):
                continue
            out[name] = get_nested_config(getattr(self, name), max_depth=3)
        return out
