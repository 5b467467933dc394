"""JSON encoder that keeps scalar lists on one line, copied from
segmentation_pipeline_tpu/utils/compact_json.py: a recursive encode that
inlines any container holding only scalars.
"""
from __future__ import annotations

import json
import numpy as np


def _to_builtin(obj):
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, tuple):
        return list(obj)
    return obj


class CompactJSONEncoder:
    def __init__(self, indent: int = 2, max_inline_length: int = 100):
        self.indent = indent
        self.max_inline_length = max_inline_length

    def encode(self, obj) -> str:
        return self._encode(obj, 0)

    def _encode(self, obj, level: int) -> str:
        obj = _to_builtin(obj)
        pad = " " * (self.indent * (level + 1))
        close_pad = " " * (self.indent * level)

        if isinstance(obj, dict):
            if not obj:
                return "{}"
            items = [
                f'{pad}{json.dumps(str(k))}: {self._encode(v, level + 1)}'
                for k, v in obj.items()
            ]
            return "{\n" + ",\n".join(items) + "\n" + close_pad + "}"

        if isinstance(obj, list):
            if not obj:
                return "[]"
            if all(isinstance(_to_builtin(v), (int, float, str, bool, type(None))) for v in obj):
                inline = json.dumps([_to_builtin(v) for v in obj])
                if len(inline) <= self.max_inline_length:
                    return inline
            items = [f"{pad}{self._encode(v, level + 1)}" for v in obj]
            return "[\n" + ",\n".join(items) + "\n" + close_pad + "]"

        return json.dumps(obj)
