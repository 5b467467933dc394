"""Small helpers copied from segmentation_pipeline_tpu/utils/misc.py."""
from __future__ import annotations

import inspect
import random
from typing import Any, Dict


def no_op(batch):
    """Identity collate: a batch is a list of Subjects."""
    return batch


def is_sequence(x) -> bool:
    return isinstance(x, (list, tuple))


def as_list(x) -> list:
    if isinstance(x, list):
        return x
    if isinstance(x, tuple):
        return list(x)
    return [x]


def as_set(x) -> set:
    if isinstance(x, (list, tuple, set, frozenset, range)):
        return set(x)
    return {x}


def vargs_or_sequence(args):
    """Accept either varargs or a single sequence argument."""
    if len(args) == 1 and is_sequence(args[0]):
        return list(args[0])
    return list(args)


def flatten_nested_dict(nested: Dict, prefix: str = "", sep: str = ".") -> Dict[str, Any]:
    """Flattens {'a': {'b': 1}} -> {'a.b': 1}."""
    out = {}
    for key, value in nested.items():
        full_key = f"{prefix}{sep}{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten_nested_dict(value, full_key, sep))
        else:
            out[full_key] = value
    return out


def auto_str(obj) -> str:
    """repr built from __dict__."""
    params = ", ".join(f"{k}={v!r}" for k, v in vars(obj).items() if not k.startswith("_"))
    return f"{type(obj).__name__}({params})"


def random_folds(num_items: int, num_folds: int, seed: int = 0) -> list:
    """Deterministically assign each of num_items to one of num_folds
    (even sizes up to remainder)."""
    fold_ids = [i % num_folds for i in range(num_items)]
    rng = random.Random(seed)
    rng.shuffle(fold_ids)
    return fold_ids


def time_str_to_seconds(time_str) -> float:
    """Parse SLURM-style 'D-HH:MM:SS' / 'HH:MM:SS' / 'MM:SS' / seconds."""
    if isinstance(time_str, (int, float)):
        return float(time_str)
    days = 0
    s = str(time_str)
    if "-" in s:
        day_part, s = s.split("-")
        days = int(day_part)
    parts = [int(p) for p in s.split(":")]
    seconds = 0
    for p in parts:
        seconds = seconds * 60 + p
    return days * 86400 + seconds


def filter_kwargs(cls_or_fn, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the kwargs the callable's signature accepts (all of them
    when it takes **kwargs)."""
    sig = inspect.signature(cls_or_fn)
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
        return dict(kwargs)
    return {k: v for k, v in kwargs.items() if k in sig.parameters}
