"""LabeledTensor: string-keyed dense stats container, copied from
segmentation_pipeline_tpu/evaluators/labeled_tensor.py, including the
``['mean', :, 'dice']`` indexing that scoring functions use and the
nan/inf-robust summary stats. numpy-backed.

Where the JAX package's evaluators hand out a pandas DataFrame of per-subject
rows, the port hands out a ``Table``: the same columns, indexable by name,
with ``to_dataframe()`` for callers that have pandas, so the training path
runs where pandas is not installed.
"""
from __future__ import annotations

import copy
from itertools import product
from typing import Sequence

import numpy as np

from ..utils.misc import as_list, is_sequence


class LabeledTensor:
    def __init__(self, dim_names: Sequence[str], dim_keys: Sequence[Sequence[str]]):
        if len(dim_names) != len(dim_keys):
            raise ValueError(
                f"The number of dimension names ({len(dim_names)}) does not match "
                f"the number of dimension keys ({len(dim_keys)})")
        self.dim_names = list(dim_names)
        self.dim_keys = [list(k) for k in dim_keys]
        self.dim_key_map = [{key: i for i, key in enumerate(keys)} for keys in self.dim_keys]
        self.data = np.zeros([len(k) for k in self.dim_keys], dtype=np.float64)

    def _resolve(self, axis: int, k):
        """Map one axis of a key to numpy indexing: label strings become
        integer positions via the axis' key map; ints/slices pass through;
        sequences resolve elementwise (mixed labels and ints allowed)."""
        if k is Ellipsis:
            raise NotImplementedError(
                "Ellipsis indexing is not supported for LabeledTensors")
        if isinstance(k, str):
            return self.dim_key_map[axis][k]
        if is_sequence(k):
            return [self._resolve(axis, e) for e in k]
        return k

    def parse_key(self, key):
        axes = list(key) if isinstance(key, tuple) else as_list(key)
        return tuple(self._resolve(i, k) for i, k in enumerate(axes))

    def __getitem__(self, key) -> np.ndarray:
        return self.data[self.parse_key(key)]

    def __setitem__(self, key, value):
        self.data[self.parse_key(key)] = value

    def to_table(self) -> "Table":
        """One row per key of the leading axes, one column per leading axis
        name and per key of the last axis."""
        df_dict = {dim: [] for dim in self.dim_names[:-1]}
        df_dict.update({dim: [] for dim in self.dim_keys[-1]})
        for keys in product(*self.dim_keys[:-1]):
            for dim, key in zip(self.dim_names[:-1], keys):
                df_dict[dim].append(key)
            values = np.atleast_1d(self[keys])
            for dim, value in zip(self.dim_keys[-1], values.tolist()):
                df_dict[dim].append(value)
        return Table(df_dict)

    def to_dataframe(self):
        return self.to_table().to_dataframe()

    def to_dict(self):
        nested = 0
        for keys in reversed(self.dim_keys):
            nested = {key: copy.deepcopy(nested) for key in keys}
        for key in product(*self.dim_keys):
            value = float(self[key])
            d = nested
            for k in key[:-1]:
                d = d[k]
            d[key[-1]] = value
        return nested

    def compute_summary_stats(self, summary_stats_to_output) -> "LabeledTensor":
        summary = LabeledTensor(dim_names=["summary_stat", *self.dim_names[1:]],
                                dim_keys=[list(summary_stats_to_output), *self.dim_keys[1:]])
        funcs = self.get_summary_stat_funcs()
        for keys in product(*self.dim_keys[1:]):
            values = self[(slice(None), *keys)]
            for stat_name in summary_stats_to_output:
                summary[(stat_name, *keys)] = float(funcs[stat_name](values))
        return summary

    @staticmethod
    def fix_tensor(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        x = x[np.isfinite(x)]
        if x.shape[0] == 0:
            return np.array([0.0])
        return x

    @staticmethod
    def get_summary_stat_funcs(axis: int = 0):
        fix = LabeledTensor.fix_tensor

        def mode(x):
            # torch.mode: most frequent value, smallest on ties
            values, counts = np.unique(fix(x), return_counts=True)
            return values[np.argmax(counts)]

        return {
            "mean": lambda x: np.mean(fix(x), axis=axis),
            "median": lambda x: _torch_median(fix(x)),
            "mode": mode,
            "std": lambda x: np.std(fix(x), axis=axis, ddof=1) if fix(x).size > 1 else 0.0,
            "min": lambda x: np.min(fix(x), axis=axis),
            "max": lambda x: np.max(fix(x), axis=axis),
        }


def _torch_median(x: np.ndarray):
    """torch.median returns the lower middle element for even sizes."""
    x = np.sort(x)
    return x[(x.shape[0] - 1) // 2]


class Table:
    """Column-oriented rows: ``table[column]`` is a numpy array, ``len(table)``
    the number of rows; ``records()`` gives the rows as dicts and
    ``to_dataframe()`` the pandas DataFrame (pandas imported there)."""

    def __init__(self, columns):
        self.columns = {name: list(values) for name, values in columns.items()}

    def __getitem__(self, column) -> np.ndarray:
        return np.asarray(self.columns[column])

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()), []))

    def records(self):
        names = list(self.columns)
        return [dict(zip(names, row)) for row in zip(*self.columns.values())]

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame(self.columns)
