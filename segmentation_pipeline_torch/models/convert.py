"""Weight bridge between a flax variables tree and the port's state dict.

The flax tree is nested dicts of arrays (numpy, or anything ``np.asarray``
takes), laid out as the JAX package's modules create it:

    params/<module path>/kernel        (kw, kh, kd, Cin, Cout)
    params/<module path>/bias
    params/<module path>/scale         (BatchNorm)
    batch_stats/<module path>/mean
    batch_stats/<module path>/var

The port's modules carry the same names, so a path maps to a state-dict key
by joining it with dots. Conv kernels become torch's (Cout, Cin, kw, kh, kd);
BatchNorm ``scale/bias/mean/var`` become ``weight/bias/running_mean/
running_var``. Both directions copy values exactly.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A flax variables tree -> the port's state dict (CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for collection, names in (("params", _PARAM_NAMES), ("batch_stats", _STAT_NAMES)):
        for path, value in _leaves(variables.get(collection, {})):
            *module, leaf = path
            if leaf not in names:
                raise KeyError(f"unexpected flax leaf {collection}/{'/'.join(path)}")
            array = np.array(value)
            if leaf == "kernel":
                array = array.transpose(4, 3, 0, 1, 2)
            out[".".join(module + [names[leaf]])] = torch.from_numpy(
                np.ascontiguousarray(array))
            if leaf == "mean":
                out[".".join(module + ["num_batches_tracked"])] = torch.tensor(0)
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> a flax variables tree of numpy arrays."""
    variables: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        *module, leaf = key.split(".")
        array = tensor.detach().cpu().numpy()
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            collection, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight":
            collection = "params"
            name = "kernel" if array.ndim == 5 else "scale"
            if array.ndim == 5:
                array = np.ascontiguousarray(array.transpose(2, 3, 4, 1, 0))
        elif leaf == "bias":
            collection, name = "params", "bias"
        else:
            raise KeyError(f"unexpected state-dict key {key}")
        node = variables[collection]
        for part in module:
            node = node.setdefault(part, {})
        node[name] = array
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    return variables
