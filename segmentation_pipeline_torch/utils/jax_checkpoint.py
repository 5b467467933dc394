"""Convert a checkpoint written by the JAX package (segmentation_pipeline_tpu)
into one that the port's ``Context(file_path=...)`` loads, without JAX.

    convert_jax_checkpoint("fold0.ckpt", "fold0-torch.ckpt")
    python -m segmentation_pipeline_torch.utils.jax_checkpoint src dst

``src`` and ``dst`` may also be folders: every checkpoint file of ``src``
is converted into ``dst`` under its own name.

A JAX checkpoint is a pickle of the context's component definitions, each
with its constructor, its params and its state. An ``Unpickler`` maps what
it names onto the port:

- ``segmentation_pipeline_tpu.<module>.<name>`` and ``research.<module>.<name>``
  onto the same names under ``segmentation_pipeline_torch`` (and its
  ``research``); instances are restored by ``__dict__``. The attributes the
  JAX objects carry and the port's do not (``_JAX_ONLY``) are dropped when
  they hold the one value the port implements, and raise naming the ROADMAP
  item that brings any other; the predictors get the port's ``device``.
- optax's state classes onto plain containers with the same fields; the
  model's flax variables go through ``models/convert.py``, Adam's
  ``mu``/``nu``/``count`` become ``torch.optim.Adam``'s ``exp_avg``/
  ``exp_avg_sq``/``step`` and SGD's momentum trace its ``momentum_buffer``;
  a ``MultiStepsState`` (gradient accumulation) becomes the state of the
  port's ``MultiSteps``: its counters, its accumulated gradients and the
  inner optimizer's state converted as above.
- closures that the JAX context stored as cloudpickle bytes are read with
  the same mapping and stored again.

Anything that cannot be read without JAX (a class of jax, flax or orbax, a
closure over one of them) raises ``JaxCheckpointError`` naming it.
"""
from __future__ import annotations

import argparse
import importlib
import io
import pickle
from collections import namedtuple
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..models.convert import flax_to_state_dict
from ..prediction import PatchPredict, StandardPredict
from ..training.context import Context, _FunctionPayload, _restore, list_checkpoint_files
from ..training.optimizers import MultiSteps
from ..training.trainer import SegmentationTrainer, _not_ported

JAX_PACKAGE = "segmentation_pipeline_tpu"
PORT_PACKAGE = "segmentation_pipeline_torch"
JAX_ONLY_MODULES = ("jax", "jaxlib", "flax", "orbax", "chex")

# modules that the port does not have yet, with their ROADMAP item
NOT_PORTED_MODULES = {
    "segmentation_pipeline_tpu.parallel": "item 10 (multi-device)",
}

# optax's state classes by name, with their fields
OPTAX_STATES = {"ScaleByAdamState": ("count", "mu", "nu"), "TraceState": ("trace",),
                "EmptyState": (),
                "MultiStepsState": ("mini_step", "gradient_step", "inner_opt_state",
                                    "acc_grads", "skip_state")}

# attributes of JAX objects that the port's objects lack, by class name:
# the value the port implements, and the ROADMAP item that brings others
_PROCESSES = (False, "item 7-rem (process workers)")
_JAX_ONLY = {
    "StandardDataLoader": {"use_processes": _PROCESSES},
    "PatchDataLoader": {"use_processes": _PROCESSES},
    "PatchPredict": {"mesh": (None, "item 10 (multi-device)"),
                     "volume_sharded": (False, "item 10 (multi-device)")},
}
# run-time caches of the JAX objects, dropped whatever they hold
_JAX_CACHES = {"StandardPredict": ("_confusion_plan",)}


class JaxCheckpointError(RuntimeError):
    """The checkpoint holds something that cannot be read without JAX."""


_state_classes = {}


def _optax_state(name):
    if name not in OPTAX_STATES:
        raise JaxCheckpointError(f"the checkpoint's optimizer state holds optax's {name}, "
                                 "which the port cannot convert")
    if name not in _state_classes:
        _state_classes[name] = namedtuple(name, OPTAX_STATES[name])
    return _state_classes[name]


def _port_module(module: str) -> str:
    """The port's module for a module of the JAX package or of research/."""
    for prefix, item in NOT_PORTED_MODULES.items():
        if module == prefix or module.startswith(prefix + "."):
            raise _not_ported(f"{module} (pickled in the checkpoint)", item)
    if module.split(".")[0] in JAX_ONLY_MODULES:
        raise JaxCheckpointError(f"the checkpoint pickles the module {module}, which cannot "
                                 "be read without JAX")
    if module == JAX_PACKAGE or module.startswith(JAX_PACKAGE + "."):
        return PORT_PACKAGE + module[len(JAX_PACKAGE):]
    if module == "research" or module.startswith("research."):
        return f"{PORT_PACKAGE}.{module}"
    return module


def _port_object(module: str, name: str):
    port_module = _port_module(module)
    if port_module == module:
        return None
    try:
        return getattr(importlib.import_module(port_module), name)
    except (ModuleNotFoundError, AttributeError):
        raise JaxCheckpointError(f"the checkpoint pickles {module}.{name}, which has no "
                                 f"counterpart in {PORT_PACKAGE}") from None


def _subimport(name):
    return importlib.import_module(_port_module(name))


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "optax":
            return _optax_state(name)
        if module.split(".")[0] == "cloudpickle" and name == "subimport":
            return _subimport
        obj = _port_object(module, name)
        if obj is not None:
            return obj
        return super().find_class(module, name)


def _load(data: bytes):
    return _Unpickler(io.BytesIO(data)).load()


def _objects(value, seen):
    """Every instance of a port class reachable from ``value``."""
    if id(value) in seen:
        return
    seen.add(id(value))
    if isinstance(value, dict):
        for v in value.values():
            yield from _objects(v, seen)
    elif isinstance(value, (list, tuple, set)):
        for v in value:
            yield from _objects(v, seen)
    elif type(value).__module__.startswith(PORT_PACKAGE) and hasattr(value, "__dict__") \
            and not isinstance(value, type):
        yield value
        yield from _objects(vars(value), seen)


def _fix_objects(params):
    """Bring restored objects to the port's attributes, in place."""
    for obj in list(_objects(params, set())):
        if isinstance(obj, _FunctionPayload):
            obj.data = _convert_payload(obj.data)
            continue
        cls = type(obj).__name__
        state = vars(obj)
        for attr in _JAX_CACHES.get(cls, ()):
            state.pop(attr, None)
        for attr, (value, item) in _JAX_ONLY.get(cls, {}).items():
            if attr in state and state.pop(attr) != value:
                raise _not_ported(f"{cls}({attr}=...) other than {value!r}", item)
        if isinstance(obj, (StandardPredict, PatchPredict)):
            obj.device = torch.device("cuda")


def _convert_payload(data: bytes) -> bytes:
    """A closure the JAX context stored as cloudpickle bytes, read with the
    port's names and stored again."""
    import cloudpickle

    return cloudpickle.dumps(_load(data))


def _module_of(definitions):
    """The model's module, built on the CPU from its definition."""
    for definition in definitions:
        constructor = definition["constructor"]
        if isinstance(constructor, type) and issubclass(constructor, nn.Module):
            return constructor(**_restore(definition["params"]))
    return None


def _find_states(opt_state):
    """The optax states with fields in a (nested) chain state."""
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        for state in opt_state:
            yield from _find_states(state)
    elif getattr(opt_state, "_fields", ()):
        yield opt_state


def _per_parameter(tree, names):
    """A flax params tree -> numpy arrays in the order of ``names``."""
    arrays = flax_to_state_dict({"params": tree})
    return [arrays[name].numpy() for name in names]


def _torch_optimizer_state(opt_state, definitions):
    """optax's Adam or SGD state, plain or inside a MultiStepsState -> the
    state dict (numpy) of the torch optimizer, or of the port's MultiSteps
    around it, that the definitions' optimizer factory makes for the
    model."""
    module = _module_of(definitions)
    factory = next((d for d in definitions if d["name"] == "optimizer"), None)
    if module is None or factory is None:
        raise JaxCheckpointError("the checkpoint's optimizer state has no model or optimizer "
                                 "definition beside it")
    optimizer = factory["constructor"](**_restore(factory["params"])).init(module.parameters())
    names = [name for name, _ in module.named_parameters()]
    if type(opt_state).__name__ == "MultiStepsState":
        if not isinstance(optimizer, MultiSteps):
            raise JaxCheckpointError("the checkpoint accumulates gradients (MultiStepsState) "
                                     "but its optimizer definition does not")
        return {"inner": _inner_state(opt_state.inner_opt_state, optimizer.optimizer, names),
                "mini_step": int(opt_state.mini_step),
                "gradient_step": int(opt_state.gradient_step),
                "acc_grads": _per_parameter(opt_state.acc_grads, names)}
    if isinstance(optimizer, MultiSteps):
        raise JaxCheckpointError("the optimizer definition accumulates gradients but the "
                                 "checkpoint's state is not a MultiStepsState")
    return _inner_state(opt_state, optimizer, names)


def _inner_state(opt_state, optimizer, names):
    """optax's Adam or SGD chain state -> ``optimizer``'s state dict (numpy)."""
    state = {}
    for found in _find_states(opt_state):
        if type(found).__name__ == "ScaleByAdamState":
            if int(found.count) == 0:
                continue
            for i, (mu, nu) in enumerate(zip(_per_parameter(found.mu, names),
                                             _per_parameter(found.nu, names))):
                state.setdefault(i, {}).update(
                    step=np.array(float(found.count), np.float32), exp_avg=mu, exp_avg_sq=nu)
        elif type(found).__name__ == "TraceState":
            for i, trace in enumerate(_per_parameter(found.trace, names)):
                state.setdefault(i, {})["momentum_buffer"] = trace
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def convert_checkpoint_data(data: bytes) -> dict:
    """A JAX checkpoint's bytes -> the port's checkpoint payload."""
    checkpoint = _load(data)
    if checkpoint.get("array_storage") == "orbax":
        raise _not_ported("array_storage='orbax' checkpoints", "item 8-rem")
    definitions = checkpoint["component_definitions"]
    for definition in definitions:
        _fix_objects(definition["params"])
    for definition in definitions:
        state = definition.get("state_dict")
        constructor = definition["constructor"]
        if not state:
            continue
        if isinstance(constructor, type) and issubclass(constructor, nn.Module):
            definition["state_dict"] = {k: v.numpy() for k, v in flax_to_state_dict(state).items()}
        elif constructor is SegmentationTrainer and "opt_state" in state:
            state["opt_state"] = _torch_optimizer_state(state["opt_state"], definitions)
    return checkpoint


def convert_jax_checkpoint(src, dst):
    """Convert the JAX checkpoint ``src`` into the port's at ``dst``; with a
    folder ``src``, each of its checkpoint files into the folder ``dst``.
    Returns the written paths."""
    src, dst = Path(src), Path(dst)
    if src.is_dir():
        dst.mkdir(parents=True, exist_ok=True)
        return [convert_jax_checkpoint(path, dst / path.name)[0]
                for path in list_checkpoint_files(src)]
    Context.write_snapshot(convert_checkpoint_data(src.read_bytes()), dst)
    return [dst]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("src", help="a JAX checkpoint file, or a folder of them")
    parser.add_argument("dst", help="the port's checkpoint file, or a folder for them")
    args = parser.parse_args(argv)
    for path in convert_jax_checkpoint(args.src, args.dst):
        print(path)


if __name__ == "__main__":
    main()
