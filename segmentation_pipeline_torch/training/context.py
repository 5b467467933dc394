"""Context: declarative component registry and config-as-checkpoint.

Ported from segmentation_pipeline_tpu/training/context.py. An experiment is
a list of (name, constructor, params) definitions; ``init_components`` builds
them in order (a ``Ref`` param names an earlier component, ``$VAR`` strings
expand from the ``variables`` dict and the environment) and a checkpoint is
that list pickled with each component's state. Constructors pickle by
import path; a param that stdlib pickle refuses (a function defined inside
a config) is stored as cloudpickle bytes, and cloudpickle is imported only
then.

A component that is an ``nn.Module`` is wrapped in ``SegModel`` on the
context's device (``None`` means the card). A context loaded from a file
also puts the predictors among its components' params on its own device,
wherever the checkpoint was written. A mesh among the params
(parallel/mesh.py) is stored as its ``MeshRecipe`` and rebuilt on load over
the loading process's process group, on the context's device. ``snapshot``
takes host copies, as numpy, of every component's state: the model's
tensors, the torch optimizer's moments and the trainer's counters all
change in place while training goes on, and a checkpoint written later from
the snapshot must hold the state of its own iteration. Numpy states also
load where there is no GPU.
"""
from __future__ import annotations

import inspect
import os
import pickle
import warnings
from datetime import datetime
from pathlib import Path
from pprint import pformat
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..parallel.mesh import Mesh, MeshRecipe
from .model import SegModel


class Ref:
    """Explicit reference to another component, resolved at init."""

    def __init__(self, name: str, attribute: Optional[str] = None):
        self.name = name
        self.attribute = attribute

    def __repr__(self):
        suffix = f".{self.attribute}" if self.attribute else ""
        return f"Ref({self.name}{suffix})"


class _FunctionPayload:
    """Tagged cloudpickle payload for params stdlib pickle can't handle."""

    def __init__(self, data: bytes):
        self.data = data

    def load(self):
        import cloudpickle

        return cloudpickle.loads(self.data)

    @staticmethod
    def wrap(value):
        import cloudpickle

        return _FunctionPayload(cloudpickle.dumps(value))


def _make_picklable(value):
    if isinstance(value, Mesh):
        return MeshRecipe.of(value)
    if isinstance(value, dict):
        return {k: _make_picklable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        out = [_make_picklable(v) for v in value]
        return type(value)(out) if isinstance(value, tuple) else out
    try:
        pickle.dumps(value)
        return value
    except Exception:
        return _FunctionPayload.wrap(value)


def _restore(value, device=None):
    """Params as a checkpoint stored them -> live objects: closures loaded,
    mesh recipes built (on ``device``, default: this rank's card)."""
    if isinstance(value, _FunctionPayload):
        return value.load()
    if isinstance(value, MeshRecipe):
        return value.build(device)
    if isinstance(value, dict):
        return {k: _restore(v, device) for k, v in value.items()}
    if isinstance(value, list):
        return [_restore(v, device) for v in value]
    if isinstance(value, tuple):
        return tuple(_restore(v, device) for v in value)
    return value


def to_host(value):
    """A copy of ``value`` with every tensor replaced by a numpy array that
    shares no memory with it (on the CPU ``Tensor.numpy()`` would)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True).numpy()
    if isinstance(value, dict):
        return {k: to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_host(v) for v in value)
    return value


def list_checkpoint_files(path):
    """The checkpoint files in a folder, sorted (or the path itself when it
    is a file)."""
    path = Path(path)
    if not path.is_dir():
        return [path]
    return sorted(p for p in path.iterdir() if p.is_file())


class Context:
    """Entity-component system for experiments.

    Usage:
        >>> context = Context(name="dmri-hippo", variables={"DATASET_PATH": ...})
        >>> context.add_component("dataset", SubjectFolder, root="$DATASET_PATH", ...)
        >>> context.add_component("model", NestedResUNet, input_channels=3, ...)
        >>> context.add_component("optimizer", Adam, lr=2e-4)
        >>> context.init_components()
        >>> context.trainer.train(context, ...)
    """

    def __init__(self, device=None, name: str = None, file_path=None,
                 variables: Dict[str, str] = None, metadata: Dict[str, Any] = None):
        assert (name is None) != (file_path is None), (
            "Either provide a name to create a new context, or a file_path to "
            "load an existing context, but not both.")
        self.device = device
        self.name = name
        self.variables = {} if variables is None else dict(variables)
        self.metadata = {} if metadata is None else metadata
        self.creation_time = datetime.now().strftime("%y%m%d-%H%M%S")
        self.component_definitions = []
        self.file_paths = []
        self.config = {}

        if file_path is not None:
            with open(file_path, "rb") as f:
                checkpoint = pickle.load(f)
            self.name = checkpoint["name"]
            self.component_definitions = checkpoint["component_definitions"]
            self.creation_time = checkpoint["creation_time"]
            self.config = checkpoint.get("config", {})
            for var, value in checkpoint["variables"].items():
                if var not in self.variables and var not in os.environ:
                    warnings.warn(
                        f"Environment variable ${var} was defined as an input to this "
                        f"context but is not set; the previously used value {value!r} "
                        f"will be used instead.")
            # checkpoint variables are fallbacks only: explicit user
            # variables win, then values already in the OS environment
            merged = dict(checkpoint["variables"])
            merged.update({k: v for k, v in os.environ.items() if k in merged})
            merged.update(self.variables)
            self.variables = merged
            self.file_paths = checkpoint["file_paths"]
            self.metadata = checkpoint["metadata"]

        os.environ.update({k: str(v) for k, v in self.variables.items()})
        self.from_file = file_path is not None
        self.loaded = False

    # ---- definition management ----------------------------------------
    def add_component(self, name: str, constructor, **params):
        self._enforce_not_loaded()
        definition = dict(name=name, constructor=constructor, params=params)
        self.component_definitions.append(definition)
        try:
            self.file_paths.append(inspect.getsourcefile(constructor))
        except TypeError:
            pass

    def update_component(self, name: str, constructor=None, **params):
        self._enforce_not_loaded()
        defn = self.get_component_definition(name)
        if constructor is not None:
            defn["constructor"] = constructor
        defn["params"].update(params)

    def get_component_definition(self, name: str) -> dict:
        for defn in self.component_definitions:
            if defn["name"] == name:
                return defn
        raise ValueError(f"Could not find component {name} in the context.")

    def keep_components(self, names):
        self._enforce_not_loaded()
        self.component_definitions = [
            d for d in self.component_definitions if d["name"] in names]

    def remove_components(self, names):
        self._enforce_not_loaded()
        self.component_definitions = [
            d for d in self.component_definitions if d["name"] not in names]

    def remove_component(self, name):
        self.remove_components([name])

    # ---- initialization ------------------------------------------------
    def init_components(self):
        self._enforce_not_loaded()
        for definition in self.component_definitions:
            self._init_component(definition)
        self.loaded = True

    def _init_component(self, definition):
        name = definition["name"]
        constructor = definition["constructor"]
        params = self._fix_params(_restore(definition["params"], self.device))
        if self.from_file:
            self._place_predictors(params.values())

        component = constructor(**params)
        # networks are wrapped into the runtime SegModel on the context's device
        if isinstance(component, nn.Module):
            component = SegModel(component, device=self.device)

        if "state_dict" in definition and hasattr(component, "load_state_dict"):
            component.load_state_dict(definition["state_dict"])

        self.__dict__[name] = component

    def _place_predictors(self, values):
        from ..device import resolve_device
        from ..prediction import Predictor

        for value in values:
            if isinstance(value, Predictor):
                value.device = resolve_device(self.device)
            elif isinstance(value, (list, tuple)):
                self._place_predictors(value)
            elif isinstance(value, dict):
                self._place_predictors(value.values())

    def _fix_params(self, params):
        if isinstance(params, dict):
            return {k: self._fix_params(v) for k, v in params.items()}
        if isinstance(params, list):
            return [self._fix_params(p) for p in params]
        if isinstance(params, tuple):
            return tuple(self._fix_params(p) for p in params)
        param = params
        if isinstance(param, Ref):
            component = self.__dict__[param.name]
            if param.attribute:
                component = getattr(component, param.attribute)
            return component
        if isinstance(param, str):
            expanded = os.path.expandvars(param)
            if "$" in expanded:
                warnings.warn(
                    f"Environment variable in argument {param!r} was not expanded; "
                    f"set it in the OS or pass it in the context variables dict.")
            return expanded
        return param

    # ---- checkpointing -------------------------------------------------
    def snapshot(self) -> dict:
        """The checkpoint payload with host copies of every component's
        state, taken now, so the caller may write it later or on another
        thread while training continues."""
        for definition in self.component_definitions:
            component = self.__dict__.get(definition["name"])
            if component is not None and hasattr(component, "state_dict"):
                definition["state_dict"] = to_host(component.state_dict())

        return dict(
            name=self.name,
            component_definitions=[
                {**d, "params": _make_picklable(d["params"])}
                for d in self.component_definitions
            ],
            creation_time=self.creation_time,
            variables=self.variables,
            file_paths=self.file_paths,
            metadata=self.metadata,
            config=self.config,
        )

    @staticmethod
    def write_snapshot(checkpoint: dict, filename):
        """Write to a temporary file in the same directory, fsync it and
        ``os.replace`` it over the target, so a crash or a concurrent reader
        never sees a truncated checkpoint."""
        tmp = str(filename) + ".tmp"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(checkpoint, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, filename)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def save(self, filename):
        self.write_snapshot(self.snapshot(), filename)

    def _enforce_not_loaded(self):
        if self.loaded:
            raise RuntimeError(
                "Modifying components after they are initialized is not supported.")

    # ---- config export -------------------------------------------------
    def get_config(self, component_names=None) -> dict:
        config = dict(self.config)
        definitions = self.component_definitions
        if component_names is not None:
            definitions = [d for d in definitions if d["name"] in component_names]
        for defn in definitions:
            for key, value in defn["params"].items():
                if isinstance(value, (int, float, str, bool, type(None))):
                    config[f"{defn['name']}.{key}"] = value
                elif isinstance(value, (list, tuple)) and all(
                        isinstance(v, (int, float, str, bool)) for v in value):
                    config[f"{defn['name']}.{key}"] = list(value)
                else:
                    config[f"{defn['name']}.{key}"] = repr(value)
        return config

    def __repr__(self):
        out = f"Context {self.name} created at {self.creation_time}\n"
        for i, definition in enumerate(self.component_definitions):
            filtered = {k: v for k, v in definition.items() if k != "state_dict"}
            out += f"\ncomponent_id={i}\n"
            out += f"component_definition={pformat(filtered, 4)}\n"
        return out


# the name the JAX package (and the library it was modelled on) also exports
TorchContext = Context
