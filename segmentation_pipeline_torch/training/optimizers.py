"""Optimizer factories with torch-style names and arguments.

Ported from segmentation_pipeline_tpu/training/optimizers.py, whose factories
build optax transformations. Here a factory is made before the parameters
exist, as there, and its ``init(params)`` (optax's name) makes the
``torch.optim`` optimizer over them:

- ``Adam``: L2 weight decay added to the gradient before the moments =
  ``torch.optim.Adam(weight_decay=...)``; ``decoupled=True`` =
  ``torch.optim.AdamW`` (optax.adamw).
- ``SGD``: momentum and Nesterov = ``torch.optim.SGD``, with weight decay
  added to the gradient before the momentum, as the optax chain does.

Gradient accumulation (``accumulate_steps > 1``, optax.MultiSteps in the JAX
package) is not ported yet and raises.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Type

import torch


class OptimizerFactory:
    """A torch optimizer class and its arguments, bound to parameters by
    ``init``."""

    def __init__(self, optimizer_class: Type[torch.optim.Optimizer], **kwargs: Any):
        self.optimizer_class = optimizer_class
        self.kwargs: Dict[str, Any] = kwargs

    def init(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        return self.optimizer_class(list(params), **self.kwargs)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.optimizer_class.__name__}, {self.kwargs})"


def _no_accumulation(accumulate_steps: int) -> None:
    if accumulate_steps and accumulate_steps > 1:
        raise NotImplementedError("accumulate_steps > 1 (gradient accumulation) is not "
                                  "ported yet")


def Adam(lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0, decoupled: bool = False,
         accumulate_steps: int = 1, **_ignored) -> OptimizerFactory:
    """torch.optim.Adam semantics: weight_decay adds wd*param to the
    GRADIENT before the adaptive moments (L2-into-grad); decoupled=True
    gives AdamW."""
    _no_accumulation(accumulate_steps)
    cls = torch.optim.AdamW if weight_decay and decoupled else torch.optim.Adam
    return OptimizerFactory(cls, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay)


def SGD(lr: float = 1e-2, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0, accumulate_steps: int = 1,
        **_ignored) -> OptimizerFactory:
    _no_accumulation(accumulate_steps)
    # optax.sgd ignores nesterov without momentum (plain SGD steps); torch's
    # SGD rejects the pair
    return OptimizerFactory(torch.optim.SGD, lr=lr, momentum=momentum,
                            nesterov=nesterov and bool(momentum), weight_decay=weight_decay)
