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
- ``accumulate_steps=k > 1`` (optax.MultiSteps in the JAX package): the
  optimizer is wrapped in ``MultiSteps``, which averages the gradients of k
  micro-steps and steps the inner optimizer once.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Type

import torch


class MultiSteps:
    """Gradient accumulation with optax.MultiSteps' semantics (optax 0.2.6,
    ``transforms/_accumulation.py``, ``use_grad_mean=True``) around a torch
    optimizer:

    - each ``step()`` folds the parameters' ``.grad`` (None counts as zeros)
      into a running mean by Welford's update, ``acc + (g - acc) /
      (mini_step + 1)``;
    - on the k-th micro-step the inner optimizer steps once on that mean,
      with the parameters of that moment (their ``.grad`` then holds the
      mean it stepped on), and the mean is set back to zero;
      on the other micro-steps parameters and inner state do not move;
    - ``mini_step`` counts micro-steps modulo k, ``gradient_step`` the inner
      optimizer's steps.

    ``zero_grad``, ``param_groups``, ``state_dict`` and ``load_state_dict``
    act as a torch optimizer's, so the train step, the trainer and the
    Context's checkpoints take it in the inner optimizer's place; the state
    dict carries the counters and the accumulator beside the inner state."""

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int):
        self.optimizer = optimizer
        self.every_k = int(every_k)
        self.mini_step = 0
        self.gradient_step = 0
        self.acc_grads: List[torch.Tensor] = [torch.zeros_like(p) for p in self._params()]

    def _params(self) -> List[torch.nn.Parameter]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> bool:
        """Bank this micro-step's gradients; returns whether the inner
        optimizer stepped."""
        params = self._params()
        n = self.mini_step + 1
        for p, acc in zip(params, self.acc_grads):
            g = p.grad if p.grad is not None else torch.zeros_like(acc)
            acc.copy_(acc + (g - acc) / n)
        emit = self.mini_step == self.every_k - 1
        if emit:
            for p, acc in zip(params, self.acc_grads):
                p.grad = acc.clone()
            self.optimizer.step()
            for acc in self.acc_grads:
                acc.zero_()
            self.gradient_step += 1
        self.mini_step = n % self.every_k
        return emit

    def state_dict(self) -> Dict[str, Any]:
        return {"inner": self.optimizer.state_dict(), "mini_step": self.mini_step,
                "gradient_step": self.gradient_step, "acc_grads": list(self.acc_grads)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])
        with torch.no_grad():
            for acc, saved in zip(self.acc_grads, state["acc_grads"]):
                acc.copy_(torch.as_tensor(saved))

    def __repr__(self) -> str:
        return f"MultiSteps({self.optimizer!r}, every_k={self.every_k})"


class OptimizerFactory:
    """A torch optimizer class and its arguments, bound to parameters by
    ``init``; with ``accumulate_steps > 1`` the optimizer comes wrapped in
    ``MultiSteps``."""

    def __init__(self, optimizer_class: Type[torch.optim.Optimizer],
                 accumulate_steps: int = 1, **kwargs: Any):
        self.optimizer_class = optimizer_class
        self.accumulate_steps = int(accumulate_steps or 1)
        self.kwargs: Dict[str, Any] = kwargs

    def init(self, params: Iterable[torch.nn.Parameter]):
        optimizer = self.optimizer_class(list(params), **self.kwargs)
        if self.accumulate_steps > 1:
            return MultiSteps(optimizer, self.accumulate_steps)
        return optimizer

    def made(self, optimizer) -> bool:
        """Whether ``optimizer`` is of the kind ``init`` makes."""
        if self.accumulate_steps > 1:
            return isinstance(optimizer, MultiSteps) \
                and optimizer.every_k == self.accumulate_steps \
                and isinstance(optimizer.optimizer, self.optimizer_class)
        return isinstance(optimizer, self.optimizer_class)

    def __repr__(self) -> str:
        accumulate = (f", accumulate_steps={self.accumulate_steps}"
                      if self.accumulate_steps > 1 else "")
        return f"{type(self).__name__}({self.optimizer_class.__name__}, {self.kwargs}{accumulate})"


def Adam(lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0, decoupled: bool = False,
         accumulate_steps: int = 1, **_ignored) -> OptimizerFactory:
    """torch.optim.Adam semantics: weight_decay adds wd*param to the
    GRADIENT before the adaptive moments (L2-into-grad); decoupled=True
    gives AdamW."""
    cls = torch.optim.AdamW if weight_decay and decoupled else torch.optim.Adam
    return OptimizerFactory(cls, accumulate_steps, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay)


def SGD(lr: float = 1e-2, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0, accumulate_steps: int = 1,
        **_ignored) -> OptimizerFactory:
    # optax.sgd ignores nesterov without momentum (plain SGD steps); torch's
    # SGD rejects the pair
    return OptimizerFactory(torch.optim.SGD, accumulate_steps, lr=lr, momentum=momentum,
                            nesterov=nesterov and bool(momentum), weight_decay=weight_decay)
