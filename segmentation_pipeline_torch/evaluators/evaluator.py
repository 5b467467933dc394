"""Evaluator ABC, copied from segmentation_pipeline_tpu/evaluators/evaluator.py:
callable on a sequence of Subjects returning a dict of results."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Sequence

from ..core.subject import Subject


class Evaluator(ABC):
    @abstractmethod
    def __call__(self, subjects: Sequence[Subject]) -> dict:
        ...
