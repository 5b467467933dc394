"""Boolean algebra over subject lists: cohort definition & CV splits, copied
from segmentation_pipeline_tpu/data/subject_filters.py. StratifiedFilter
imports pandas and scikit-learn when it runs.
"""
from __future__ import annotations

from random import Random
from typing import Any, Dict, Sequence, Union

from ..core.subject import Subject
from ..utils.misc import as_list, as_set, auto_str, is_sequence, random_folds, vargs_or_sequence


class SubjectFilter:
    """Callable over a sequence of Subjects returning the kept subset.

    Per-subject implementations override ``subject_filter``; split-style
    implementations override ``apply_filter``.
    """

    def __call__(self, *subjects: Union[Subject, Sequence[Subject]]):
        subjects = vargs_or_sequence(subjects)
        if is_sequence(subjects) and all(isinstance(s, Subject) for s in subjects):
            return self.apply_filter(subjects)
        raise ValueError(
            f"A SubjectFilter can only be applied to a sequence of Subjects, not {subjects}")

    def apply_filter(self, subjects: Sequence[Subject]):
        return list(filter(self.subject_filter, subjects))

    def subject_filter(self, subject: Subject) -> bool:
        raise NotImplementedError

    def __sub__(self, other):
        return ComposeFilters(self, NegateFilter(other))

    def __neg__(self):
        return NegateFilter(self)

    def __invert__(self):
        return NegateFilter(self)

    def __repr__(self):
        return auto_str(self)


class RequireAttributes(SubjectFilter):
    """Keep subjects that have required attribute keys (list form) or
    required values (dict form; membership via set intersection)."""

    def __init__(self, attributes: Union[Sequence[str], Dict[str, Any]]):
        self.attributes = attributes

    def subject_filter(self, subject):
        if isinstance(self.attributes, (list, tuple)):
            return all(attr in subject for attr in self.attributes)
        if isinstance(self.attributes, dict):
            if any(attr not in subject for attr in self.attributes.keys()):
                return False
            return all(
                not as_set(value).isdisjoint(as_set(subject.get(name)))
                for name, value in self.attributes.items()
            )
        raise ValueError(f"Bad attributes spec {self.attributes!r}")


class ForbidAttributes(SubjectFilter):
    """Drop subjects that have forbidden keys (list form) or forbidden values
    (dict form — the keys themselves are allowed)."""

    def __init__(self, attributes: Union[Sequence[str], Dict[str, Any]]):
        self.attributes = attributes

    def subject_filter(self, subject):
        if isinstance(self.attributes, (list, tuple)):
            return not any(attr in subject for attr in self.attributes)
        if isinstance(self.attributes, dict):
            present = {k: v for k, v in self.attributes.items() if k in subject}
            return all(
                as_set(value).isdisjoint(as_set(subject.get(name)))
                for name, value in present.items()
            )
        raise ValueError(f"Bad attributes spec {self.attributes!r}")


class ComposeFilters(SubjectFilter):
    """Logical AND."""

    def __init__(self, *filters):
        self.filters = vargs_or_sequence(filters)

    def apply_filter(self, subjects):
        for f in self.filters:
            subjects = f(subjects)
        return subjects


class AnyFilter(SubjectFilter):
    """Logical OR."""

    def __init__(self, *filters):
        self.filters = vargs_or_sequence(filters)

    def apply_filter(self, subjects):
        if len(self.filters) == 0:
            return subjects
        groups = [f(subjects) for f in self.filters]
        kept_ids = {id(s) for group in groups for s in group}
        return [s for s in subjects if id(s) in kept_ids]


class NegateFilter(SubjectFilter):
    """Logical NOT."""

    def __init__(self, filter: SubjectFilter):
        self.filter = filter

    def apply_filter(self, subjects):
        removed = {id(s) for s in self.filter(subjects)}
        return [s for s in subjects if id(s) not in removed]


class RandomSelectFilter(SubjectFilter):
    """Deterministic random subset of N subjects."""

    def __init__(self, num_subjects: int, seed: int = 0):
        self.num_subjects = num_subjects
        self.seed = seed

    def apply_filter(self, subjects):
        ids = list(range(len(subjects)))
        Random(self.seed).shuffle(ids)
        keep = set(ids[: self.num_subjects])
        return [s for i, s in enumerate(subjects) if i in keep]


class RandomFoldFilter(SubjectFilter):
    """Assigns a 'fold' attribute once (deterministic), then selects folds
   ."""

    def __init__(self, num_folds: int, selection: Union[int, Sequence[int]], seed: int = 0):
        self.num_folds = num_folds
        self.selection = as_list(selection)
        self.seed = seed
        assert all(0 <= sel < self.num_folds for sel in self.selection)

    def apply_filter(self, subjects):
        folds_assigned = any("fold" in s for s in subjects)
        if not folds_assigned:
            fold_ids = random_folds(len(subjects), self.num_folds, self.seed)
            for subject, fold in zip(subjects, fold_ids):
                subject["fold"] = fold
        return [s for s in subjects if "fold" in s and s["fold"] in self.selection]


class StratifiedFilter(SubjectFilter):
    """Stratified sample of ``size`` subjects; continuous attributes are
    quantile-binned first (sklearn-backed)."""

    def __init__(self, size: int, continuous_attributes: Sequence[str],
                 discrete_attributes: Sequence[str], n_continuous_bins: int = 10,
                 seed: int = 0):
        self.size = size
        self.continuous_attributes = list(continuous_attributes)
        self.discrete_attributes = list(discrete_attributes)
        self.n_continuous_bins = n_continuous_bins
        self.seed = seed

    def apply_filter(self, subjects):
        import pandas as pd
        from sklearn.model_selection import train_test_split
        from sklearn.preprocessing import KBinsDiscretizer

        split_attributes = self.continuous_attributes + self.discrete_attributes
        rows = []
        for subject in subjects:
            row = {"name": subject["name"]}
            for attribute in split_attributes:
                row[attribute] = subject[attribute]
            rows.append(row)
        df = pd.DataFrame(rows)

        for attr in self.continuous_attributes:
            discretizer = KBinsDiscretizer(
                n_bins=self.n_continuous_bins, encode="ordinal", strategy="quantile")
            df[attr] = discretizer.fit_transform(
                df[attr].to_numpy().reshape(-1, 1)).reshape(-1)

        _, selected = train_test_split(
            subjects, test_size=self.size, stratify=df[split_attributes],
            random_state=self.seed)
        return selected
