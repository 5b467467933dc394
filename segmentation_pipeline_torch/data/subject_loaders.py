"""Declarative subject ingestion: glob-pattern-driven loaders, copied from
segmentation_pipeline_tpu/data/subject_loaders.py (SubjectLoader,
AttributeLoader, ImageLoader, ComposeLoaders, TensorLoader), including
$SUBJECT_NAME expansion in glob patterns and the uniform caches, which are
not pickled. JSON attributes need only the standard library; CSV and XLSX
import pandas when they are read.
"""
from __future__ import annotations

import copy
import json
import os
from abc import ABC, abstractmethod
from glob import glob
from pathlib import Path
from typing import Callable, Sequence, Union

import numpy as np

from ..utils.misc import auto_str, vargs_or_sequence


def get_subject_file_paths(subject_data, glob_pattern):
    os.environ["SUBJECT_NAME"] = subject_data["name"]
    glob_pattern = os.path.expandvars(glob_pattern)
    path = os.path.join(subject_data["folder"], os.path.expandvars(glob_pattern))
    return sorted(glob(path))


class SubjectLoader(ABC):
    """Mutates a ``subject_data`` dict containing at least 'name' and 'folder'."""

    @abstractmethod
    def __call__(self, subject_data):
        raise NotImplementedError

    def __repr__(self):
        return auto_str(self)


class AttributeLoader(SubjectLoader):
    """Loads subject attributes from csv/xlsx/json.

    multi_subject: the file holds rows/keys for many subjects; pick this one.
    uniform: same file for all subjects -> cached.
    belongs_to: merge attributes into an existing dict-valued entry
    (e.g. an image's metadata).
    """

    def __init__(self, glob_pattern: str, multi_subject: bool = False,
                 uniform: bool = False, belongs_to: str = None):
        self.glob_pattern = glob_pattern
        self.multi_subject = multi_subject
        self.uniform = uniform
        self.belongs_to = belongs_to
        self.uniform_cache = {}

    def __call__(self, subject_data):
        for matching_file in get_subject_file_paths(subject_data, self.glob_pattern):
            data = self.load_file(matching_file)
            if self.multi_subject:
                if subject_data["name"] not in data:
                    continue
                data = data[subject_data["name"]]
            if self.belongs_to is not None:
                subject_data[self.belongs_to].update(data)
            else:
                subject_data.update(data)

    def load_file(self, file_path):
        if self.uniform and file_path in self.uniform_cache:
            return self.uniform_cache[file_path]

        extension = Path(file_path).suffix
        if extension == ".json":
            with open(file_path) as f:
                data = json.load(f)
        else:
            import pandas as pd

            if extension == ".xlsx":
                df = pd.read_excel(file_path, index_col=0)
            else:
                df = pd.read_csv(file_path, index_col=0)
            # row-oriented: {subject_name: {attr: value}} so the
            # multi_subject lookup by name works
            data = df.to_dict(orient="index")
            if not self.multi_subject:
                # single-subject table: one row of attributes
                data = next(iter(data.values())) if len(data) else {}

        if self.uniform:
            self.uniform_cache[file_path] = data
        return data

    def __getstate__(self):
        state = self.__dict__.copy()
        state["uniform_cache"] = {}
        return state


class ImageLoader(SubjectLoader):
    """Loads a ScalarImage/LabelMap via a glob pattern.

    Multiple matched files concatenate on the channel axis; extra kwargs
    (e.g. ``label_values``) become image metadata; uniform images are cached
    and deep-copied per subject.
    """

    def __init__(self, glob_pattern: str, image_name: str, image_constructor: Callable,
                 uniform: bool = False, **kwargs):
        self.image_name = image_name
        self.image_constructor = image_constructor
        self.glob_pattern = glob_pattern
        self.uniform = uniform
        self.kwargs = kwargs
        self.cached_image = None

    def __call__(self, subject_data):
        if self.uniform and self.cached_image is not None:
            subject_data[self.image_name] = copy.deepcopy(self.cached_image)
            return

        matching_files = get_subject_file_paths(subject_data, self.glob_pattern)
        if len(matching_files) == 0:
            return

        new_image = self.image_constructor(*matching_files, **self.kwargs)
        if self.uniform:
            self.cached_image = new_image
            new_image = copy.deepcopy(new_image)
        subject_data[self.image_name] = new_image

    def __getstate__(self):
        state = self.__dict__.copy()
        state["cached_image"] = None
        return state

    def __setstate__(self, state):
        state["cached_image"] = None
        self.__dict__.update(state)


class ComposeLoaders(SubjectLoader):
    """Applies loaders in order."""

    def __init__(self, *loaders: Union[SubjectLoader, Sequence[SubjectLoader]]):
        self.loaders = vargs_or_sequence(loaders)

    def __call__(self, subject_data):
        for loader in self.loaders:
            loader(subject_data)


class TensorLoader(SubjectLoader):
    """Loads a numeric array from a space-delimited text file (used for DWI
    gradient tables)."""

    def __init__(self, glob_pattern: str, tensor_name: str, uniform: bool = False,
                 belongs_to: str = None):
        self.glob_pattern = glob_pattern
        self.tensor_name = tensor_name
        self.uniform = uniform
        self.belongs_to = belongs_to
        self.uniform_cache = {}

    def __call__(self, subject_data):
        matching_files = get_subject_file_paths(subject_data, self.glob_pattern)
        if len(matching_files) > 1:
            raise RuntimeError(
                f"More than one {self.tensor_name} file matched {self.glob_pattern}")
        for matching_file in matching_files:
            data = self.load_file(matching_file)
            if self.belongs_to is not None:
                # the owner may be an Image (gradient table attached to the
                # DWI series) whose metadata is set item-by-item, or a plain
                # subject-data dict
                target = subject_data[self.belongs_to]
                for key, value in data.items():
                    target[key] = value
            else:
                subject_data.update(data)

    def load_file(self, file_path):
        if self.uniform and file_path in self.uniform_cache:
            return self.uniform_cache[file_path]
        # default whitespace splitting (not delimiter=" ") so gradient tables
        # with repeated spaces/tabs/trailing whitespace — typical FSL
        # bvec/bval output — load; a strict single-space delimiter chokes on
        # the empty fields
        data = {self.tensor_name: np.loadtxt(file_path)}
        if self.uniform:
            self.uniform_cache[file_path] = data
        return data

    def __getstate__(self):
        state = self.__dict__.copy()
        state["uniform_cache"] = {}
        return state
