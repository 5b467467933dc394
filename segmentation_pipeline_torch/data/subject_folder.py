"""Directory-of-subject-folders dataset with named cohorts, copied from
segmentation_pipeline_tpu/data/subject_folder.py: lazy per-subject loading,
deepcopy-then-transform on item access, named cohorts with per-cohort
transform pipelines, derived sub-datasets, the ref_img affine copy,
preloading and additional-data attachment. This is a host-side object:
device tensors first appear at the collate boundary.
"""
from __future__ import annotations

import copy
import os
from typing import Dict, List, Union

from ..core.subject import Image, Subject
from ..transforms.base import Transform
from ..transforms.spatial import CopyAffine
from .subject_filters import ComposeFilters, SubjectFilter
from .subject_loaders import SubjectLoader


class SubjectFolder:
    """A dataset rooted at ``root/subject_path`` where every child directory
    is one subject, populated by a SubjectLoader pipeline.

    Cohorts are named SubjectFilters; the active cohort selects both the
    subject subset and (when ``transforms`` is a dict with a matching key)
    the transform pipeline. The special cohort ``'all'`` pre-filters every
    subject at scan time.
    """

    def __init__(self, root: str, subject_path: str, subject_loader: SubjectLoader,
                 cohorts: Dict[str, SubjectFilter] = None,
                 transforms: Union[Transform, Dict[str, Transform]] = None,
                 ref_img=None):
        self.root = root
        self.subject_path = os.path.join(self.root, subject_path)
        self.subject_loader = subject_loader
        self.cohorts = {} if cohorts is None else cohorts
        self.transforms = transforms
        self.ref_img = ref_img

        self._preloaded = False
        self._pretransformed = False

        subjects = self._scan_subjects()
        if "all" in self.cohorts:
            subjects = self.cohorts["all"](subjects)

        self.active_cohort = "all"
        self.all_subjects: List[Subject] = []
        self.all_subjects_map: Dict[str, Subject] = {}
        self.subjects: List[Subject] = []
        self.subjects_map: Dict[str, Subject] = {}
        self.excluded_subjects: List[Subject] = []
        self.transform = None

        self.set_all_subjects(subjects)

    def _scan_subjects(self) -> List[Subject]:
        """Walk the subject directory, run the loader pipeline per folder,
        and keep only folders that produced at least one image."""
        subjects = []
        for subject_name in sorted(os.listdir(self.subject_path)):
            folder = os.path.join(self.subject_path, subject_name)
            if not os.path.isdir(folder):
                continue
            subject_data = dict(name=subject_name, folder=folder)
            self.subject_loader(subject_data)
            if not any(isinstance(v, Image) for v in subject_data.values()):
                continue
            subject = Subject(**subject_data)
            if self.ref_img:
                subject = CopyAffine(self.ref_img)(subject, record=False)
            subjects.append(subject)
        return subjects

    # ---- cohort / transform management ---------------------------------
    def set_all_subjects(self, subjects: List[Subject]):
        subjects.sort(key=lambda s: s["name"])
        self.all_subjects = subjects
        self.all_subjects_map = {s["name"]: s for s in subjects}
        # set_cohort refreshes the subject VIEW but also re-derives
        # self.transform from the transforms dict, which must not clobber a
        # transform installed explicitly via set_transform(Transform)
        transform = getattr(self, "transform", None)
        self.set_cohort(self.active_cohort)
        if transform is not None:
            self.transform = transform

    def set_subjects(self, subjects: List[Subject]):
        self.subjects = subjects
        self.subjects_map = {s["name"]: s for s in subjects}
        kept = {id(s) for s in subjects}
        self.excluded_subjects = [s for s in self.all_subjects if id(s) not in kept]

    def set_cohort(self, cohort: Union[str, SubjectFilter]):
        self.active_cohort = cohort
        if isinstance(cohort, SubjectFilter):
            self.set_transform("default")
            self.set_subjects(cohort(self.all_subjects))
            return
        if isinstance(cohort, str):
            self.set_transform(cohort)
            if cohort == "all" or cohort is None:
                self.set_subjects(self.all_subjects)
            elif cohort in self.cohorts:
                self.set_subjects(self.cohorts[cohort](self.all_subjects))
            else:
                raise ValueError(
                    f"Cohort name {cohort} is not defined in dataset cohorts: "
                    f"{self.cohorts}.")

    def set_transform(self, transform: Union[str, Transform]):
        if isinstance(transform, Transform):
            self.transform = transform
            return
        if not isinstance(transform, str):
            raise ValueError()
        if self.transforms is None:
            self.transform = None
        elif isinstance(self.transforms, Transform):
            self.transform = self.transforms
        elif isinstance(self.transforms, dict):
            self.transform = self.transforms.get(
                transform, self.transforms.get("default"))

    def get_cohort_dataset(self, cohort: Union[str, SubjectFilter]) -> "SubjectFolder":
        """Derive a new SubjectFolder restricted to a cohort; that cohort's
        transform becomes the default."""
        transforms = self.transforms
        if isinstance(cohort, str):
            subject_filter = self.cohorts[cohort]
            if isinstance(transforms, dict) and cohort in transforms:
                transforms = dict(transforms)
                transforms["default"] = transforms.pop(cohort)
        elif isinstance(cohort, SubjectFilter):
            subject_filter = cohort
        else:
            raise ValueError()

        cohorts = dict(self.cohorts)
        if "all" in cohorts:
            cohorts["all"] = ComposeFilters(cohorts["all"], subject_filter)
        else:
            cohorts["all"] = subject_filter

        return SubjectFolder(self.root, os.path.relpath(self.subject_path, self.root),
                             self.subject_loader, cohorts, transforms,
                             ref_img=self.ref_img)

    # ---- item access ----------------------------------------------------
    def __len__(self) -> int:
        return len(self.subjects)

    def __getitem__(self, idx) -> Subject:
        """Deepcopy -> lazy load -> transform: the stored
        subject stays pristine; the caller owns a transformed copy with a
        fresh history tape."""
        if isinstance(idx, int):
            subject = self.subjects[idx]
        elif isinstance(idx, str):
            subject = self.subjects_map[idx]
        else:
            raise ValueError(f"Subject index must be int or str, not {idx!r}")

        subject = copy.deepcopy(subject)
        if not self._preloaded:
            subject.load()
        if not self._pretransformed and self.transform is not None:
            subject = self.transform(subject)
        return subject

    def __contains__(self, item) -> bool:
        if isinstance(item, int):
            return item < len(self)
        if isinstance(item, str):
            return item in self.subjects_map
        if isinstance(item, Subject):
            return any(item is s for s in self.subjects)
        return False

    # ---- preloading -----------------------------------------------------
    def preload_subjects(self):
        """Load every image into RAM once; item access then skips disk."""
        if self._preloaded:
            return
        self._preloaded = True
        loaded = []
        for subject in self.all_subjects:
            subject = copy.deepcopy(subject)
            subject.load()
            loaded.append(subject)
        # set_all_subjects refreshes the cohort view itself (and preserves a
        # manually installed transform — see its comment)
        self.set_all_subjects(loaded)

    def preload_and_transform_subjects(self):
        """Additionally apply the active transform once; item access then
        reduces to a deepcopy (pair with on-device augmentation)."""
        if self._pretransformed:
            return
        self.preload_subjects()
        if self.transform is not None:
            self._pretransformed = True
            # transform ALL subjects, not just the active cohort — rebuilding
            # all_subjects from the cohort-filtered view would permanently
            # discard every excluded subject from the dataset.  Bind the
            # transform FIRST: set_all_subjects refreshes the view, and the
            # applied pipeline must be exactly the one installed now
            transform = self.transform
            self.set_all_subjects([transform(s) for s in self.all_subjects])

    def load_additional_data(self, path: str, subject_loader: SubjectLoader):
        """Attach extra per-subject data (e.g. saved predictions) to matching
        subjects in place."""
        for subject_name in sorted(os.listdir(path)):
            subject_data = dict(name=subject_name,
                                folder=os.path.join(path, subject_name))
            subject_loader(subject_data)
            del subject_data["name"]
            del subject_data["folder"]
            matched = next((s for s in self.subjects if s["name"] == subject_name),
                           None)
            if matched is not None:
                matched.update(subject_data)
