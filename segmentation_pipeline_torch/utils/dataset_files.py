"""Dataset staging for cluster runs, copied from
segmentation_pipeline_tpu/utils/dataset_files.py: if the dataset path is a
tar archive, extract it to a work directory (SLURM scratch);
if it is a directory and a work path is given, copy it there; otherwise use
in place.
"""
from __future__ import annotations

import posixpath
import shutil
import tarfile
from pathlib import Path


def prepare_dataset_files(dataset_path, work_path=None) -> Path:
    dataset_path = Path(dataset_path)
    if dataset_path.is_dir():
        if work_path is None:
            return dataset_path
        work_path = Path(work_path)
        target = work_path / dataset_path.name
        if not target.exists():
            work_path.mkdir(parents=True, exist_ok=True)
            shutil.copytree(dataset_path, target)
        return target

    if dataset_path.suffixes[-1:] == [".tar"] or dataset_path.name.endswith(
            (".tar.gz", ".tgz")):
        work_path = Path(work_path) if work_path else dataset_path.parent
        # derive the target from the archive's actual top-level entries, not
        # from the file name (a 'data.v2.tar.gz' extracting 'data.v2/' — or a
        # flat-rooted tar — would otherwise return a path that never exists
        # and re-extract on every run)
        with tarfile.open(dataset_path) as tar:
            roots = set()
            for n in tar.getnames():
                # normalize first: GNU tar's `tar -C dir .` produces
                # './'-rooted member names that must resolve to their real
                # top-level entry, not be dropped as hidden
                n = posixpath.normpath(n)
                if n in (".", "") or n.startswith(("../", "/")) or n == "..":
                    continue
                root = n.split("/", 1)[0]
                if root.startswith("."):  # top-level hidden junk (._*, .DS_Store)
                    continue
                roots.add(root)
        if len(roots) == 1:
            target = work_path / next(iter(roots))
            extract_to = work_path
        else:
            # flat or multi-rooted archive: extract into a dedicated folder
            stem = dataset_path.name
            for suffix in (".tar.gz", ".tgz", ".tar"):
                if stem.endswith(suffix):
                    stem = stem[: -len(suffix)]
                    break
            target = work_path / stem
            extract_to = target
        if not target.exists():
            extract_to.mkdir(parents=True, exist_ok=True)
            with tarfile.open(dataset_path) as tar:
                # 'data' filter: refuse absolute/parent-traversal members
                # (also silences the Python 3.14 default-change warning)
                tar.extractall(extract_to, filter="data")
        return target

    raise ValueError(f"Dataset path {dataset_path} is neither a directory nor a tar archive")
