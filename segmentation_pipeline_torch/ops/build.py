"""Build the port's native code at first use and load it with ctypes.

Each CUDA source in ``segmentation_pipeline_torch/csrc`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface; the
host C++ sources (``ccl.cpp``, the connected-component labeller;
``nifti_io.cpp``, the NIfTI reader, linked with zlib) by ``g++``
(``load_host``). Libraries go under ``build/torch_kernels/`` at the root of
the checkout (git-ignored), named by a hash of their source and flags, so an
edited source rebuilds and an unchanged one is reused. Each is written to a
temporary file and moved into place with ``os.replace``, so processes that
build at once never load a half-written library. Nothing here runs on
import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_libraries: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}
"""nvcc's output per source (register and shared-memory use from -Xptxas -v),
for the sources built by this process."""


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(source: str, flags=NVCC_FLAGS) -> Path:
    text = (CSRC / source).read_bytes() + " ".join(flags).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(sources: List[str]) -> None:
    """Compile every source in ``sources`` whose library is missing, one
    ``nvcc`` process per source, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for source in sources:
        target = _library_path(source)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
        procs.append((source, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for source, target, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[source] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{source}:\n{log}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _libraries.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(_library_path(source)))
        _libraries[source] = lib
    return lib


def _cxx() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++) found: the native host code cannot be built")


def load_host(source: str, libs: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded host library of the C++ ``source``, built by g++ first if
    needed and linked with ``libs`` (flags after the source, such as
    ``-lz``; part of the library's name). A failed build raises with the
    compiler's output."""
    lib = _libraries.get(source)
    if lib is not None:
        return lib
    libs = list(libs)
    target = _library_path(source, CXX_FLAGS + libs)
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, str(CSRC / source), *libs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        build_logs[source] = proc.stdout
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed for {source}:\n{proc.stdout}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    _libraries[source] = lib
    return lib
