"""The port's native labeller (segmentation_pipeline_torch/csrc/ccl.cpp
through native.py) against the JAX package's library and scipy.ndimage, on
masks made from a seed with numpy: each entry exactly. Its build: a failed
build raises with the compiler's log, and two processes building at once
both load a whole library."""
import ctypes
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from scipy import ndimage as ndi

from segmentation_pipeline_tpu import native as jnative
from segmentation_pipeline_torch import native as tnative
from segmentation_pipeline_torch.ops import build


def masks(seed, shape=(24, 20, 16)):
    """Sparse islands, dense blobs and noise."""
    rng = np.random.default_rng(seed)
    sparse = rng.random(shape) < 0.04
    blobs = ndi.binary_dilation(rng.random(shape) < 0.02, iterations=2)
    noise = rng.random(shape) < 0.5
    return {"sparse": sparse, "blobs": blobs, "noise": noise}


@pytest.mark.parametrize("connectivity", [1, 2, 3])
@pytest.mark.parametrize("kind", ["sparse", "blobs", "noise"])
def test_label_components_matches_jax_and_scipy(connectivity, kind):
    mask = masks(connectivity)[kind]
    labels, n = tnative.connected_components_native(mask, connectivity)
    jlabels, jn = jnative.connected_components_native(mask, connectivity)
    ref, ref_n = ndi.label(mask, structure=ndi.generate_binary_structure(3, connectivity))
    assert labels.dtype == np.int32 and n == jn == ref_n
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(labels, ref)


def test_label_components_empty_and_full():
    labels, n = tnative.connected_components_native(np.zeros((5, 4, 3), bool))
    assert n == 0 and not labels.any()
    labels, n = tnative.connected_components_native(np.ones((5, 4, 3), np.int16), 1)
    assert n == 1 and (labels == 1).all()
    with pytest.raises(ValueError, match="connectivity"):
        tnative.connected_components_native(np.ones((2, 2, 2)), 4)


@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.int64])
def test_grey_dilation_matches_jax_and_scipy(dtype):
    img = np.random.default_rng(3).integers(0, 7, (13, 11, 9)).astype(dtype)
    out = tnative.grey_dilation_native(img)
    ref = ndi.grey_dilation(img.astype(np.int32), footprint=ndi.generate_binary_structure(3, 1))
    assert out.dtype == img.dtype
    np.testing.assert_array_equal(out, jnative.grey_dilation_native(img))
    np.testing.assert_array_equal(out, ref.astype(dtype))


def _component_counts(lib, labels, n):
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    out = np.empty(n + 1, np.int64)
    lib.component_counts(labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), labels.size,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n)
    return out


def test_component_counts_matches_jax_library():
    labels, n = tnative.connected_components_native(masks(4)["sparse"], 3)
    counts = _component_counts(tnative.library(), labels, n)
    np.testing.assert_array_equal(counts, np.bincount(labels.ravel(), minlength=n + 1))
    lib = jnative._build_and_load()
    if lib is not None:  # the JAX package's own entry on the same labels
        np.testing.assert_array_equal(counts, _component_counts(lib, labels, n))
    # labels above num_labels and negative ones are not counted
    np.testing.assert_array_equal(
        _component_counts(tnative.library(), np.array([[[0, 1, 2, 5, -1]]]), 2), [1, 1, 1])


def test_confusion_joint_hist_matches_jax_and_bincount():
    rng = np.random.default_rng(5)
    target = rng.integers(-1, 6, (10, 9, 8))
    pred = rng.integers(0, 8, (10, 9, 8))
    lut = np.array([3, 0, 1, 2, 3], np.int32)  # values 1..3 named, others bucket L=3
    out = tnative.confusion_joint_hist_native(target, pred, lut, 3)
    np.testing.assert_array_equal(out, jnative.confusion_joint_hist_native(
        target.astype(np.int32), pred.astype(np.int32), lut, 3))

    def bucket(a):
        inside = (a >= 0) & (a < len(lut))
        return np.where(inside, lut[np.where(inside, a, 0)], 3)

    ref = np.bincount((bucket(target) * 4 + bucket(pred)).ravel(), minlength=16).reshape(4, 4)
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError, match="size"):
        tnative.confusion_joint_hist_native(target, pred[:5], lut, 3)


def _fresh_build(monkeypatch, csrc, build_dir):
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(build, "_libraries", {})
    monkeypatch.setattr(tnative, "_LIB", None)


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "ccl.cpp").write_text("int broken( {\n")
    _fresh_build(monkeypatch, csrc, tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for ccl.cpp") as raised:
        tnative.connected_components_native(np.ones((2, 2, 2)))
    assert "error" in str(raised.value)
    assert list((tmp_path / "build").iterdir()) == []  # no library, no temporary file


def test_two_processes_build_at_once(tmp_path):
    """Two processes that find no library build it together: each writes a
    temporary file and moves it into place, so both load a whole library
    and label alike, and one library is left."""
    script = textwrap.dedent(f"""
        import numpy as np
        from pathlib import Path
        from segmentation_pipeline_torch import native
        from segmentation_pipeline_torch.ops import build
        build.BUILD_DIR = Path({str(tmp_path)!r})
        mask = np.random.default_rng(0).random((16, 16, 16)) < 0.3
        labels, n = native.connected_components_native(mask, 2)
        print(n, int(labels.sum()))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0][0] == outs[1][0] and outs[0][0].strip()
    libraries = sorted(p.name for p in tmp_path.iterdir())
    assert len(libraries) == 1 and libraries[0].startswith("ccl-") and \
        libraries[0].endswith(".so")
