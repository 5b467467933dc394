"""The port's native NIfTI reader (csrc/nifti_io.cpp through
native.nifti_read_raw_native, the first path of core/nifti.py::read_nifti)
against its numpy codec and the JAX package's read_nifti, on the CPU: files
written by both packages' write_nifti (.nii and .nii.gz; int16, float32,
uint8; 3-D and 4-D) read equal, arrays and affines. JAX's side reads with
its Python codec (its native reader is patched to refuse), so it never
builds its own library here. A byte-swapped file is refused by the reader
and reads right through the codec; a reader that does not build raises
with g++'s log."""
import gzip
import struct

import numpy as np
import pytest

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_tpu.native as jnative
import segmentation_pipeline_torch as tsp
from segmentation_pipeline_torch import native as tnative
from segmentation_pipeline_torch.core import nifti as tnifti
from segmentation_pipeline_torch.ops import build

AFFINE = np.array([[-0.9375, 0.02, 0.0, 120.0], [0.01, 0.9375, 0.0, -118.5],
                   [0.0, 0.0, 1.2, -86.4], [0.0, 0.0, 0.0, 1.0]])


def _volume(dtype, channels, seed):
    rng = np.random.default_rng(seed)
    shape = (channels, 11, 9, 7)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, 120, shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


def _codec(path, monkeypatch):
    """The port's read_nifti with the native reader refusing every file."""
    with monkeypatch.context() as m:
        m.setattr(tnative, "nifti_read_raw_native", lambda path: None)
        return tnifti.read_nifti(path)


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reader_codec_and_jax_read_alike(writer, suffix, tmp_path, monkeypatch):
    monkeypatch.setattr(jnative, "nifti_read_raw_native", lambda path: None)
    write = jsp.write_nifti if writer == "jax" else tsp.write_nifti
    for seed, (dtype, channels) in enumerate([(np.int16, 1), (np.float32, 1), (np.uint8, 1),
                                               (np.int16, 3), (np.float32, 2), (np.uint8, 4)]):
        path = tmp_path / f"{np.dtype(dtype).name}-{channels}{suffix}"
        data = _volume(dtype, channels, seed)
        write(path, data, AFFINE)
        raw, payload = tnative.nifti_read_raw_native(path)
        assert len(raw) == 352 and payload.nbytes == data.nbytes
        reads = [tsp.read_nifti(path), _codec(path, monkeypatch), jsp.read_nifti(path)]
        for got, affine in reads:
            assert got.dtype == data.dtype and got.shape == data.shape
            np.testing.assert_array_equal(got, data)
            np.testing.assert_array_equal(affine, reads[2][1])
        np.testing.assert_allclose(reads[0][1], AFFINE, atol=1e-6)


def _byte_swapped(path, data):
    """A big-endian NIfTI-1 file of float32 ``data`` (C, W, H, D), sform
    set to the scaled identity."""
    header = bytearray(352)
    c, w, h, d = data.shape
    struct.pack_into(">i", header, 0, 348)
    struct.pack_into(">8h", header, 40, 4 if c > 1 else 3, w, h, d, c, 1, 1, 1)
    struct.pack_into(">hh", header, 70, 16, 32)
    struct.pack_into(">8f", header, 76, 1, 2, 3, 4, 1, 1, 1, 1)
    struct.pack_into(">f", header, 108, 352.0)
    struct.pack_into(">f", header, 112, 1.0)
    struct.pack_into(">h", header, 254, 1)
    for row, values in enumerate(([2, 0, 0, 5], [0, 3, 0, 6], [0, 0, 4, 7])):
        struct.pack_into(">4f", header, 280 + 16 * row, *values)
    header[344:348] = b"n+1\0"
    body = np.transpose(data, (1, 2, 3, 0)).astype(">f4").tobytes(order="F")
    with gzip.open(path, "wb") as f:
        f.write(bytes(header) + body)


def test_byte_swapped_file_is_refused_and_read_by_the_codec(tmp_path, monkeypatch):
    monkeypatch.setattr(jnative, "nifti_read_raw_native", lambda path: None)
    data = _volume(np.float32, 2, 7)
    path = tmp_path / "big-endian.nii.gz"
    _byte_swapped(path, data)
    assert tnative.nifti_read_raw_native(path) is None
    got, affine = tsp.read_nifti(path)
    assert got.dtype == np.float32 and got.dtype.byteorder in "=|<"
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(affine, [[2, 0, 0, 5], [0, 3, 0, 6], [0, 0, 4, 7],
                                           [0, 0, 0, 1]])
    jgot, jaffine = jsp.read_nifti(path)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(affine, jaffine)


def test_short_and_missing_files_are_refused(tmp_path):
    path = tmp_path / "short.nii"
    tsp.write_nifti(path, _volume(np.int16, 1, 3), AFFINE)
    path.write_bytes(path.read_bytes()[:-10])
    assert tnative.nifti_read_raw_native(path) is None
    with pytest.raises(ValueError):  # the codec's own check of the payload
        tsp.read_nifti(path)
    assert tnative.nifti_read_raw_native(tmp_path / "missing.nii.gz") is None


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "nifti_io.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libraries", {})
    monkeypatch.setattr(tnative, "_NIFTI_LIB", None)
    path = tmp_path / "a.nii"
    (tmp_path / "a.nii").write_bytes(b"")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for nifti_io.cpp") as raised:
        tsp.read_nifti(path)
    assert "error" in str(raised.value)
    assert list((tmp_path / "build").iterdir()) == []
