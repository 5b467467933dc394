"""The port's device morphology, instance and confusion ops
(segmentation_pipeline_torch/ops/morphology.py, instance.py, confusion.py)
run on CPU tensors against the JAX package's device functions and against
the host chain (the port's post_processing on its native labeller), on
masks made from a seed with numpy: every label, count and histogram
exactly."""
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from segmentation_pipeline_tpu.ops import confusion as jconf
from segmentation_pipeline_tpu.ops import instance as jinst
from segmentation_pipeline_tpu.ops import morphology as jmorph
from segmentation_pipeline_torch import post_processing as tpp
from segmentation_pipeline_torch.evaluators import connected_components, overlap_histogram
from segmentation_pipeline_torch.native import connected_components_native
from segmentation_pipeline_torch.ops import confusion as tconf
from segmentation_pipeline_torch.ops import instance as tinst
from segmentation_pipeline_torch.ops import morphology as tmorph

torch.set_num_threads(2)


def blobby_labels(seed, shape=(20, 18, 14), n_classes=3, density=0.18, grow=2):
    """Blobs of labels 1..n_classes-1 with holes and islands."""
    rng = np.random.default_rng(seed)
    mask = ndi.binary_dilation(rng.random(shape) < density, iterations=grow)
    labels = np.zeros(shape, np.int32)
    cc, n = ndi.label(mask, structure=np.ones((3, 3, 3)))
    for comp in range(1, n + 1):
        labels[cc == comp] = 1 + (comp % (n_classes - 1))
    labels[rng.random(shape) < 0.03] = 0
    return labels


def blob_and_islands(shape=(24, 22, 20)):
    """A large body whose smallest ids enter through an appendage, and
    islands: without hooking, the appendage's ids creep one shell a sweep."""
    mask = np.zeros(shape, bool)
    mask[6:22, 6:20, 6:18] = True
    mask[3:7, 17:20, 14:17] = True
    rng = np.random.default_rng(2)
    islands = rng.random(shape) < 0.01
    islands[5:23, 5:21, 5:19] = False
    return mask | islands


def serpentine(shape=(6, 22, 22)):
    """A one-voxel path winding through a plane: a component whose diameter
    is most of its voxels."""
    mask = np.zeros(shape, bool)
    for row in range(1, 21, 4):
        mask[3, row, 1:21] = True
        edge = 20 if (row // 4) % 2 == 0 else 1
        mask[3, row:row + 4, edge] = True
    mask[3, 21:, :] = False
    return mask


MASKS = {"blob_and_islands": blob_and_islands, "serpentine": serpentine,
         "blobby": lambda: blobby_labels(0) > 0}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("connectivity", [1, 2, 3])
@pytest.mark.parametrize("kind", list(MASKS))
def test_connected_components_match_jax_and_the_host(kind, connectivity):
    mask = MASKS[kind]()
    before = tmorph.connected_components_device.sweeps
    labels = tmorph.connected_components_device(t(mask), connectivity)
    sweeps = tmorph.connected_components_device.sweeps - before
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(
        labels.numpy(), np.asarray(jmorph.connected_components_device(mask, connectivity)))
    compact, n = tmorph.compact_labels(labels)
    host, n_host = connected_components_native(mask, connectivity)
    assert n == n_host
    np.testing.assert_array_equal(compact, host)
    assert sweeps < 20, sweeps  # hooking converges in a few sweeps


def test_capped_sweeps_still_converge_on_an_appendage():
    mask = np.zeros((32, 32, 32), bool)
    mask[4:30, 4:30, 4:30] = True
    mask[2:5, 27:30, 27:30] = True
    compact, n = tmorph.compact_labels(tmorph.connected_components_device(t(mask), 3,
                                                                          max_iterations=12))
    assert n == 1 and set(np.unique(compact)) == {0, 1}


def _same(port, jax_out, host):
    port = [p.numpy() if torch.is_tensor(p) else p for p in port]
    for p, j, h in zip(port, jax_out, host):
        np.testing.assert_array_equal(p, np.asarray(j))
        np.testing.assert_array_equal(p, h)


@pytest.mark.parametrize("seed", [0, 1])
def test_remove_holes_matches_jax_and_host(seed):
    img = blobby_labels(seed)
    _same(tmorph.remove_holes_device(t(img), 24), jmorph.remove_holes_device(img, 24),
          tpp.remove_holes(img.copy(), 24))


def _serpentine_hole():
    img = np.ones((6, 22, 22), np.int32)
    img[serpentine()] = 0
    return img


KEEP_CASES = {
    "blobby": lambda: (blobby_labels(2), 2, 4),
    "background_competes": lambda: (np.concatenate([np.ones((5, 10, 10), np.int32),
                                                    np.zeros((1, 10, 10), np.int32),
                                                    np.full((6, 10, 10), 2, np.int32)]), 1, 3),
    "speckle": lambda: (np.maximum((np.random.default_rng(5).random((16, 16, 16)) < 0.25),
                                   np.pad(np.ones((8, 8, 8), bool), 4)).astype(np.int32), 1, 2),
    "no_background": lambda: (np.concatenate([np.ones((4, 8, 8), np.int32),
                                              np.full((4, 8, 8), 2, np.int32)]), 1, 3),
}


@pytest.mark.parametrize("case", list(KEEP_CASES))
def test_keep_components_matches_jax_and_host(case):
    img, num, classes = KEEP_CASES[case]()
    port = tmorph.keep_components_device(t(img), num, num_classes=classes)
    _same(port, jmorph.keep_components_device(img, num, num_classes=classes),
          tpp.keep_components(img.copy(), num))


@pytest.mark.parametrize("case", ["blobby", "serpentine_hole"])
def test_remove_small_components_and_serpentine_hole(case):
    if case == "blobby":
        img = blobby_labels(3)
        _same(tmorph.remove_small_components_device(t(img), 20),
              jmorph.remove_small_components_device(img, 20),
              tpp.remove_small_components(img.copy(), 20))
    else:  # fills one shell per dilation and splits as it fills
        img = _serpentine_hole()
        size = int((img == 0).sum()) + 8
        _same(tmorph.remove_holes_device(t(img), size), jmorph.remove_holes_device(img, size),
              tpp.remove_holes(img.copy(), size))


@pytest.mark.parametrize("chain, classes", [
    ([("remove_holes", 64), ("remove_small_components", 3)], 2),
    ([("remove_holes", 64), ("keep_components", 2)], 3),
], ids=["msseg2", "hippo"])
def test_apply_device_postprocess_matches_jax_and_host(chain, classes):
    img = blobby_labels(7, n_classes=classes)
    host = img.copy()
    for op, arg in chain:
        host = getattr(tpp, op)(host, arg)[0]
    out = tmorph.apply_device_postprocess(t(img), chain, classes)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), host)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jmorph.apply_device_postprocess(img, chain, classes)))
    with pytest.raises(ValueError, match="erode"):
        tmorph.apply_device_postprocess(t(img), [("erode", 1)], classes)


@pytest.mark.parametrize("connectivity, iterations", [(1, 1), (2, 2), (3, 1)])
def test_binary_dilation_matches_jax_and_scipy(connectivity, iterations):
    mask = np.random.default_rng(connectivity).random((12, 10, 9)) < 0.05
    out = tmorph.binary_dilation_device(t(mask), connectivity, iterations).numpy()
    np.testing.assert_array_equal(out, np.asarray(
        jmorph.binary_dilation_device(mask, connectivity, iterations)))
    np.testing.assert_array_equal(out, ndi.binary_dilation(
        mask, ndi.generate_binary_structure(3, connectivity), iterations))


def _lesion_masks(seed, shape=(20, 18, 14)):
    """A target of sparse lesions (one voxel or a small blob each) and a
    prediction that grows some of them, misses others and adds its own."""
    rng = np.random.default_rng(seed)
    target = ndi.binary_dilation(rng.random(shape) < 0.003, iterations=1) | \
        (rng.random(shape) < 0.002)
    pred = ndi.binary_dilation(target & (rng.random(shape) < 0.7)) | (rng.random(shape) < 0.002)
    return target, pred


@pytest.mark.parametrize("capacity", [63, 3], ids=["fits", "overflow"])
def test_compaction_and_overlap_histogram_match_jax_and_host(capacity):
    """The instance histogram: component counts, numbering order and every
    entry equal to the host chain's; past the capacity, the overflow is
    flagged as in JAX (with the same truncated uniq vectors)."""
    target, pred = _lesion_masks(4)
    hist, t_uniq, p_uniq = tinst.overlap_histogram_device(t(target), t(pred), capacity, 2)
    jhist, jt_uniq, jp_uniq = jinst.overlap_histogram_device(target, pred, capacity, 2)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(t_uniq.numpy(), np.asarray(jt_uniq))
    np.testing.assert_array_equal(p_uniq.numpy(), np.asarray(jp_uniq))
    (n_t, ov_t), (n_p, ov_p) = tinst.component_count(t_uniq), tinst.component_count(p_uniq)
    assert (n_t, ov_t) == jinst.component_count(np.asarray(jt_uniq))
    tc, N = connected_components(target, 2)
    pc, M = connected_components(pred, 2)
    assert min(N, M) > 3
    if capacity == 63:
        assert not ov_t and not ov_p and (n_t, n_p) == (N, M)
        np.testing.assert_array_equal(hist.numpy()[:N + 1, :M + 1],
                                      overlap_histogram(tc, pc, N, M))
        assert hist.numpy()[N + 1:].sum() == hist.numpy()[:, M + 1:].sum() == 0
    else:
        assert ov_t and ov_p
    # the compaction alone: an all-foreground mask keeps bucket 0
    idx, uniq = tinst.compact_labels_device(torch.full((3, 3, 3), 7, dtype=torch.int32), 2)
    assert uniq.tolist() == [0, 7, 2 ** 30] and (idx == 1).all()


def test_channel_id_forms_match_jax():
    """Both histograms with the prediction side as channel ids through a (C,)
    LUT or full-shape (C, W, H, D) maps."""
    rng = np.random.default_rng(6)
    shape, C, B = (10, 9, 8), 3, 4
    ids = rng.integers(0, C, shape).astype(np.uint8)
    target = rng.integers(0, B, shape).astype(np.uint8)
    lut = np.array([3, 0, 1], np.int32)
    maps = rng.integers(0, B, (C, *shape)).astype(np.uint8)
    for channel_maps in (lut, maps):
        out = tconf.bucketed_joint_from_channel_ids(t(target), t(ids), t(channel_maps), B)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), np.asarray(
            jconf.bucketed_joint_from_channel_ids(target, ids, channel_maps, B)))
    np.testing.assert_array_equal(
        tconf.joint_histogram_device(t(target), t(ids), B).numpy(),
        np.asarray(jconf.joint_histogram_device(target, ids, B)))
    fg_maps = rng.random((C, *shape)) < 0.3
    target_fg = _lesion_masks(7)[0][:10, :9, :8]
    got = tinst.instance_hist_from_channel_ids(t(target_fg), t(ids), t(fg_maps), 63, 2)
    ref = jinst.instance_hist_from_channel_ids(target_fg, ids, fg_maps, capacity=63,
                                               connectivity=2)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    values = {"a": 1, "b": 4, "neg": -1}
    np.testing.assert_array_equal(tconf.value_lut(values, 6), jconf.value_lut(values, 6))
    raw = rng.integers(-2, 9, shape)
    got = tconf.bucketize_values(raw, tconf.value_lut(values, 6), 4)
    np.testing.assert_array_equal(got, jconf.bucketize_values(raw, jconf.value_lut(values, 6), 4))
    assert got.dtype == np.uint8
