"""The port's PatchPredict against the JAX package's, on the same subjects
and on msseg2's network (ModularUNet with blurred samplers) at the same
weights; its batch halving, input cache, bf16 upload and lazy batch."""
import copy

import numpy as np
import pytest
import torch

import chip_smoke
import segmentation_pipeline_tpu as jsp
from segmentation_pipeline_tpu import prediction as jpred
from segmentation_pipeline_tpu.models import components as jcomp
from segmentation_pipeline_tpu.models import ensemble as jens
from segmentation_pipeline_tpu.models import ModularUNet as JModularUNet
from segmentation_pipeline_tpu.training.model import SegModel as JSegModel
import segmentation_pipeline_torch as tsp
from segmentation_pipeline_torch import prediction as tpred
from segmentation_pipeline_torch.models import ensemble as tens
from segmentation_pipeline_torch.models import state_dict_to_flax
from segmentation_pipeline_torch.training.model import SegModel

torch.set_num_threads(2)

TIE = 2e-5


def msseg2_pair(filters, seed):
    """A JAX SegModel and the port's on the CPU, at the same random weights,
    of msseg2's network (research/msseg2/msseg2.py:163-176) at ``filters``."""
    module = chip_smoke.msseg2_network(filters)
    state = chip_smoke.msseg2_state(np.random.default_rng(seed), module)
    model = SegModel(module, device="cpu")
    model.load_state_dict(state)
    jnet = JModularUNet(in_channels=2, out_channels=2, filters=list(filters), depth=len(filters),
                        block_params={"residual": True},
                        downsample_class=jcomp.BlurConv3d,
                        downsample_params={"kernel_size": 3, "stride": 2, "padding": 1},
                        upsample_class=jcomp.BlurConvTranspose3d,
                        upsample_params={"kernel_size": 3, "stride": 2, "padding": 1,
                                         "output_padding": 0},
                        remat=True)
    jmodel = JSegModel(jnet)
    jmodel.load_state_dict(state_dict_to_flax(state))
    return jmodel, model


@pytest.fixture(scope="module")
def pair():
    return msseg2_pair((4, 8), 21)


def _affine(i):
    affine = np.diag([-1.0, 1.1, 0.9, 1.0])
    affine[:3, 3] = [4.0 + i, -3.0, 2.0 * i]
    return affine


def _subjects(pkg, shapes, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, shape in enumerate(shapes):
        s = pkg.Subject(name=f"s{i}")
        x = rng.uniform(-1, 1, (2, *shape)).astype(np.float32)
        s["X"] = pkg.ScalarImage(tensor=x, affine=_affine(i))
        s["y"] = pkg.LabelMap(tensor=(x[:1] > 0).astype(np.int32), affine=np.eye(4))
        out.append(s)
    return out


CASES = {
    "zeros_pad": (dict(padding_mode=None, patch_overlap=2), [(10, 9, 6)]),
    "zero_pad_stacked": (dict(padding_mode=0, patch_overlap=(3, 2, 1), patch_batch_size=3),
                         [(9, 11, 8), (9, 11, 8)]),
    "edge_argmax": (dict(padding_mode="edge", patch_overlap=4, device_argmax=True),
                    [(12, 7, 9)]),
    "constant_hann": (dict(padding_mode=0.5, patch_overlap=3, overlap_mode="hann"),
                      [(9, 10, 5)]),
    "bucket_ragged_argmax": (dict(shape_bucket=4, patch_overlap=2, device_argmax=True),
                             [(9, 10, 8), (12, 8, 6)]),
}


def _predict(pkg, predictor_kwargs, model, shapes, **extra):
    kwargs = dict(image_names=["X"], patch_batch_size=2, patch_size=8)
    kwargs.update(predictor_kwargs, **extra)
    return pkg.PatchPredict(**kwargs).predict(model, _subjects(pkg, shapes),
                                              label_attributes={"label_values": {"lesion": 1}})


def _labels_equal_outside_ties(port_onehot, jax_onehot, probs):
    top2 = np.sort(probs, axis=0)[-2:]
    clear = top2[1] - top2[0] >= TIE
    assert clear.mean() > 0.99, clear.mean()
    np.testing.assert_array_equal(port_onehot.argmax(0)[clear], jax_onehot.argmax(0)[clear])


@pytest.mark.parametrize("case", list(CASES))
def test_patch_predict_matches_jax(pair, case):
    jmodel, model = pair
    kwargs, shapes = CASES[case]
    jsubs, jbatch = _predict(jsp, kwargs, jmodel, shapes)
    tsubs, tbatch = _predict(tsp, kwargs, model, shapes, device="cpu")
    probs = _predict(tsp, dict(kwargs, device_argmax=False), model, shapes, device="cpu")[1]
    ragged = len(set(shapes)) > 1
    assert isinstance(tbatch["y_pred"], list) == isinstance(jbatch["y_pred"], list) == ragged
    if not ragged:
        assert isinstance(tbatch["y_pred"], np.ndarray)
        assert tbatch["y_pred"].shape == jbatch["y_pred"].shape == (len(shapes), 2, *shapes[0])
    assert list(tbatch.keys()) == list(jbatch.keys()) == ["y_pred", "X"]
    for i, (js, ts, shape) in enumerate(zip(jsubs, tsubs, shapes)):
        y_j, y_t = js["y_pred"], ts["y_pred"]
        assert isinstance(y_t, tsp.LabelMap) and y_t.metadata == y_j.metadata
        assert y_t.data.shape == y_j.data.shape == (2, *shape)
        assert y_t.data.dtype == y_j.data.dtype == np.float32
        assert y_t.data is tbatch["y_pred"][i] or np.array_equal(y_t.data, tbatch["y_pred"][i])
        if kwargs.get("device_argmax"):
            assert set(np.unique(y_t.data)) <= {0.0, 1.0} and (y_t.data.sum(0) == 1).all()
            _labels_equal_outside_ties(y_t.data, np.asarray(y_j.data), probs["y_pred"][i])
        else:
            # probabilities after the network
            np.testing.assert_allclose(y_t.data, y_j.data, atol=1e-4, rtol=0)
        for name in ("X", "y", "y_pred"):
            np.testing.assert_array_equal(ts[name].affine, js[name].affine)
        assert len(ts.history) == len(js.history) == 1


def test_generic_callable_matches_jax(pair):
    """EnsembleFlips around a SegModel goes through the generic path:
    channel-first patches."""
    jmodel, model = pair
    shapes = [(10, 9, 8)]
    kwargs = dict(padding_mode="edge", patch_overlap=2)
    jflips = jens.EnsembleFlips(jmodel, "mean", spatial_dims=(2, 3))
    tflips = tens.EnsembleFlips(model, "mean", spatial_dims=(2, 3), batched=True)
    _, jbatch = _predict(jsp, kwargs, jflips, shapes)
    _, tbatch = _predict(tsp, kwargs, tflips, shapes, device="cpu")
    np.testing.assert_allclose(tbatch["y_pred"], jbatch["y_pred"], atol=1e-4, rtol=0)


class OutOfMemoryAbove:
    """A test double that runs out of device memory on batches larger than
    ``limit`` (and records every batch size it was given)."""

    def __init__(self, limit, error=torch.cuda.OutOfMemoryError):
        self.limit, self.error, self.batches = limit, error, []

    def __call__(self, x):
        self.batches.append(x.shape[0])
        if x.shape[0] > self.limit:
            raise self.error("CUDA out of memory (test double)")
        return torch.softmax(torch.stack([x[:, 0], -x[:, 1]], dim=1), dim=1)


def test_batch_halves_on_out_of_memory_and_stays_halved(capsys):
    subjects = _subjects(tsp, [(8, 8, 8)])
    predictor = tsp.PatchPredict(patch_batch_size=8, patch_size=4, patch_overlap=2,
                                 device="cpu")
    double = OutOfMemoryAbove(2)
    _, batch = predictor.predict(double, copy.deepcopy(subjects))
    assert double.batches[:3] == [8, 4, 2] and set(double.batches[2:]) == {2, 1}
    assert predictor._effective_patch_batch == 2
    assert "patch_batch_size=4" in capsys.readouterr().out
    double.batches.clear()
    predictor.predict(double, copy.deepcopy(subjects))
    assert set(double.batches) == {2, 1}
    _, ref = tsp.PatchPredict(patch_batch_size=2, patch_size=4, patch_overlap=2,
                              device="cpu").predict(OutOfMemoryAbove(8), copy.deepcopy(subjects))
    np.testing.assert_array_equal(batch["y_pred"], ref["y_pred"])


def test_only_out_of_memory_halves():
    subjects = _subjects(tsp, [(8, 8, 8)])
    other = OutOfMemoryAbove(2, error=RuntimeError)
    predictor = tsp.PatchPredict(patch_batch_size=8, patch_size=4, device="cpu")
    with pytest.raises(RuntimeError, match="out of memory"):
        predictor.predict(other, copy.deepcopy(subjects))
    assert other.batches == [8]
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tsp.PatchPredict(patch_batch_size=2, patch_size=4, device="cpu").predict(
            OutOfMemoryAbove(0), copy.deepcopy(subjects))


def test_cache_inputs_uploads_once(pair, monkeypatch):
    _, model = pair
    subjects = _subjects(tsp, [(10, 9, 6), (9, 9, 9)])
    uploads = []
    upload = tpred.PatchPredict._upload
    monkeypatch.setattr(tpred.PatchPredict, "_upload",
                        lambda self, *a: uploads.append(a[0].shape) or upload(self, *a))
    predictor = tsp.PatchPredict(patch_size=8, patch_overlap=2, cache_inputs=True,
                                 device="cpu")
    _, first = predictor.predict(model, subjects)
    _, again = predictor.predict(model, [copy.deepcopy(s) for s in subjects])
    assert len(uploads) == 2
    _, plain = tsp.PatchPredict(patch_size=8, patch_overlap=2, device="cpu").predict(
        model, subjects)
    for a, b, c in zip(first["y_pred"], again["y_pred"], plain["y_pred"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_bf16_model_gets_a_bf16_upload(pair, monkeypatch):
    _, model = pair
    seen = []
    window = tpred.sliding_window_inference
    monkeypatch.setattr(tpred, "sliding_window_inference",
                        lambda volume, *a, **k: seen.append(volume.dtype) or window(volume, *a,
                                                                                    **k))
    shapes = [(10, 9, 8)]
    _, f32 = _predict(tsp, {}, model, shapes, device="cpu")
    model.compute_dtype = "bfloat16"
    try:
        _, bf16 = _predict(tsp, {}, model, shapes, device="cpu")
    finally:
        model.compute_dtype = None
    assert seen == [torch.float32, torch.bfloat16]
    assert bf16["y_pred"].dtype == np.float32
    np.testing.assert_allclose(bf16["y_pred"], f32["y_pred"], atol=0.05, rtol=0)


def test_lazy_batch_collates_on_first_access():
    subjects = _subjects(tsp, [(8, 8, 8), (8, 8, 8)])
    del subjects[1]["y"]
    batch = tpred._LazyBatch(subjects, ["X", "y"], cache=False, device=torch.device("cpu"))
    batch["y_pred"] = None
    assert list(batch) == list(batch.keys()) == ["y_pred", "X", "y"] and len(batch) == 3
    assert "X" in batch and not dict.__contains__(batch, "X") and "z" not in batch
    assert batch.get("z", 5) == 5
    with pytest.raises(KeyError):
        batch["z"]
    x = batch["X"]
    assert dict.__contains__(batch, "X") and batch["X"] is x
    assert torch.equal(x, tsp.collate_subjects(subjects, ["X"], device="cpu")["X"])
    # a present key whose subject lacks the image is a data error, not absence
    with pytest.raises(KeyError):
        batch.get("y")
    jbatch = jpred._LazyBatch(_subjects(jsp, [(8, 8, 8)]), ["X", "y"], cache=False)
    jbatch["y_pred"] = None
    assert list(jbatch.keys()) == ["y_pred", "X", "y"]


def test_device_postprocess_and_multi_device_wait_for_their_slices(pair):
    """device_postprocess (ported with the device morphology) needs
    device_argmax and cleans the ids as JAX's fused predictor does; the
    multi-device options still wait for their slice."""
    jmodel, model = pair
    subjects = _subjects(tsp, [(8, 8, 8)])
    with pytest.raises(ValueError, match="requires device_argmax"):
        tsp.PatchPredict(patch_size=8, device_postprocess=[("remove_holes", 64)],
                         device="cpu").predict(model, subjects)
    chain = [("remove_holes", 64), ("remove_small_components", 3)]
    out, _ = tsp.PatchPredict(patch_size=8, device_argmax=True, device_postprocess=chain,
                              device="cpu").predict(model, _subjects(tsp, [(10, 9, 6)]))
    ref, _ = jsp.PatchPredict(patch_size=8, device_argmax=True,
                              device_postprocess=chain).predict(jmodel,
                                                                _subjects(jsp, [(10, 9, 6)]))
    np.testing.assert_array_equal(out[0]["y_pred"].data, ref[0]["y_pred"].data)
    with pytest.raises(NotImplementedError, match="multi-device"):
        tsp.PatchPredict(patch_size=8, volume_sharded=True, device="cpu")
