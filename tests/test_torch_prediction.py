"""The port's StandardPredict, data model and NIfTI codec against the JAX
package's, on the same subjects and weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segmentation_pipeline_tpu as jsp
from segmentation_pipeline_tpu import prediction as jpred
from segmentation_pipeline_tpu.training.model import SegModel as JSegModel
import segmentation_pipeline_torch as tsp
from segmentation_pipeline_torch import prediction as tpred
from segmentation_pipeline_torch.models import flax_to_state_dict
from segmentation_pipeline_torch.ops.bitpack import idx_dtype_for
from segmentation_pipeline_torch.training.model import SegModel

torch.set_num_threads(2)

SPATIAL = (16, 16, 8)


def _volumes(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, size=(3, *SPATIAL)).astype(np.float32) for _ in range(n)]


def _affine(i):
    affine = np.diag([1.0, 1.2, 2.0, 1.0])
    affine[:3, 3] = [i, -2.0 * i, 0.5]
    return affine


def _subjects(pkg, volumes):
    out = []
    for i, vol in enumerate(volumes):
        s = pkg.Subject(name=f"s{i}")
        s["X"] = pkg.ScalarImage(tensor=vol, affine=_affine(i))
        # a label map whose affine differs: EnforceConsistentAffine resets it
        s["y"] = pkg.LabelMap(tensor=(vol[:1] > 0).astype(np.int32), affine=np.eye(4))
        out.append(s)
    return out


@pytest.fixture(scope="module")
def models():
    jnet = jsp.NestedResUNet(input_channels=3, output_channels=2, filters=8)
    x = np.zeros((1, 8, *SPATIAL[1:], 3), np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jnet.init)({"params": jax.random.PRNGKey(5)}, jnp.asarray(x)))
    rng = np.random.default_rng(5)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        if path[-1].key == "var" else v, variables)
    jmodel = JSegModel(jnet, seed=0)
    jmodel.load_state_dict(variables)
    model = SegModel(tsp.NestedResUNet(3, 2, filters=8), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    return jmodel, model


def test_split_and_flip_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 8, 4, 2)).astype(np.float32)
    ref = np.asarray(jpred.split_and_flip(jnp.asarray(x)))
    out = tpred.split_and_flip(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(tpred.reverse_split_and_flip(out).numpy(), x)
    np.testing.assert_array_equal(
        tpred.reverse_split_and_flip(out).numpy(),
        np.asarray(jpred.reverse_split_and_flip(jnp.asarray(ref))))


@pytest.mark.parametrize("n_channels", [2, 255, 256])
def test_idx_dtype_and_onehot_match_jax(n_channels):
    assert str(idx_dtype_for(n_channels)).split(".")[-1] == \
        np.dtype(jpred.idx_dtype_for(n_channels)).name
    ids = np.random.default_rng(1).integers(0, n_channels, size=(2, 3, 4))
    np.testing.assert_array_equal(tpred.ids_to_onehot(ids, n_channels, 1),
                                  jpred.ids_to_onehot(ids, n_channels, 1))


@pytest.mark.parametrize("device_argmax", [False, True])
def test_standard_predict_matches_jax(models, device_argmax):
    jmodel, model = models
    volumes = _volumes(2, 2)
    jsubs, jbatch = jpred.StandardPredict(
        image_names=["X"], sagittal_split=True, device_argmax=device_argmax,
    ).predict(jmodel, _subjects(jsp, volumes), label_attributes={"label_values": {"a": 1}})
    tsubs, tbatch = tpred.StandardPredict(
        image_names=["X"], sagittal_split=True, device_argmax=device_argmax, device="cpu",
    ).predict(model, _subjects(tsp, volumes), label_attributes={"label_values": {"a": 1}})
    probs = tbatch["y_pred"].numpy()
    assert probs.shape == (2, 2, *SPATIAL)
    # softmax probabilities after 25 f32 convs: rounding only
    np.testing.assert_allclose(probs, np.asarray(jbatch["y_pred"]), atol=1e-5)
    for js, ts in zip(jsubs, tsubs):
        y_j, y_t = js["y_pred"], ts["y_pred"]
        assert isinstance(y_t, tsp.LabelMap) and y_t.metadata == y_j.metadata
        assert y_t.data.shape == y_j.data.shape == (2, *SPATIAL)
        assert y_t.data.dtype == y_j.data.dtype
        if device_argmax:
            assert set(np.unique(y_t.data)) <= {0.0, 1.0}
            np.testing.assert_array_equal(y_t.data, y_j.data)
        else:
            np.testing.assert_allclose(y_t.data, y_j.data, atol=1e-5)
        for name in ("X", "y", "y_pred"):
            np.testing.assert_array_equal(ts[name].affine, js[name].affine)
        assert len(ts.history) == len(js.history) == 1
        assert type(ts.history[0].transform).__name__ == "EnforceConsistentAffine"


def test_collate_subjects_matches_jax():
    volumes = _volumes(3, 3)
    jbatch = jsp.collate_subjects(_subjects(jsp, volumes), ["X", "y"])
    subjects = _subjects(tsp, volumes)
    batch = tsp.collate_subjects(subjects, ["X", "y"], device="cpu")
    assert batch["X"].dtype == torch.float32 and batch["y"].dtype == torch.int32
    for name in ("X", "y"):
        np.testing.assert_array_equal(batch[name].numpy(), np.asarray(jbatch[name]))
    cached = tsp.collate_subjects(subjects, ["X"], device="cpu", cache=True)
    mirror = subjects[0]["X"].device_mirror(("collate", "cpu"), None)
    assert torch.equal(cached["X"][0], mirror)
    np.testing.assert_array_equal(cached["X"].numpy(), batch["X"].numpy())


def test_nifti_round_trip_and_jax_reads_it(tmp_path):
    data = (np.random.default_rng(4).uniform(size=(2, *SPATIAL)) > 0.5).astype(np.float32)
    path = tmp_path / "y_pred.nii.gz"
    tsp.write_nifti(path, data, _affine(3))
    for read in (tsp.read_nifti, jsp.read_nifti):
        back, affine = read(path)
        np.testing.assert_array_equal(back, data)
        # NIfTI stores the sform in float32
        np.testing.assert_array_equal(affine, _affine(3).astype(np.float32))
