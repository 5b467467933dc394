"""The port's device caches (segmentation_pipeline_torch/data/device_cache.py)
against the JAX package's on the CPU, on the same subjects: the gathered
batches for class ids, expanded one-hot, soft labels and bfloat16 X; the
per-subject centre CDFs of the weighted and uniform samplers over ragged
volumes; the patches and starts drawn at JAX's own uniforms, including a
subject with no positive probability (its start clips to 0) and against
``extract_patch`` at the drawn starts; and the byte budget's refusal. All
exact: the caches copy, the CDFs are the same numpy arithmetic."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segmentation_pipeline_tpu as jsp
import segmentation_pipeline_torch as tsp
from segmentation_pipeline_torch.data import device_cache as tdc
from segmentation_pipeline_torch.data.loader import extract_patch
from segmentation_pipeline_tpu.data import device_cache as jdc

PATCH = (6, 5, 4)


def arrays(shapes, seed=0, onehot=True):
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        x = rng.normal(size=(2, *shape)).astype(np.float32)
        ids = rng.integers(0, 3, size=shape)
        y = (np.moveaxis(np.eye(3, dtype=np.float32)[ids], -1, 0) if onehot
             else rng.uniform(size=(2, *shape)).astype(np.float32))
        prob = (rng.uniform(size=(1, *shape)) ** 4).astype(np.float32)
        out.append((x, y, prob))
    return out


def subjects(pkg, data):
    eye = np.eye(4)
    return [pkg.Subject(X=pkg.ScalarImage(tensor=x.copy(), affine=eye),
                        y=pkg.LabelMap(tensor=y.copy(), affine=eye),
                        patch_probability=pkg.ScalarImage(tensor=p.copy(), affine=eye),
                        name=f"s{i}") for i, (x, y, p) in enumerate(data)]


def sampler(pkg, kind, empty=()):
    """The package's sampler; subjects named in ``empty`` get no positive
    centre probability."""
    if kind == "uniform":
        return pkg.UniformSampler(PATCH)

    class Weighted(pkg.WeightedSampler):
        def _valid_center_probs(self, subject):
            probs = super()._valid_center_probs(subject)
            return probs * 0.0 if subject["name"] in empty else probs

    return Weighted(PATCH, "patch_probability")


def to_np(a):
    a = a.float() if isinstance(a, torch.Tensor) else np.asarray(a.astype(jnp.float32)) \
        if getattr(a, "dtype", None) == jnp.bfloat16 else a
    return np.asarray(a)


@pytest.mark.parametrize("case", ["ids", "onehot", "soft", "bfloat16"])
def test_gather_matches_jax(case):
    data = arrays([(8, 7, 6)] * 4, onehot=case != "soft")
    expand = case != "ids"
    jcache = jdc.DeviceDataCache(subjects(jsp, data), expand_onehot=expand,
                                 x_dtype=jnp.bfloat16 if case == "bfloat16" else None)
    tcache = tdc.DeviceDataCache(subjects(tsp, data), device="cpu", expand_onehot=expand,
                                 x_dtype=torch.bfloat16 if case == "bfloat16" else None)
    assert (tcache.nbytes, tcache.n_classes, tcache._is_onehot) == \
        (jcache.nbytes, jcache.n_classes, jcache._is_onehot)
    idx = [2, 0, 3, 2]
    ref, port = jcache.gather(idx), tcache.gather(idx)
    assert port["X"].dtype == (torch.bfloat16 if case == "bfloat16" else torch.float32)
    assert port["y"].dtype == (torch.uint8 if case == "ids" else torch.float32)
    for key in ("X", "y"):
        np.testing.assert_array_equal(to_np(port[key]), to_np(ref[key]), err_msg=key)


SHAPES = [(10, 9, 8), (12, 7, 9), (9, 11, 6)]  # ragged


@pytest.mark.parametrize("kind", ["weighted", "uniform"])
def test_cdf_rows_match_jax(kind):
    data = arrays(SHAPES, seed=1)
    jcache = jdc.DevicePatchCache(subjects(jsp, data), sampler(jsp, kind))
    tcache = tdc.DevicePatchCache(subjects(tsp, data), sampler(tsp, kind), device="cpu")
    np.testing.assert_array_equal(tcache._cdf.numpy(), np.asarray(jcache._cdf))
    np.testing.assert_array_equal(tcache._X.numpy(), np.asarray(jcache._X))
    np.testing.assert_array_equal(tcache._y.numpy(), np.asarray(jcache._y))
    assert (tcache.nbytes, tcache.volume_shape) == (jcache.nbytes, jcache.volume_shape)


@pytest.mark.parametrize("expand", [False, True])
def test_sample_at_jax_uniforms_picks_jax_starts_and_patches(expand):
    """Ragged subjects, and s1 without a positive centre probability: its
    CDF row is NaN and its start clips to 0, in both packages. The patches
    equal extract_patch at the drawn starts."""
    data = arrays(SHAPES, seed=2)
    jcache = jdc.DevicePatchCache(subjects(jsp, data), sampler(jsp, "weighted", ("s1",)),
                                  expand_onehot=expand)
    tsubjects = subjects(tsp, data)
    tcache = tdc.DevicePatchCache(tsubjects, sampler(tsp, "weighted", ("s1",)), device="cpu",
                                  expand_onehot=expand)
    assert np.isnan(np.asarray(jcache._cdf)[1]).all()
    idx = [0, 1, 2, 2, 0, 1]
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref, ref_starts = jcache.sample(idx, key)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (len(idx),))))
        port, starts = tcache.sample_at(idx, u)
        np.testing.assert_array_equal(starts.numpy(), np.asarray(ref_starts))
        assert starts[1].tolist() == [0, 0, 0]
        for key_ in ("X", "y"):
            np.testing.assert_array_equal(to_np(port[key_]), to_np(ref[key_]), err_msg=key_)
        for k, i in enumerate(idx):
            patch = extract_patch(tsubjects[i], starts[k].numpy(), PATCH)
            np.testing.assert_array_equal(port["X"][k].numpy(),
                                          np.moveaxis(np.asarray(patch["X"].data), 0, -1))
            y = np.moveaxis(np.asarray(patch["y"].data), 0, -1)
            np.testing.assert_array_equal(port["y"][k].numpy(), y if expand else y.argmax(-1))


def test_sample_draws_from_the_generator():
    data = arrays(SHAPES, seed=3)
    tcache = tdc.DevicePatchCache(subjects(tsp, data), sampler(tsp, "uniform"), device="cpu")
    a = tcache.sample([0, 2], torch.Generator().manual_seed(4))
    b = tcache.sample([0, 2], torch.Generator().manual_seed(4))
    assert torch.equal(a[1], b[1]) and torch.equal(a[0]["X"], b[0]["X"])
    assert a[0]["X"].shape == (2, *PATCH, 2) and a[0]["y"].shape == (2, *PATCH, 3)
    for k, i in enumerate([0, 2]):
        assert (a[1][k].numpy() + np.array(PATCH) <= np.array(SHAPES[i])).all()


def test_budget_and_shape_refusals():
    data = arrays(SHAPES, seed=4)
    with pytest.raises(ValueError, match="beyond the device cache budget"):
        tdc.DevicePatchCache(subjects(tsp, data), sampler(tsp, "uniform"), device="cpu",
                             max_bytes=1000)
    with pytest.raises(ValueError, match="uniform subject shapes"):
        tdc.DeviceDataCache(subjects(tsp, data), device="cpu")
    same = arrays([(8, 7, 6)] * 2, seed=4)
    cache = tdc.DeviceDataCache(subjects(tsp, same), device="cpu")
    with pytest.raises(ValueError, match="beyond the device cache budget"):
        tdc.DeviceDataCache(subjects(tsp, same), device="cpu", max_bytes=cache.nbytes - 1)
    with pytest.raises(ValueError, match="exceeds the smallest subject"):
        tdc.DevicePatchCache(subjects(tsp, arrays([(5, 9, 9)], seed=4)),
                             sampler(tsp, "uniform"), device="cpu")


def test_is_exact_onehot():
    eye = np.eye(3, dtype=np.float32)[np.array([[0, 1], [2, 2]])]
    assert tdc.is_exact_onehot(eye, axis=-1)
    assert not tdc.is_exact_onehot(eye * 0.5, axis=-1)
    assert not tdc.is_exact_onehot(eye[..., :1], axis=-1)
    from segmentation_pipeline_torch.training import trainer

    assert trainer.is_exact_onehot is tdc.is_exact_onehot


def test_caches_and_resample_default_to_cuda(monkeypatch):
    """No silent CPU fallback: without a GPU and without device='cpu', the
    caches and resample_volume raise."""
    from segmentation_pipeline_torch.ops.resample import resample_volume

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = arrays([(8, 7, 6)] * 2, seed=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdc.DeviceDataCache(subjects(tsp, data))
    with pytest.raises(RuntimeError, match="CUDA"):
        tdc.DevicePatchCache(subjects(tsp, data), sampler(tsp, "uniform"))
    with pytest.raises(RuntimeError, match="CUDA"):
        resample_volume(data[0][0], np.eye(4), np.eye(4), (8, 7, 6))
    assert resample_volume(data[0][0], np.eye(4), np.eye(4), (8, 7, 6),
                           device="cpu").device.type == "cpu"
