"""The port's affine TTA (models/ensemble.py::EnsembleAffines) against the
JAX package's, on the CPU: a small NestedResUNet at converted weights with
the port's matrices set to JAX's, unrolled and batched, mean and majority;
the identity member alone; JAX's constant-model and linear-echo cases; and
research/dmri_hippo/hippo_inference.py --ensemble-affines 2, with and
without --ensemble-flips, against the JAX CLI on the same checkpoints."""
import numpy as np
import pytest
import torch

import segmentation_pipeline_torch as tsp
from research.dmri_hippo import hippo_inference as jhippo_inference
from segmentation_pipeline_tpu.models import ensemble as jens
from segmentation_pipeline_torch.models import ensemble as tens
from segmentation_pipeline_torch.research.dmri_hippo import hippo_inference as thippo_inference
from test_torch_cli_inference import COHORT, hippo  # noqa: F401  (a fixture)
from test_torch_ensemble import assert_labels_match, model_pair

torch.set_num_threads(2)

# float32 probabilities after 25 convs and two trilinear warps in another
# order, relative to max|ref|
TOL = 1e-5
SPATIAL = (8, 16, 8)


def _x(seed, n=2, channels=3, spatial=SPATIAL):
    return np.random.default_rng(seed).uniform(-1, 1, (n, channels, *spatial)).astype(np.float32)


def _pair(model_j, model_t, k, strategy, batched, seed=0, **kwargs):
    """JAX's EnsembleAffines and the port's at JAX's matrices."""
    jtta = jens.EnsembleAffines(model_j, num_members=k, strategy=strategy, seed=seed,
                                batched=batched, **kwargs)
    ttta = tens.EnsembleAffines(model_t, num_members=k, strategy=strategy, seed=seed,
                                batched=batched, **kwargs)
    ttta.matrices = [m.copy() for m in jtta.matrices]
    return jtta, ttta


@pytest.fixture(scope="module")
def pair():
    return model_pair(11)


def _port_members(ttta, x):
    """The port's warped-back member probabilities, for the near-tie mask."""
    x = torch.from_numpy(x)
    out = []
    for c in ttta._coords(tuple(x.shape[2:]), x.device):
        if c is None:
            out.append(ttta.model(x))
        else:
            out.append(ttta._warp_back(ttta.model(ttta._warp_in(x, c[0], c[1])), c[2]))
    return out


@pytest.mark.parametrize("strategy", ["mean", "majority"])
@pytest.mark.parametrize("batched", [False, True], ids=["unrolled", "batched"])
def test_matches_jax_at_its_matrices(pair, strategy, batched):
    jmodel, model = pair
    jtta, ttta = _pair(jmodel, model, 3, strategy, batched)
    assert len(ttta.matrices) == 3 and np.array_equal(ttta.matrices[0], np.eye(3))
    x = _x(1)
    ref = np.asarray(jtta(x))
    with torch.no_grad():
        out = ttta(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 2, *SPATIAL)
    if strategy == "mean":
        np.testing.assert_allclose(out, ref, rtol=0, atol=TOL * np.abs(ref).max())
    else:
        with torch.no_grad():
            assert_labels_match(out, ref, _port_members(ttta, x))


def test_batched_equals_unrolled_and_draws_repeat(pair):
    _, model = pair
    x = torch.from_numpy(_x(2))
    with torch.no_grad():
        outs = [tens.EnsembleAffines(model, num_members=3, seed=4, batched=b)(x)
                for b in (False, True)]
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=TOL)
    first, again, other = (tens.EnsembleAffines(model, num_members=3, seed=s) for s in (4, 4, 5))
    assert all(np.array_equal(a, b) for a, b in zip(first.matrices, again.matrices))
    assert not np.allclose(other.matrices[1], again.matrices[1])
    assert all(m.dtype == np.float32 and m.shape == (3, 3) for m in again.matrices)


def test_identity_member_only_is_the_bare_model(pair):
    jmodel, model = pair
    x = _x(3)
    with torch.no_grad():
        out = tens.EnsembleAffines(model, num_members=1)(torch.from_numpy(x)).numpy()
        bare = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, bare, atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(jens.EnsembleAffines(jmodel, num_members=1)(x)),
                               atol=TOL)


def test_mesh_runs_the_folded_batch(pair):
    """``mesh=`` folds the members into the batch; on a one-rank mesh (no
    process group) that is the batched path, which matches JAX's at its
    matrices (tests/test_torch_mesh.py holds 2 and 4 ranks to JAX's
    meshes)."""
    jmodel, model = pair
    jtta, ttta = _pair(jmodel, model, 3, "mean", True)
    meshed = tens.EnsembleAffines(model, num_members=3, mesh=tsp.make_mesh(device="cpu"))
    meshed.matrices = ttta.matrices
    assert meshed.batched
    x = _x(5)
    with torch.no_grad():
        out = meshed(torch.from_numpy(x)).numpy()
        torch.testing.assert_close(torch.from_numpy(out), ttta(torch.from_numpy(x)), rtol=0,
                                   atol=0)
    ref = np.asarray(jtta(x))
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL * np.abs(ref).max())


def test_constant_model_survives_the_round_trip():
    """A constant field comes back exactly under any matrices (JAX's
    tests/test_qsm_and_tta.py case, here at the port's own draws)."""
    def const(x):
        p = torch.full((x.shape[0], 1, *x.shape[2:]), 0.3)
        return torch.cat([p, 1 - p], dim=1)

    x = np.random.default_rng(0).normal(size=(1, 1, 10, 10, 10)).astype(np.float32)
    out = tens.EnsembleAffines(const, num_members=5, scales=0.2, degrees=30)(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out[:, 0], 0.3, atol=1e-5)
    np.testing.assert_allclose(out[:, 1], 0.7, atol=1e-5)


def test_linear_echo_comes_back_in_the_interior():
    """Trilinear interpolation reproduces a linear ramp, so an echo model's
    output returns unchanged where every member covers it."""
    import jax.numpy as jnp

    W = 12
    ramp = (np.arange(W, dtype=np.float32) / (2 * W))[:, None, None]
    x = np.broadcast_to(ramp, (W, W, W))[None, None].copy()
    jtta, ttta = _pair(lambda v: jnp.concatenate([v, 1 - v], axis=1),
                       lambda v: torch.cat([v, 1 - v], dim=1), 3, "mean", True, seed=1,
                       scales=0.05, degrees=5)
    out = ttta(torch.from_numpy(x)).numpy()
    c = slice(3, W - 3)
    np.testing.assert_allclose(out[0, 0, c, c, c], x[0, 0, c, c, c], atol=1e-4)
    np.testing.assert_allclose(out, np.asarray(jtta(x)), atol=1e-6)


@pytest.mark.parametrize("flips", [False, True], ids=["affines", "affines-and-flips"])
def test_hippo_inference_ensemble_affines_matches_jax(hippo, flips, tmp_path,  # noqa: F811
                                                      monkeypatch):
    """--ensemble-affines 2 over two folds (and --ensemble-flips, the
    affines outside the flips), the port's matrices set to JAX's: labels
    equal."""
    root, jfolder, tfolder = hippo
    wrapped = []

    class AtJaxMatrices(tens.EnsembleAffines):
        def __init__(self, model, **kwargs):
            super().__init__(model, **kwargs)
            import segmentation_pipeline_tpu as jsp
            self.matrices = jsp.EnsembleAffines(None, **kwargs).matrices
            wrapped.append(self)

    monkeypatch.setattr(thippo_inference, "EnsembleAffines", AtJaxMatrices)
    kwargs = dict(run_name="run", cohort=COHORT, batch_size=4, ensemble_flips=flips,
                  ensemble_folds=True, ensemble_affines=2, batched_tta=True)
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    jhippo_inference.main(jfolder, root, out_folder=str(tmp_path / "jax"), **kwargs)
    thippo_inference.main(tfolder, root, out_folder=str(tmp_path / "port"), device="cpu",
                          **kwargs)
    assert len(wrapped) == 2 and all(w.strategy == "majority" and w.batched for w in wrapped)
    assert all(isinstance(w.model, tens.EnsembleFlips) == flips for w in wrapped)
    name = "dmri-hippo-dmri-hippo"
    outputs = sorted((tmp_path / "port" / "subjects").glob(f"*/{name}.nii.gz"))
    assert len(outputs) == 3
    for f in outputs:
        jdata, jaffine = tsp.read_nifti(tmp_path / "jax" / f.relative_to(tmp_path / "port"))
        tdata, taffine = tsp.read_nifti(f)
        assert tdata.shape == (1, 20, 18, 6) and set(np.unique(tdata)) <= {0, 1, 2}
        np.testing.assert_array_equal(taffine, jaffine)
        np.testing.assert_array_equal(tdata, jdata)
