"""The port's data-parallel mesh against the JAX package's, on the CPU.

The port's ranks are spawned gloo processes (tests/test_torch_mesh_ranks.py
holds their bodies and imports no JAX); the JAX side runs in this process
on the host devices of tests/conftest.py. Both sides start from the same
numpy inputs and the same NestedResUNet(3 -> 2, filters 4) weights,
converted from the flax tree.

- The train step: the port at 2 ranks against ``make_train_step(mesh=
  make_mesh(2, ("data", "model"), (2, 1)))`` with the sagittal split,
  dropout 0 and 3 Adam steps: the losses within rtol 1e-4 and the
  parameters within rtol 5e-3 / atol 1e-6, as tests/test_parallel.py holds
  JAX's 2-device mesh to its one-device run (the order of the collective
  sums differs).
- A train-mode BatchNorm over a batch split across 2 ranks: its output,
  running statistics and gradients are those of flax's BatchNorm over the
  global batch, sharded over 2 devices.
- Serving: EnsembleFlips and EnsembleAffines whose folded batch needs
  padding (at 2 and at 4 ranks), EnsembleOrientations at 2 ranks, distributed_sliding_window (27 locations,
  padded) and PatchPredict(mesh=...), against JAX's on 2 host devices
  (GSPMD gives every mesh size the same answer up to the order of sums;
  the JAX side stays at 2 devices, the fewest collective participants).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict
from jax.sharding import NamedSharding, PartitionSpec as P

import segmentation_pipeline_tpu as jsp
from segmentation_pipeline_torch.models import state_dict_to_flax
from segmentation_pipeline_tpu.criterions import HybridLogisticDiceLoss as JLoss
from segmentation_pipeline_tpu.models import NestedResUNet as JNestedResUNet
from segmentation_pipeline_tpu.models import ensemble as jens
from segmentation_pipeline_tpu.parallel import halo as jhalo
from segmentation_pipeline_tpu.parallel import mesh as jmesh
from segmentation_pipeline_tpu.training import optimizers as joptim
from segmentation_pipeline_tpu.training import train_step as jtrain
from segmentation_pipeline_tpu.training.model import SegModel as JSegModel
from test_torch_mesh_ranks import FILTERS, cases_ranks, spawn_ranks, split_rows, step_spec

torch.set_num_threads(2)

# float32 probabilities after 25 convs, in another summation order,
# relative to max|ref|
PROB_TOL = 1e-5
BN_SHAPE = (8, 4, 4, 2, 3)


def jax_mesh(n):
    return jmesh.make_mesh(n, ("data", "model"), (n, 1))


def jax_steps(spec, mesh):
    jnet = JNestedResUNet(input_channels=3, output_channels=2, filters=spec["filters"],
                          dropout_p=0.0)
    model = JSegModel(jnet)
    model.load_state_dict(spec["variables"])
    optimizer = joptim.Adam(lr=spec["lr"])
    state = jtrain.create_train_state(model, optimizer, spec["batch"])
    step = jtrain.make_train_step(jnet, JLoss(), optimizer, mesh=mesh, sagittal_split=True)
    batch = jtrain.collate_to_device(spec["batch"], mesh=mesh)
    losses = []
    for i in range(spec["steps"]):
        state, loss_dict, _ = step(state, batch, jax.random.PRNGKey(i))
        losses.append({k: float(v) for k, v in loss_dict.items()})
    tree = {"params": state.params, "batch_stats": state.batch_stats}
    return losses, flatten_dict(jax.tree_util.tree_map(np.asarray, tree))


def bn_inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(1.0, 2.0, BN_SHAPE).astype(np.float32)
    return x, rng.normal(size=BN_SHAPE).astype(np.float32)


def jax_batchnorm(x, w, mesh):
    """flax's train-mode BatchNorm (the JAX package's settings) over x
    sharded on the mesh's data axis; loss sum(out * w)."""
    channels = x.shape[-1]
    norm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    params = {"scale": jnp.linspace(0.5, 1.5, channels), "bias": jnp.linspace(-0.2, 0.2, channels)}
    stats = {"mean": jnp.zeros(channels), "var": jnp.ones(channels)}

    def loss(params, x):
        out, new = norm.apply({"params": params, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
        return jnp.sum(out * w), (out, new["batch_stats"])

    grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, (out, new)), (dparams, dx) = grad(
        params, jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data"))))
    return {k: np.asarray(v) for k, v in dict(out=out, dx=dx, dscale=dparams["scale"],
                                               dbias=dparams["bias"], mean=new["mean"],
                                               var=new["var"]).items()}


def serving_inputs(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(-1, 1, (1, 3, 8, 16, 8)).astype(np.float32),
            "volume": rng.normal(size=(3, 16, 16, 16)).astype(np.float32),
            "hann": rng.normal(size=(2, 16, 16, 16)).astype(np.float32),
            "subject": rng.normal(size=(3, 16, 12, 12)).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 2 ranks (the step, BatchNorm, serving) and one of 4
    (serving with padding at 4), beside JAX's runs of the same cases."""
    spec = step_spec(dropout=0.0, steps=3)
    x, w = bn_inputs()
    data = serving_inputs(9)
    jmodel = JSegModel(JNestedResUNet(input_channels=3, output_channels=2, filters=FILTERS))
    jmodel.load_state_dict(spec["variables"])
    matrices = jens.EnsembleAffines(jmodel, num_members=3, strategy="mean").matrices
    two = {"flips": data["x"], "affines": (data["x"], matrices), "orientations": data["x"],
           "window": data["volume"], "patch_predict": data["subject"]}
    four = {"flips_w": data["x"], "affines": (data["x"], matrices),
            "window_hann": data["hann"]}
    ranks2 = spawn_ranks(cases_ranks, 2, tmp_path_factory.mktemp("ranks2"),
                         [("step_ranks", (spec,)), ("batchnorm_ranks", (x, w)),
                          ("serving_ranks", (spec["state"], two))])
    ranks4 = spawn_ranks(cases_ranks, 4, tmp_path_factory.mktemp("ranks4"),
                         [("serving_ranks", (spec["state"], four))])
    return dict(spec=spec, bn=(x, w), data=data, jmodel=jmodel, matrices=matrices,
                ranks2=ranks2, ranks4=ranks4)


def test_mesh_train_step_matches_jax_mesh_step(runs):
    spec, ranks = runs["spec"], runs["ranks2"]
    ref_losses, ref = jax_steps(spec, jax_mesh(2))
    for r, (result, _, _) in enumerate(ranks):
        for got, want in zip(result["losses"], ref_losses):
            for key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
        out = flatten_dict(state_dict_to_flax(
            {k: torch.from_numpy(v) for k, v in result["state"].items()}))
        assert out.keys() == ref.keys()
        for key in ref:
            np.testing.assert_allclose(out[key], ref[key], rtol=5e-3, atol=1e-6,
                                       err_msg="/".join(key))
    assert split_rows(1, 2, 4).tolist() == [2, 3, 6, 7]


def test_global_batchnorm_matches_jax(runs):
    """The port's statistics are the global batch's: each rank's rows
    normalize as flax normalizes the whole batch sharded over 2 devices,
    and the input and parameter gradients (summed over the ranks) are
    JAX's."""
    x, w = runs["bn"]
    ref = jax_batchnorm(x, w, jax_mesh(2))
    ranks = [result[1] for result in runs["ranks2"]]
    for key in ("out", "dx"):
        got = np.concatenate([r[key] for r in ranks])
        np.testing.assert_allclose(got, ref[key], rtol=1e-5, atol=1e-5, err_msg=key)
    for key in ("dscale", "dbias", "mean", "var"):
        for r in ranks:
            np.testing.assert_allclose(r[key], ref[key], rtol=1e-5, atol=1e-5, err_msg=key)
    # rank 0's rows normalized by their own statistics differ
    rows, axes = x[:4], (0, 1, 2, 3)
    local = (rows - rows.mean(axes)) / np.sqrt(rows.var(axes) + 1e-5) \
        * np.linspace(0.5, 1.5, 3) + np.linspace(-0.2, 0.2, 3)
    assert not np.allclose(ranks[0]["out"], local, atol=1e-3)


def _close(got, ref, name):
    np.testing.assert_allclose(got, ref, rtol=0, atol=PROB_TOL * np.abs(ref).max(),
                               err_msg=name)


def test_ensembles_on_a_mesh_match_jax(runs):
    """EnsembleFlips (8 members, and 2 members padded to 4 ranks),
    EnsembleAffines at JAX's matrices (3 members, padded at 2 and at 4
    ranks) and EnsembleOrientations (6 permutations of 8 flips at 2 ranks):
    every rank returns JAX's combination."""
    data, jmodel, matrices = runs["data"], runs["jmodel"], runs["matrices"]
    x, mesh = data["x"], jax_mesh(2)
    jtta = jens.EnsembleAffines(jmodel, num_members=3, strategy="mean", mesh=mesh)
    assert all(np.array_equal(a, b) for a, b in zip(jtta.matrices, matrices))
    refs = {"flips": jens.EnsembleFlips(jmodel, "mean", mesh=mesh)(x),
            "flips_w": jens.EnsembleFlips(jmodel, "mean", spatial_dims=(4,), mesh=mesh)(x),
            "affines": jtta(x),
            "orientations": jens.EnsembleOrientations(jmodel, "mean", mesh=mesh)(x)}
    for ranks, names in ((runs["ranks2"], ("flips", "affines", "orientations")),
                         (runs["ranks4"], ("flips_w", "affines"))):
        for result in ranks:
            for name in names:
                _close(result[-1][name], np.asarray(refs[name]), f"{name} at {len(ranks)}")


def test_distributed_sliding_window_and_patch_predict_match_jax(runs):
    """The network's window over 27 locations (padded to 28 at 2 ranks),
    the patch-dependent model in hann mode at 4 ranks (a padded location
    must add nothing, or the overlaps would be reweighted), and
    PatchPredict(mesh=...) on one subject."""
    data, jmodel = runs["data"], runs["jmodel"]
    mesh2 = jax_mesh(2)
    jnet, variables = jmodel.module, jmodel.variables

    def model_fn(p):
        return jnet.apply(variables, p, train=False)

    ref = np.asarray(jhalo.distributed_sliding_window(data["volume"], model_fn, 8, 4,
                                                      patch_batch=2, mesh=mesh2))
    for result in runs["ranks2"]:
        _close(result[-1]["window"], ref, "window")

    def patch_dependent(p):
        return p * 2.0 + jnp.mean(p, axis=(1, 2, 3, 4), keepdims=True)

    ref = np.asarray(jhalo.distributed_sliding_window(data["hann"], patch_dependent, 8, 4,
                                                      patch_batch=4, mode="hann", mesh=mesh2))
    for result in runs["ranks4"]:
        np.testing.assert_allclose(result[-1]["window_hann"], ref, rtol=1e-5, atol=1e-5)

    subject = jsp.Subject({"X": jsp.ScalarImage(tensor=data["subject"], affine=np.eye(4))})
    _, batch = jsp.PatchPredict(patch_size=8, patch_overlap=4, patch_batch_size=4,
                                mesh=mesh2).predict(jmodel, [subject])
    ref = np.asarray(batch["y_pred"])
    for result in runs["ranks2"]:
        _close(result[-1]["patch_predict"], ref, "patch_predict")
