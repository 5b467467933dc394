"""The port's ensembles and TTA (models/ensemble.py) and bit-packed label
fetch (ops/bitpack.py) against the JAX package's, on the same seeded numpy
inputs and, for networks, the same weights converted from the flax tree."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from segmentation_pipeline_tpu.models import NestedResUNet as JNestedResUNet
from segmentation_pipeline_tpu.models import ensemble as jens
from segmentation_pipeline_tpu.ops import bitpack as jbitpack
from segmentation_pipeline_tpu.training.model import SegModel as JSegModel
from segmentation_pipeline_torch.models import NestedResUNet, ensemble as tens
from segmentation_pipeline_torch.models import flax_to_state_dict
from segmentation_pipeline_torch.ops import bitpack as tbitpack
from segmentation_pipeline_torch.training.model import SegModel

torch.set_num_threads(2)

# Softmax probabilities after 25 f32 convs in another order: rounding only.
PROB_TOL = 1e-5
# A member's vote can differ between the frameworks only where its top two
# probabilities are within twice PROB_TOL; labels are compared elsewhere.
TIE = 2 * PROB_TOL
HALF = (8, 16, 8)  # a 16x16x8 volume after the sagittal split


def model_pair(seed, filters=4):
    """A JAX SegModel and the port's SegModel on the CPU, at the same random
    NestedResUNet(3 -> 2) weights in the flax layout (non-trivial BatchNorm
    statistics)."""
    variables = chip_smoke.flax_weights(np.random.default_rng(seed), filters)
    jmodel = JSegModel(JNestedResUNet(input_channels=3, output_channels=2, filters=filters,
                                      dropout_p=0.2), seed=0)
    jmodel.load_state_dict(variables)
    model = SegModel(NestedResUNet(3, 2, filters=filters, dropout_p=0.2), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    return jmodel, model


@pytest.fixture(scope="module")
def models():
    return [model_pair(seed) for seed in (3, 4)]


def _x(n, seed, spatial=HALF):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, *spatial)).astype(np.float32)


def near_ties(members):
    """Voxels (N, ...) where any member's top two probabilities are within
    TIE."""
    out = None
    for p in members:
        top2 = torch.topk(torch.as_tensor(p), 2, dim=1).values
        tie = (top2[:, 0] - top2[:, 1]) < TIE
        out = tie if out is None else out | tie
    return out.numpy()


def assert_labels_match(out, ref, members):
    """One-hot answers: equal outside near-ties, which stay few."""
    labels, ref_labels = np.argmax(out, 1), np.argmax(np.asarray(ref), 1)
    ties = near_ties(members)
    assert ties.mean() < 0.01, ties.mean()
    np.testing.assert_array_equal(labels[~ties], ref_labels[~ties])
    assert set(np.unique(out)) <= {0.0, 1.0} and (out.sum(1) == 1).all()


def _probabilities(rng, e, shape, c):
    return [rng.dirichlet(np.ones(c), shape).astype(np.float32).transpose(0, 4, 1, 2, 3)
            for _ in range(e)]


def test_apply_strategy_mean():
    preds = _probabilities(np.random.default_rng(0), 3, (2, 5, 4, 3), 4)
    out = tens.apply_strategy([torch.from_numpy(p) for p in preds], "mean")
    ref = jens.apply_strategy([jnp.asarray(p) for p in preds], "mean")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("members", [2, 4])
def test_apply_strategy_majority_ties(members):
    """Two voters give 1-1 ties wherever they disagree, four give 2-2 ties:
    the smallest class index wins, exactly as in JAX."""
    rng = np.random.default_rng(members)
    votes = rng.integers(0, 3, (members, 2, 6, 5, 4))
    preds = [np.moveaxis(np.eye(3, dtype=np.float32)[v], -1, 1) * 0.5 + 0.1 for v in votes]
    out = tens.apply_strategy([torch.from_numpy(p) for p in preds], "majority").numpy()
    ref = np.asarray(jens.apply_strategy([jnp.asarray(p) for p in preds], "majority"))
    np.testing.assert_array_equal(out, ref)
    counts = np.stack([(votes == c).sum(0) for c in range(3)], 1)
    tied = (np.sort(counts, 1)[:, -1] == np.sort(counts, 1)[:, -2])
    assert tied.mean() > 0.2
    np.testing.assert_array_equal(np.argmax(out, 1)[tied], np.argmax(counts, 1)[tied])
    with pytest.raises(ValueError):
        tens.parse_strategy("median")


@pytest.mark.parametrize("strategy", ["mean", "majority"])
def test_apply_strategy_masked(strategy):
    rng = np.random.default_rng(5)
    preds = _probabilities(rng, 3, (2, 5, 4, 3), 3)
    masks = [rng.uniform(size=(5, 4, 3)) > 0.3 for _ in preds]
    masks[0][0, 0, 0] = masks[1][0, 0, 0] = masks[2][0, 0, 0] = False
    out = tens.apply_strategy_masked([torch.from_numpy(p) for p in preds],
                                     [torch.from_numpy(m) for m in masks], strategy).numpy()
    ref = np.asarray(jens.apply_strategy_masked([jnp.asarray(p) for p in preds],
                                                [jnp.asarray(m) for m in masks], strategy))
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("strategy", ["mean", "majority"])
def test_ensemble_flips_match_jax(models, strategy, batched):
    (jmodel, model), _ = models
    x = _x(2, 1)
    ref = jens.EnsembleFlips(jmodel, strategy, spatial_dims=(3, 4), batched=batched)(x)
    tta = tens.EnsembleFlips(model, strategy, spatial_dims=(3, 4), batched=batched)
    assert tta.flips == [(), (3,), (4,), (3, 4)]
    out = tta(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 2, *HALF)
    if strategy == "mean":
        np.testing.assert_allclose(out, np.asarray(ref), atol=PROB_TOL)
    else:
        assert_labels_match(out, ref, tta._members(torch.from_numpy(x)))


@pytest.mark.parametrize("strategy", ["mean", "majority"])
def test_ensemble_models_match_jax(models, strategy):
    x = _x(2, 2)
    ref = jens.EnsembleModels([jm for jm, _ in models], strategy)(x)
    out = tens.EnsembleModels([m for _, m in models], strategy)(torch.from_numpy(x)).numpy()
    if strategy == "mean":
        np.testing.assert_allclose(out, np.asarray(ref), atol=PROB_TOL)
    else:
        assert_labels_match(out, ref, [m(torch.from_numpy(x)) for _, m in models])


@pytest.mark.parametrize("batched", [False, True])
def test_ensemble_orientations_match_jax(models, batched):
    """48 orientations of a 16x8x8 grid: the network sees 3 distinct
    permuted grids."""
    (jmodel, model), _ = models
    x = _x(1, 3, (16, 8, 8))
    tta = tens.EnsembleOrientations(model, "mean", batched=batched)
    assert len(tta.permutations) == 6 and len(tta.flips) == 8
    out = tta(torch.from_numpy(x)).numpy()
    ref = jens.EnsembleOrientations(jmodel, "mean", batched=batched)(x)
    assert out.shape == (1, 2, 16, 8, 8)
    np.testing.assert_allclose(out, np.asarray(ref), atol=PROB_TOL)


def test_one_permuted_forward_matches_jax(models):
    """The network on a permuted, non-cubic grid (W=16 with D=8 becomes D=16)."""
    (jmodel, model), _ = models
    x = np.ascontiguousarray(_x(2, 4, (16, 8, 8)).transpose(0, 1, 3, 4, 2))
    np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), np.asarray(jmodel(x)),
                               atol=PROB_TOL)


def test_batched_equals_unrolled(models):
    """Folding the members into the batch changes no sample's arithmetic
    (eval-mode BatchNorm, no dropout)."""
    (_, model), (_, model1) = models
    x = torch.from_numpy(_x(2, 5))
    for make in (lambda m, b: tens.EnsembleFlips(m, "mean", (3, 4), batched=b),
                 lambda m, b: tens.EnsembleModels(
                     [tens.EnsembleFlips(m, "majority", (3, 4), batched=b),
                      tens.EnsembleFlips(model1, "majority", (3, 4), batched=b)], "majority")):
        unrolled, batched = make(model, False)(x), make(model, True)(x)
        torch.testing.assert_close(batched, unrolled, atol=1e-6, rtol=0)
    members = tens.EnsembleFlips(model, "mean", (3, 4), batched=True)._members(x)
    ties = near_ties(members)
    out = tens.EnsembleFlips(model, "majority", (3, 4), batched=True)(x).argmax(1)
    ref = tens.EnsembleFlips(model, "majority", (3, 4), batched=False)(x).argmax(1)
    assert torch.equal(out[~torch.from_numpy(ties)], ref[~torch.from_numpy(ties)])


@pytest.mark.parametrize("size", [1, 13, 1001])
@pytest.mark.parametrize("n_classes", [2, 3, 5, 17])
def test_pack_ids_bytes_match_jax(n_classes, size):
    ids = np.random.default_rng(size).integers(0, n_classes, (size,)).astype(np.uint8)
    packed = tbitpack.pack_ids(torch.from_numpy(ids), n_classes)
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jbitpack.pack_ids(jnp.asarray(ids), n_classes)))
    assert packed.numel() == -(-size * tbitpack.bits_for(n_classes) // 8)
    np.testing.assert_array_equal(tbitpack.unpack_ids(packed.numpy(), n_classes, (size,)), ids)
    assert tbitpack.bits_for(n_classes) == jbitpack.bits_for(n_classes)


@pytest.mark.parametrize("n_classes", [2, 5, 256])
def test_fetch_ids_round_trip(n_classes):
    ids = np.random.default_rng(n_classes).integers(0, n_classes, (2, 7, 5, 3))
    dtype = tbitpack.idx_dtype_for(n_classes)
    fetched = tbitpack.fetch_ids(torch.from_numpy(ids).to(dtype), n_classes)
    assert fetched.shape == ids.shape
    np.testing.assert_array_equal(fetched, ids)
    if n_classes <= 255:
        np.testing.assert_array_equal(
            fetched, jbitpack.fetch_ids(jnp.asarray(ids, jnp.uint8), n_classes))
