"""The port's batched device augmentation (segmentation_pipeline_torch/ops/
augment.py and ops/resample.py) against the JAX package's on the CPU.

Each op at the same explicit parameters, then the whole pipeline at JAX's
own draws: every draw rebuilt from the key schedule of JAX's
``_augment_batch_jit`` (one key per sample split into the 16 slots) and
passed to ``apply_augmentation``, for both reference configurations, at
their gates and with every gate forced on, for class ids and one-hot
labels, float32 and bfloat16. X within 1e-5 of max|ref| in float32 (one
bf16 step at max|ref| in bfloat16, the output's one rounding), labels bit
for bit. Last, the port's own ``draw_augmentation`` stays inside the
configured ranges and gates at the configured rates."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_pipeline_torch.ops import augment as ta
from segmentation_pipeline_torch.ops.resample import resample_volume as t_resample
from segmentation_pipeline_tpu.ops import augment as ja
from segmentation_pipeline_tpu.ops.resample import resample_volume as j_resample
from segmentation_pipeline_tpu.transforms.random_spatial import _as_range

torch.set_num_threads(2)

TOL = 1e-5
BF16_TOL = 2.0 ** -7  # one bf16 step at max|ref| (a value in [1, 2))
SPATIAL = (12, 12, 12)
N, C = 2, 2
# every gate on; dmri's independent affine and elastic both, msseg2's
# spatial OneOf picks one or the other per sample at weight 0.5
FORCED = dict(flip_p=1.0, bias_p=1.0, gamma_p=1.0, noise_p=1.0, blur_p=1.0)
CONFIGS = {"dmri": (ja.DMRI_REFERENCE_CONFIG, dict(affine_p=1.0, elastic_p=1.0)),
           "msseg2": (ja.MSSEG2_REFERENCE_CONFIG, dict(oneof_p=1.0, oneof_affine_weight=0.5))}


def t(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


def jax_draws(key, n, spatial, channels, config):
    """The draws of JAX's augment_batch(key, ...) in the port's layout,
    rebuilt slot by slot from its key schedule (ops/augment.py:727-728)."""
    cfg = dict(ja.DEFAULT_CONFIG, **config)
    keys = jax.vmap(lambda k: jax.random.split(k, ja._N_KEYS))(jax.random.split(key, n))

    def per(fn):
        return t(jax.vmap(fn)(keys))

    def u(slot, shape=(), lo=0.0, hi=1.0):
        return per(lambda k: jax.random.uniform(k[slot], shape, minval=lo, maxval=hi))

    def noise_key(k, i):
        return jax.random.split(k[ja._K_NOISE])[i]

    std = cfg["noise_std"]
    s_lo, s_hi = (0.0, float(std)) if not isinstance(std, (tuple, list)) else std
    lg = cfg["log_gamma"]
    return {
        "flip": u(ja._K_FLIP, (3,)),
        "affine_gate": u(ja._K_AFFINE_GATE),
        "affine": per(lambda k: ja.draw_affine_matrix(k[ja._K_AFFINE], cfg["affine_scales"],
                                                      cfg["affine_degrees"])),
        "elastic_gate": u(ja._K_ELASTIC_GATE),
        "elastic": u(ja._K_ELASTIC, (3, *cfg["elastic_cp"]), -1.0, 1.0),
        "bias_gate": u(ja._K_BIAS_GATE),
        "bias": u(ja._K_BIAS, (len(ta._bias_terms(cfg["bias_order"])),),
                  *_as_range(cfg["bias_coefficients"])),
        "gamma_gate": u(ja._K_GAMMA_GATE),
        "gamma": per(lambda k: jnp.exp(jax.random.uniform(k[ja._K_GAMMA], (), minval=lg[0],
                                                          maxval=lg[1]))),
        "noise_gate": u(ja._K_NOISE_GATE),
        "noise_sigma": per(lambda k: jax.random.uniform(noise_key(k, 0), (), minval=s_lo,
                                                        maxval=s_hi)),
        "noise": per(lambda k: jax.random.normal(noise_key(k, 1), (*spatial, channels),
                                                 jnp.float32)),
        "blur_gate": u(ja._K_BLUR_GATE),
        "blur": u(ja._K_BLUR, (3, channels), *_as_range(cfg["blur_std"])),
        "order": u(ja._K_ORDER),
        "permute_gate": u(ja._K_PERM_GATE),
        "permute": per(lambda k: jax.random.randint(k[ja._K_PERM], (), 0, 6)),
    }


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def test_trilinear_sample_ties_and_clamped_edges():
    rng = np.random.default_rng(0)
    vol = rng.normal(size=(7, 6, 5, 2)).astype(np.float32)
    coords = rng.uniform(-1.5, 8.0, size=(3, 4, 5, 6)).astype(np.float32)
    coords[:, 0, 0, :] = np.array([0.5, 1.5, 2.5, 3.5, -0.5, 6.5], np.float32)  # ties
    coords[:, 1, 0, :] = np.array([-3.0, 0.0, 4.0, 5.0, 6.0, 9.25], np.float32)  # edges
    for nearest in (False, True):
        ref = np.asarray(ja.trilinear_sample(jnp.asarray(vol), jnp.asarray(coords), nearest))
        port = ta.trilinear_sample(t(vol), t(coords), nearest).numpy()
        if nearest:  # a copy of one voxel each: exact
            np.testing.assert_array_equal(port, ref)
        else:
            close(port, ref)


@pytest.mark.parametrize("pad", [0.0, "minimum", "mean", "otsu"])
def test_affine_coords_mask_pads_and_warp(pad):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(10, 9, 8, 2)).astype(np.float32) + 1.5
    ids = rng.integers(0, 3, size=(10, 9, 8, 1)).astype(np.uint8)
    key = jax.random.PRNGKey(5)
    A = np.asarray(ja.draw_affine_matrix(key, (0.8, 1.2), (-45.0, 45.0)))
    ref_coords, ref_oob = ja._affine_coords_oob(jnp.asarray(A), x.shape[:3])
    coords, oob = ta._affine_coords_oob(t(A)[None], x.shape[:3])
    np.testing.assert_array_equal(coords[0].numpy(), np.asarray(ref_coords))
    np.testing.assert_array_equal(oob[0].numpy(), np.asarray(ref_oob))
    assert 0 < int(oob.sum()) < oob.numel()
    ref_pad = ja._affine_pad_vector(jnp.asarray(x), pad)
    port_pad = ta._affine_pad_vector(t(x)[None], pad)
    if isinstance(pad, str):
        close(port_pad.reshape(-1).numpy(), np.asarray(ref_pad))
    ref_x, ref_y = ja.random_affine_warp(key, jnp.asarray(x), jnp.asarray(ids),
                                         (0.8, 1.2), (-45.0, 45.0), pad)
    port_x, port_y = ta._affine_warp(t(A)[None], t(x)[None], t(ids)[None], pad)
    close(port_x[0].numpy(), np.asarray(ref_x))
    np.testing.assert_array_equal(port_y[0].numpy(), np.asarray(ref_y))


def test_elastic_dense_field():
    grid = np.random.default_rng(2).uniform(-3, 3, size=(3, 7, 7, 4)).astype(np.float32)
    for spatial in ((12, 12, 12), (16, 11, 6)):
        ref = np.asarray(ja.elastic_dense_field(jnp.asarray(grid), spatial))
        close(ta.elastic_dense_field(t(grid), spatial).numpy(), ref)


def test_bias_field_at_given_coefficients():
    x = np.random.default_rng(3).normal(size=(9, 8, 7, 2)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(ja.random_bias_field(key, jnp.asarray(x), (-0.5, 0.5), order=3))
    coeffs = t(jax.random.uniform(key, (20,), minval=-0.5, maxval=0.5))
    port = t(x)[None] * torch.exp(ta.bias_field(coeffs[None], x.shape[:3], 3))[..., None]
    close(port[0].numpy(), ref)


def test_gamma_on_negative_values():
    x = np.random.default_rng(5).normal(size=(6, 5, 4, 2)).astype(np.float32)
    assert (x < 0).any()
    key = jax.random.PRNGKey(6)
    ref = np.asarray(ja.random_gamma(key, jnp.asarray(x), (-0.3, 0.3)))
    gamma = torch.exp(t(jax.random.uniform(key, (), minval=-0.3, maxval=0.3)))
    close(ta.apply_gamma(t(x)[None], gamma.view(1))[0].numpy(), ref)


@pytest.mark.parametrize("radius", [2, 9])
def test_gaussian_blur(radius):
    """Radius 9 exceeds the 6-voxel axis: the symmetric padding repeats."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(10, 8, 6, 2)).astype(np.float32)
    sigmas = rng.uniform(0.0, radius / 4.0, size=(3, 2)).astype(np.float32)
    sigmas[1, 0] = 0.0  # the identity along one axis of one channel
    ref = np.asarray(ja.gaussian_blur(jnp.asarray(x), jnp.asarray(sigmas), radius))
    close(ta.gaussian_blur(t(x)[None], t(sigmas)[None], radius)[0].numpy(), ref)


@pytest.mark.parametrize("percentiles,per_channel", [((0.0, 100.0), True), ((0.5, 99.5), True),
                                                     ((0.05, 99.5), False)])
def test_rescale_intensity_per_channel_with_percentiles(percentiles, per_channel):
    x = np.random.default_rng(8).normal(size=(9, 8, 7, 3)).astype(np.float32)
    x[..., 1] *= 10.0
    ref = np.asarray(ja.rescale_intensity(jnp.asarray(x), -1.0, 1.0, percentiles, per_channel))
    port = ta.rescale_intensity(t(x)[None], -1.0, 1.0, percentiles, per_channel)
    close(port[0].numpy(), ref)


def _only(**stages):
    """A config with every stage off but ``stages``."""
    return {**dict(flip_p=0.0, affine_p=0.0, bias_p=0.0, mid_rescale=None, gamma_p=0.0,
                   pre_noise_rescale=None, noise_p=0.0, rescale=None), **stages}


def test_flips_and_all_six_permutations():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(8, 8, 8, 2)).astype(np.float32)
    y = rng.integers(0, 3, size=(8, 8, 8, 1)).astype(np.uint8)
    found = {}
    for seed in range(200):
        k_do, k_pick = jax.random.split(jax.random.PRNGKey(seed))
        pid = int(jax.random.randint(k_pick, (), 0, 6))
        if pid not in found and float(jax.random.uniform(k_do)) < 1.0:
            found[pid] = (k_do, k_pick)
    assert sorted(found) == list(range(6))
    for pid, (k_do, k_pick) in found.items():
        ref_x, ref_y = ja.random_permute(k_do, k_pick, jnp.asarray(x), jnp.asarray(y), p=1.0)
        draws = ta.draw_augmentation(torch.Generator().manual_seed(0), 1, x.shape[:3], 2)
        draws["permute_gate"][:] = 0.0
        draws["permute"][:] = pid
        port_x, port_y = ta.apply_augmentation(t(x)[None], t(y)[None], draws,
                                               _only(permute_p=1.0))
        np.testing.assert_array_equal(port_x[0].numpy(), np.asarray(ref_x))
        np.testing.assert_array_equal(port_y[0].numpy(), np.asarray(ref_y))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref_x, ref_y = ja.random_flip(key, jnp.asarray(x), jnp.asarray(y), (0, 1, 2), 0.5)
        draws = ta.draw_augmentation(torch.Generator().manual_seed(0), 1, x.shape[:3], 2)
        draws["flip"] = t(jax.random.uniform(key, (3,)))[None]
        port_x, port_y = ta.apply_augmentation(t(x)[None], t(y)[None], draws, _only(flip_p=0.5))
        np.testing.assert_array_equal(port_x[0].numpy(), np.asarray(ref_x))
        np.testing.assert_array_equal(port_y[0].numpy(), np.asarray(ref_y))


@pytest.mark.parametrize("order", [0, 1])
def test_resample_volume(order):
    rng = np.random.default_rng(10)
    data = rng.normal(size=(2, 9, 8, 7)).astype(np.float32)
    if order == 0:
        data = np.round(data)
    src = np.diag([1.0, 1.2, 0.9, 1.0])
    src[:3, 3] = [-3.0, 1.0, 2.0]
    dst = np.diag([1.3, 0.8, 1.1, 1.0])
    dst[:3, 3] = [-4.0, 0.5, 1.5]
    ref = np.asarray(j_resample(data, src, dst, (10, 9, 8), order))
    port = t_resample(data, src, dst, (10, 9, 8), order, device="cpu").numpy()
    if order == 0:
        np.testing.assert_array_equal(port, ref)
    else:
        close(port, ref)


# ---------------------------------------------------------------------------
# the whole pipeline at JAX's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("labels", ["ids", "onehot"])
@pytest.mark.parametrize("forced", [False, True], ids=["gates", "forced"])
@pytest.mark.parametrize("name", ["dmri", "msseg2"])
def test_pipeline_matches_jax_at_its_draws(name, forced, labels, dtype):
    base, extra = CONFIGS[name]
    cfg = dict(base, **(dict(FORCED, **extra) if forced else {}))
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(N, *SPATIAL, C)) * 3 + 1).astype(np.float32)
    ids = rng.integers(0, 3, size=(N, *SPATIAL)).astype(np.uint8)
    y = ids if labels == "ids" else np.eye(3, dtype=np.float32)[ids]
    key = jax.random.PRNGKey(7)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    ref_x, ref_y = ja.augment_batch(key, jx, jnp.asarray(y), cfg)
    draws = jax_draws(key, N, SPATIAL, C, cfg)
    port_x, port_y = ta.apply_augmentation(t(x).to(getattr(torch, dtype)), t(y), draws, cfg)
    assert port_x.dtype == getattr(torch, dtype) and port_y.dtype == t(y).dtype
    close(port_x.float().numpy(), np.asarray(ref_x.astype(jnp.float32)),
          TOL if dtype == "float32" else BF16_TOL)
    np.testing.assert_array_equal(port_y.numpy(), np.asarray(ref_y))
    gates = ta._host_gates(draws, ta.resolve_config(cfg))
    if forced:  # every stage ran on some sample
        assert gates["elastic"].any() and gates["affine"].any() and gates["noise"].all()
        assert gates["blur_first"].any() != gates["blur_first"].all() or name == "msseg2"


def test_config_refusals():
    X = torch.zeros(1, 8, 8, 6, 1)
    with pytest.raises(ValueError, match="Unknown augment_batch config keys"):
        ta.augment_batch(torch.Generator(), X, None, {"flip_prob": 0.5})
    with pytest.raises(ValueError, match="cubic"):
        ta.augment_batch(torch.Generator(), X, None, {"permute_p": 1.0})
    with pytest.raises(ValueError, match="warp_gather_dtype"):
        ta.augment_batch(torch.Generator(), X, None, {"warp_gather_dtype": "float16"})
    for batching in ("map", "vmap"):
        ta.augment_batch(torch.Generator(), X, None, {"affine_batching": batching})


def test_bfloat16_gather_rounds_the_taps_only():
    """warp_gather_dtype='bfloat16' at JAX's draws: within bf16 tap
    rounding of JAX's own result, labels bit for bit."""
    cfg = dict(ja.MSSEG2_REFERENCE_CONFIG, oneof_p=1.0, oneof_affine_weight=1.0,
               warp_gather_dtype="bfloat16")
    rng = np.random.default_rng(12)
    x = rng.normal(size=(N, *SPATIAL, C)).astype(np.float32)
    ids = rng.integers(0, 3, size=(N, *SPATIAL)).astype(np.uint8)
    key = jax.random.PRNGKey(3)
    ref_x, ref_y = ja.augment_batch(key, jnp.asarray(x), jnp.asarray(ids), cfg)
    port_x, port_y = ta.apply_augmentation(t(x), t(ids), jax_draws(key, N, SPATIAL, C, cfg), cfg)
    close(port_x.numpy(), np.asarray(ref_x), TOL)
    np.testing.assert_array_equal(port_y.numpy(), np.asarray(ref_y))


# ---------------------------------------------------------------------------
# the port's own draws
# ---------------------------------------------------------------------------

def test_draws_stay_in_range_and_gate_at_the_configured_rates():
    K = 200
    cfg = ta.resolve_config(dict(ta.MSSEG2_REFERENCE_CONFIG, noise_std=(0.05, 0.1)))
    draws = ta.draw_augmentation(torch.Generator().manual_seed(1), K, (6, 6, 6), 2, cfg)
    assert {k: v.shape[0] for k, v in draws.items()} == {k: K for k in draws}
    assert list(draws) == [  # JAX's key slots, in order
        "flip", "affine_gate", "affine", "elastic_gate", "elastic", "bias_gate", "bias",
        "gamma_gate", "gamma", "noise_gate", "noise_sigma", "noise", "blur_gate", "blur",
        "order", "permute_gate", "permute"]
    scale = torch.linalg.det(draws["affine"].double()).abs() ** (1 / 3)
    assert bool(((scale > 0.8) & (scale < 1.2)).all())
    assert bool((draws["elastic"].abs() <= 1).all())
    assert bool((draws["bias"].abs() <= 0.5).all()) and draws["bias"].shape[1] == 20
    assert bool(((draws["gamma"].log() >= -0.3) & (draws["gamma"].log() <= 0.3)).all())
    assert bool(((draws["noise_sigma"] >= 0.05) & (draws["noise_sigma"] <= 0.1)).all())
    assert bool(((draws["blur"] >= 0) & (draws["blur"] <= 1)).all())
    assert set(draws["permute"].tolist()) == set(range(6))
    gates = ta._host_gates(draws, cfg)

    def rate_ok(mask, p):  # within 4.5 binomial standard deviations
        return abs(mask.mean() - p) <= 4.5 * np.sqrt(p * (1 - p) / mask.size) + 1e-12

    assert rate_ok(gates["affine"], 0.75 * 0.8) and rate_ok(gates["elastic"], 0.75 * 0.2)
    assert not (gates["affine"] & gates["elastic"]).any()
    for name, p in (("bias", 0.5), ("gamma", 0.8), ("noise", 0.35), ("blur", 0.2),
                    ("blur_first", 0.5), ("permute", 1.0)):
        assert rate_ok(gates[name], p), name
    assert rate_ok(gates["flip"].ravel(), 0.5)
