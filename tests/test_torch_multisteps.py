"""Gradient accumulation (``accumulate_steps > 1``): the port's ``MultiSteps``
against ``optax.MultiSteps``, which the JAX package's optimizer factories
build, and NestedResUNet's ``use_norm=False`` (the network accumulation is
compared on) against the JAX package's, with weights converted from the
flax tree. On the CPU; numpy inputs from a seed go through both packages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import segmentation_pipeline_torch as tsp
from segmentation_pipeline_tpu.criterions import HybridLogisticDiceLoss as JLoss
from segmentation_pipeline_tpu.models import NestedResUNet as JNestedResUNet
from segmentation_pipeline_tpu.training import optimizers as joptim
from segmentation_pipeline_tpu.training import train_step as jtrain
from segmentation_pipeline_tpu.training.model import SegModel as JSegModel
from segmentation_pipeline_torch.models import flax_to_state_dict, state_dict_to_flax
from segmentation_pipeline_torch.training import optimizers as toptim
from segmentation_pipeline_torch.training.context import to_host
from segmentation_pipeline_torch.training.trainer import _to_torch

torch.set_num_threads(2)

# Parameters and moments after each micro-step: the same float32 arithmetic
# as optax's in another order, rounding of O(1) values (the bound the plain
# optimizers are held to in test_torch_train.py). The counters are equal.
STATE_TOL = dict(atol=1e-6, rtol=1e-6)
OPTIMIZERS = {
    "adam": ("Adam", {"lr": 1e-2}),
    "adam-weight-decay": ("Adam", {"lr": 1e-2, "weight_decay": 0.1}),
    "adamw": ("Adam", {"lr": 1e-2, "weight_decay": 0.1, "decoupled": True}),
    "sgd-momentum": ("SGD", {"lr": 0.1, "momentum": 0.9}),
    "sgd-nesterov-weight-decay": ("SGD", {"lr": 0.1, "momentum": 0.9, "nesterov": True,
                                          "weight_decay": 0.05}),
}
MICRO_STEPS = 4


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _inner(state, cls):
    """The optax state of class name ``cls`` inside a (nested) chain state."""
    if type(state).__name__ == cls:
        return state
    if isinstance(state, tuple):
        for s in state:
            found = _inner(s, cls)
            if found is not None:
                return found
    return None


def _torch_moments(opt, params, name):
    """The inner torch optimizer's state in optax's layout."""
    state = [opt.optimizer.state.get(p, {}) for p in params]
    if name == "Adam":
        if not state[0]:
            return None
        return {"count": float(state[0]["step"]),
                "mu": [s["exp_avg"].numpy() for s in state],
                "nu": [s["exp_avg_sq"].numpy() for s in state]}
    if not state[0]:
        return None
    return {"trace": [s["momentum_buffer"].numpy() for s in state]}


def _optax_moments(inner, name):
    if name == "Adam":
        adam = _inner(inner, "ScaleByAdamState")
        if int(adam.count) == 0:
            return None
        return {"count": float(adam.count), "mu": [np.asarray(m) for m in adam.mu],
                "nu": [np.asarray(v) for v in adam.nu]}
    trace = _inner(inner, "TraceState")
    if not np.any([np.any(np.asarray(t)) for t in trace.trace]):
        return None
    return {"trace": [np.asarray(t) for t in trace.trace]}


@pytest.mark.parametrize("every_k", [2, 3])
@pytest.mark.parametrize("config", list(OPTIMIZERS))
def test_multisteps_matches_optax(config, every_k):
    """Four micro-steps of random gradients on two parameters: after each,
    the parameters, the counters (mini_step, gradient_step), the
    accumulated mean and the inner optimizer's moments equal optax's."""
    name, kwargs = OPTIMIZERS[config]
    shapes = [(6, 5), (4,)]
    init = [_normal(s, i) for i, s in enumerate(shapes)]
    tx = getattr(joptim, name)(accumulate_steps=every_k, **kwargs)
    jparams = [jnp.asarray(p) for p in init]
    jstate = tx.init(jparams)
    assert type(jstate).__name__ == "MultiStepsState"
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = getattr(toptim, name)(accumulate_steps=every_k, **kwargs).init(params)
    assert isinstance(opt, toptim.MultiSteps)
    for step in range(MICRO_STEPS):
        grads = [_normal(s, 10 * step + i + 2) for i, s in enumerate(shapes)]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = [p.detach().clone() for p in params]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        emitted = opt.step()
        assert emitted == ((step + 1) % every_k == 0)
        assert (opt.mini_step, opt.gradient_step) == \
            (int(jstate.mini_step), int(jstate.gradient_step)) == \
            ((step + 1) % every_k, (step + 1) // every_k)
        for p, jp, b in zip(params, jparams, before):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), **STATE_TOL)
            if not emitted:  # banked: the parameters do not move at all
                assert torch.equal(p.detach(), b)
        for acc, jacc in zip(opt.acc_grads, jstate.acc_grads):
            np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), **STATE_TOL)
        ours, theirs = _torch_moments(opt, params, name), _optax_moments(
            jstate.inner_opt_state, name)
        assert (ours is None) == (theirs is None)
        for key in theirs or {}:
            for a, b in zip(np.atleast_1d(ours[key]) if key == "count" else ours[key],
                            np.atleast_1d(theirs[key]) if key == "count" else theirs[key]):
                np.testing.assert_allclose(a, b, **STATE_TOL, err_msg=key)


def test_multisteps_state_dict_resumes_bit_for_bit():
    """A MultiSteps restored from its state dict mid-window (counters,
    accumulated gradients, inner moments) takes the next micro-steps
    exactly as the one it was saved from."""
    def make():
        p = torch.nn.Parameter(torch.from_numpy(_normal((5, 3), 0)))
        return p, toptim.Adam(lr=1e-2, accumulate_steps=3).init([p])

    p, opt = make()
    for step in range(4):
        p.grad = torch.from_numpy(_normal((5, 3), step + 1))
        opt.step()
    # as a checkpoint carries it: host copies, back to tensors on load
    saved = _to_torch(to_host(opt.state_dict()))
    q, resumed = make()
    with torch.no_grad():
        q.copy_(p)
    resumed.load_state_dict(saved)
    assert (resumed.mini_step, resumed.gradient_step) == (1, 1)
    for step in range(4, 7):
        for param, o in ((p, opt), (q, resumed)):
            param.grad = torch.from_numpy(_normal((5, 3), step + 1))
            o.step()
        assert torch.equal(p, q)
        assert all(torch.equal(a, b) for a, b in zip(opt.acc_grads, resumed.acc_grads))


SHAPE = (16, 16, 8)


def _batch(n, seed, classes=10):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2, *SHAPE)).astype(np.float32)
    ids = rng.integers(0, classes, size=(n, *SHAPE))
    return {"X": X, "y": np.moveaxis(np.eye(classes, dtype=np.float32)[ids], -1, 1)}


@pytest.fixture(scope="module")
def variables():
    """qsm's network family without BatchNorm, at filters 4."""
    jnet = JNestedResUNet(input_channels=2, output_channels=10, filters=4, use_norm=False)
    init = jax.jit(functools.partial(jnet.init, train=False))
    x = jnp.zeros((1, *SHAPE, 2))
    return jnet, jax.tree_util.tree_map(np.asarray, init({"params": jax.random.PRNGKey(3)}, x))


def test_nested_res_unet_without_norm_matches_jax(variables):
    """Converted weights (a tree without batch_stats): the eval forward
    within 1e-5 of max|ref| (f32 through 25 convs in another order), and
    the bridge round trip exact."""
    jnet, v = variables
    assert "batch_stats" not in v
    net = tsp.NestedResUNet(2, 10, filters=4, use_norm=False).eval()
    state = flax_to_state_dict(v)
    assert not any("BatchNorm" in k for k in state)
    net.load_state_dict(state)
    x = _normal((2, *SHAPE, 2), 7)
    ref = np.asarray(jax.jit(functools.partial(jnet.apply, train=False))(v, jnp.asarray(x)))
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    back = flatten_dict(state_dict_to_flax(net.state_dict()))
    assert back.keys() == flatten_dict(v).keys()
    assert all(np.array_equal(back[k], a) for k, a in flatten_dict(v).items())


def _jax_micro_steps(variables, optimizer, batches):
    jnet, v = variables
    model = JSegModel(jnet)
    model.load_state_dict(v)
    state = jtrain.create_train_state(model, optimizer, batches[0])
    step = jtrain.make_train_step(jnet, JLoss(), optimizer)
    out = []
    for i, b in enumerate(batches):
        state, _, _ = step(state, jtrain.collate_to_device(b), jax.random.PRNGKey(i))
        out.append({k: t.numpy() for k, t in flax_to_state_dict(
            {"params": jax.tree_util.tree_map(np.asarray, state.params)}).items()})
    return out, state.opt_state


def _port_micro_steps(variables, optimizer, batches):
    model = tsp.SegModel(tsp.NestedResUNet(2, 10, filters=4, use_norm=False), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables[1]))
    state = tsp.create_train_state(model, optimizer, batches[0])
    step = tsp.make_train_step(model.module, tsp.HybridLogisticDiceLoss(), optimizer)
    out = []
    for b in batches:
        state, _, _ = step(state, tsp.collate_to_device(b, device="cpu"), None)
        out.append({k: p.detach().numpy().copy() for k, p in state.params.items()})
    return out, state.opt_state


def test_network_micro_steps_match_jax(variables):
    """SGD with momentum and accumulate_steps=2 over four micro-batches of
    two: after each micro-step the parameters match JAX's (f32 through 25
    convs forward and backward in another order, as test_torch_train_step.py
    holds SGD steps: atol 2e-5, rtol 1e-4); after the banked ones they have
    not moved at all; the counters are equal."""
    batches = [_batch(2, seed) for seed in (5, 6, 7, 8)]
    kwargs = {"lr": 0.05, "momentum": 0.9, "accumulate_steps": 2}
    ref, jstate = _jax_micro_steps(variables, joptim.SGD(**kwargs), batches)
    ours, opt = _port_micro_steps(variables, tsp.SGD(**kwargs), batches)
    init = flax_to_state_dict(variables[1])
    for i, (r, o) in enumerate(zip(ref, ours)):
        before = ours[i - 1] if i else {k: t.numpy() for k, t in init.items()}
        for key in r:
            np.testing.assert_allclose(o[key], r[key], atol=2e-5, rtol=1e-4,
                                       err_msg=f"micro-step {i}: {key}")
        moved = [key for key in r if not np.array_equal(o[key], before[key])]
        # banked micro-steps move nothing; JAX's parameters move where ours do
        assert moved == ([] if i % 2 == 0 else [
            key for key in r if not np.array_equal(r[key], ref[i - 1][key])]), i
        assert i % 2 == 0 or len(moved) > len(r) // 2, i
    assert (opt.mini_step, opt.gradient_step) == \
        (int(jstate.mini_step), int(jstate.gradient_step)) == (0, 2)


def test_micro_batch_accumulation_matches_the_full_batch(variables):
    """The qsm recipe's claim on the port: Adam(accumulate_steps=2) over the
    two halves of each batch of four reproduces Adam steps on the batches of
    four, with no batch statistics (use_norm=False) and no dropout, since
    the loss is a mean of per-subject terms. Tolerance as the JAX package's
    own test of the claim (tests/test_parallel.py, rtol 1e-5, atol 1e-7)."""
    batches = [_batch(4, seed) for seed in (8, 9)]
    micro = [{k: v[half] for k, v in b.items()} for b in batches
             for half in (slice(0, 2), slice(2, 4))]
    full, _ = _port_micro_steps(variables, tsp.Adam(lr=2e-4), batches)
    accumulated, opt = _port_micro_steps(variables, tsp.Adam(lr=2e-4, accumulate_steps=2),
                                         micro)
    assert opt.gradient_step == 2 and float(opt.optimizer.state[
        next(iter(opt.optimizer.state))]["step"]) == 2.0
    for key, ref in full[-1].items():
        np.testing.assert_allclose(accumulated[-1][key], ref, rtol=1e-5, atol=1e-7, err_msg=key)
