"""Swin UNETR in the port (models/swin_unetr.py, ops/window_attention.py,
the InstanceNorm and GEMM convs of models/components.py) against the plain
reference h100_bench/reference/swin_unetr.py, on seeded random weights at
small sizes on the CPU: feature_size 12, heads (1, 2, 3, 6), window 7, so
that the padded windows, the shift masks and the clipped (and mixed) last
stages all occur. The JAX package has no such model."""
import collections

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import segmentation_pipeline_torch as tsp
from h100_bench.reference import swin_unetr as ref
from h100_bench.reference.loss import hybrid_logistic_dice
from h100_bench.reference.predict import sliding_window_average
from segmentation_pipeline_torch.models.components import InstanceNorm
from segmentation_pipeline_torch.ops import window_attention as wa
from segmentation_pipeline_torch.utils import timer

CONFIG = {"input_channels": 1, "output_channels": 14, "feature_size": 12,
          "depths": [2, 2, 2, 2], "num_heads": [1, 2, 3, 6], "window_size": 7,
          "patch_size": 2, "mlp_ratio": 4.0}
# float32 in another order (GEMM convs, the fused attention, Welford
# statistics), amplified by the InstanceNorms of the 2^3-voxel levels: the
# port's logits came within 1.1e-6 of max|ref| at these sizes; a wrong term
# moves them by the logits' own size
FORWARD_TOL = 1e-4
# each leaf's gradient against the larger of its own norm and the median
# leaf's (a leaf whose true gradient is 0, such as a 1-channel 1^3 conv
# before an InstanceNorm, carries only rounding): read up to 9.4e-4
GRAD_TOL = 2e-3


def pair(out_channels=14, seed=0):
    torch.manual_seed(seed)
    program = tsp.SwinUNETR(1, out_channels, feature_size=12, num_heads=(1, 2, 3, 6))
    reference = ref.build({**CONFIG, "output_channels": out_channels})
    reference.load_state_dict(program.state_dict())
    return program, reference


def channels_first(x):
    return x.permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("shape", [(2, 64, 32, 32), (1, 64, 64, 64)])
def test_forward_logits(shape):
    program, reference = pair()
    x = torch.randn(*shape, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = channels_first(program.eval()(x))
        want = reference.eval()(channels_first(x))
    assert got.shape == (shape[0], 14, *shape[1:])
    assert float((got - want).abs().max()) <= FORWARD_TOL * float(want.abs().max())


def test_train_step_loss_and_gradients():
    program, reference = pair(out_channels=3)
    model = tsp.SegModel(program, device="cpu")
    model.load_state_dict(program.state_dict())
    g = torch.Generator().manual_seed(2)
    # 64^3: the last level holds 2^3 voxels (at 64x32x32, 2: an InstanceNorm over two
    # voxels whose values nearly agree is ill-conditioned in any float order)
    x = torch.randn(1, 64, 64, 64, 1, generator=g)
    y = F.one_hot(torch.randint(0, 3, (1, 64, 64, 64), generator=g), 3).float()
    loss = tsp.HybridLogisticDiceLoss()

    def criterion(logits, target):  # the recipe's softmax head, then the port's loss
        return loss(torch.softmax(logits, -1), target)
    optimizer = tsp.SGD(lr=0.1)
    state = tsp.create_train_state(model, optimizer, {"X": channels_first(x).numpy()})
    before = {n: p.detach().clone() for n, p in program.named_parameters()}
    step = tsp.make_train_step(program, criterion, optimizer)
    state, losses, _ = step(state, {"X": x, "y": y}, None)
    grads = {n: p.grad for n, p in program.named_parameters()}
    for name, p in program.named_parameters():  # the SGD update from those gradients
        assert torch.allclose(p.detach(), before[name] - 0.1 * grads[name], rtol=0, atol=1e-7)

    reference.train()
    ref_loss = hybrid_logistic_dice(torch.softmax(reference(channels_first(x)), 1),
                                    channels_first(y))
    ref_loss.backward()
    assert abs(float(losses["loss"]) - float(ref_loss)) <= 1e-6 * float(ref_loss)
    ref_grads = {n: p.grad for n, p in reference.named_parameters()}
    median = float(np.median([float(v.norm()) for v in ref_grads.values()]))
    for name, want in ref_grads.items():
        gap = float((grads[name] - want).norm()) / max(float(want.norm()), median)
        assert gap <= GRAD_TOL, (name, gap)
    assert state.step == 1


@pytest.mark.parametrize("device_argmax", [False, True])
def test_patch_predict_sliding_window(device_argmax):
    program, reference = pair()
    model = tsp.SegModel(program, device="cpu")
    model.load_state_dict(program.state_dict())
    volume = torch.rand(1, 96, 64, 64, generator=torch.Generator().manual_seed(3))
    subject = tsp.Subject(name="ct")
    subject["X"] = tsp.ScalarImage(tensor=volume.numpy().copy(), affine=np.eye(4))
    predictor = tsp.PatchPredict(image_names=["X"], patch_batch_size=2, patch_size=64,
                                 patch_overlap=32, overlap_mode="average",
                                 device_argmax=device_argmax, device="cpu")
    out, batch = predictor.predict(model, [subject])
    got = torch.from_numpy(np.asarray(out[0]["y_pred"].data, dtype=np.float32))
    # the batch's stack of the answers, made at its first access
    assert "y_pred" in batch and list(batch) == ["X", "y_pred"]
    assert np.array_equal(batch["y_pred"], got.numpy()[None])
    with torch.no_grad():
        want = sliding_window_average(volume, reference.eval(), 64, 32)
    if not device_argmax:
        assert float((got - want).abs().max()) <= FORWARD_TOL * float(want.abs().max())
        return
    labels = got.argmax(0)
    top = want.topk(2, dim=0).values
    differs = labels != want.argmax(0)
    # only a near tie may go the other way
    assert not differs.any() or float((top[0] - top[1])[differs].max()) <= 1e-4
    assert got.shape == want.shape and set(got.unique().tolist()) <= {0.0, 1.0}


@pytest.mark.parametrize("dtype,grad", [(torch.float32, False), (torch.float32, True),
                                        (torch.bfloat16, False)])
def test_instance_norm_channels_last(dtype, grad):
    g = torch.Generator().manual_seed(4)
    # a large mean against the spread, where E[x^2] - E[x]^2 would cancel
    x = (torch.randn(2, 9, 7, 5, 6, generator=g) * 0.05 + 3.0).to(dtype)
    x.requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        got = InstanceNorm()(x)
    want = F.instance_norm(channels_first(x.detach().float()), eps=1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    # float32: rounding only; bfloat16: the output's rounding (2^-8 of 4)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((channels_first(got.float()) - want).abs().max()) <= tol
    if grad:
        got.sum().backward()
        assert float(x.grad.abs().max()) <= 1e-3  # the mean's removal: a sum's gradient is 0


def explicit_attention(q, k, v, bias, mask):
    scores = q @ k.transpose(-2, -1) * q.shape[-1] ** -0.5 + bias
    if mask is not None:
        b = q.shape[0] // mask.shape[0]
        scores = (scores.view(b, mask.shape[0], *scores.shape[1:]) + mask[None, :, None])
        scores = scores.view(q.shape[0], *scores.shape[2:])
    return torch.softmax(scores, -1) @ v


@pytest.mark.parametrize("spatial,shifted", [((40, 32, 24), False), ((40, 32, 24), True),
                                             ((6, 6, 6), False), ((16, 6, 4), True)])
def test_window_attention_against_explicit_softmax(spatial, shifted):
    window, shift = wa.window_geometry(spatial, 7, 3 if shifted else 0)
    padded = wa.padded_extent(spatial, window)
    g = torch.Generator().manual_seed(5)
    heads, hd, batch = 2, 16, 2
    x = torch.randn(batch, *spatial, heads * hd, generator=g)
    windows = wa.shifted_windows(x, window, shift)
    n = int(np.prod(window))
    assert windows.shape == (batch * int(np.prod(padded)) // n, n, heads * hd)
    # the window geometry is the reference's: rolled, padded, partitioned
    xr = F.pad(x, (0, 0, *sum(((0, p - s) for p, s in zip(padded[::-1], spatial[::-1])), ())))
    if any(shift):
        xr = torch.roll(xr, tuple(-s for s in shift), dims=(1, 2, 3))
    assert torch.equal(windows, ref.window_partition(xr, window))
    assert torch.equal(wa.merge_windows(windows, window, shift, (batch, *spatial)), x)
    mask = wa.region_mask(padded, window, shift, x.device) if any(shift) else None
    if mask is not None:
        assert torch.equal(mask, ref.compute_mask(padded, window, shift, x.device))
    q, k, v = (torch.randn(windows.shape[0], heads, n, hd, generator=g) for _ in range(3))
    table = torch.randn(13 ** 3, heads, generator=g) * 0.02
    index = wa.relative_index((7, 7, 7), x.device)[:n, :n]
    assert torch.equal(index, ref.relative_position_index((7, 7, 7), x.device)[:n, :n])
    bias = table[index.reshape(-1)].view(n, n, heads).permute(2, 0, 1)
    got = wa.window_attention(q, k, v, bias, mask)
    want = explicit_attention(q, k, v, bias, mask)
    assert float((got - want).abs().max()) <= 1e-5


def test_counters_and_spans():
    program, _ = pair()
    timer.reset()
    profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    profiler.start()
    try:
        with torch.no_grad():
            program.eval()(torch.zeros(2, 64, 32, 32, 1))
    finally:
        profiler.stop()
        rec = timer.recorded()
        timer.reset()
    names = collections.Counter(s.name for s in rec["spans"])
    assert names == {"swin.encoder": 1, "swin.decoder": 1}
    attn = rec["counters"]["window_attention"]
    # (stage, N * windows, tokens, heads, head_dim, shifted, dtype): stage 0 is 32x16x16
    # padded to 35x21x21 (5 * 3 * 3 windows of 343), stage 1 16x8x8 to 21x14x14, stage 2
    # 8x4x4 in windows of (7, 4, 4) shifted by (3, 0, 0), stage 3 4x2x2 in one window
    assert attn == {(0, 90, 343, 1, 12, False, "float32"): 1,
                    (0, 90, 343, 1, 12, True, "float32"): 1,
                    (1, 24, 343, 2, 12, False, "float32"): 1,
                    (1, 24, 343, 2, 12, True, "float32"): 1,
                    (2, 4, 112, 3, 16, False, "float32"): 1,
                    (2, 4, 112, 3, 16, True, "float32"): 1,
                    (3, 2, 16, 6, 16, False, "float32"): 2}
    norms = rec["counters"]["instance_norm"]
    # (N, C, voxels, dtype): encoder1 and decoder1 at full size, with their 1^3 residuals
    assert norms[(2, 12, 64 * 32 * 32, "float32")] == 2 + 1 + 2 + 1
    # five encoder blocks of 2, encoder1's 1^3 residual, five decoder blocks of 3
    assert sum(norms.values()) == 5 * 2 + 1 + 5 * 3
    gemm = rec["counters"]["gemm_conv"]
    # (dtype, N, Cin, Cout, grid, kernel): the patch embedding, six 1^3 residual convs,
    # the out conv
    assert gemm[("float32", 2, 1, 12, (64, 32, 32), (2, 2, 2))] == 1
    assert sum(gemm.values()) == 1 + 6 + 1
    transposed = [k for k in rec["counters"]["library_conv"] if k[1] != "conv"]
    assert len(transposed) == 5  # the five up-samplers, on the library route


def test_seg_model_seeds_and_bf16():
    def initialized(seed):
        model = tsp.SegModel(tsp.SwinUNETR(1, 3, feature_size=12, num_heads=(1, 2, 3, 6)),
                             seed=seed, compute_dtype="bfloat16", device="cpu")
        model.ensure_initialized()
        return model
    a, b, c = initialized(7), initialized(7), initialized(8)
    table = "swinViT.layers1.0.blocks.0.attn.relative_position_bias_table"
    for name, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[name]), name
    assert not torch.equal(a.state_dict()[table], c.state_dict()[table])
    x = torch.randn(1, 1, 64, 32, 32, generator=torch.Generator().manual_seed(6))
    low = a(x)
    a.compute_dtype = None
    exact = a(x)
    assert low.dtype == torch.float32 and low.shape == (1, 3, 64, 32, 32)
    # bfloat16 activations (8 bits of mantissa) through 40 layers
    assert float((low - exact).abs().max()) <= 0.1 * float(exact.abs().max())


def test_chip_smoke_swin_classes(monkeypatch):
    """chip_smoke's table of the 3^3 conv classes of SwinUNETR(1 -> 14) at
    48 features on 96^3, which its swin phase checks on the card, scaled to
    12 features on 32^3 (the same graph at a quarter of every width and a
    third of every extent), against the plain convs one forward runs."""
    import chip_smoke
    from segmentation_pipeline_torch.ops import conv3x3

    counts = collections.Counter()
    plain = conv3x3.conv3x3_s1p1_plain

    def counted(x, kernel):
        counts[(tuple(x.shape[1:4]), x.shape[4], kernel.shape[4])] += 1
        return plain(x, kernel)
    monkeypatch.setattr(conv3x3, "conv3x3_s1p1_plain", counted)
    module = tsp.SwinUNETR(chip_smoke.SWIN_IN, chip_smoke.SWIN_OUT, feature_size=12,
                           num_heads=(1, 2, 3, 6)).eval()
    with torch.no_grad():
        module(torch.zeros(1, 32, 32, 32, chip_smoke.SWIN_IN))

    def width(c):
        return c if c == chip_smoke.SWIN_IN else c // 4
    assert counts == {(tuple(s // 3 for s in spatial), width(cin), width(cout)): n
                      for spatial, cin, cout, n in chip_smoke.SWIN_CONV_CLASSES}
