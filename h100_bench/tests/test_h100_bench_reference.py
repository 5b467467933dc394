"""The plain references against the program's modules at small sizes on
the CPU, with the same weights, and the yardstick's operation and byte
counts against hand counts."""
import numpy as np
import pytest
import torch

import segmentation_pipeline_torch as tsp
from h100_bench import data, roofline
from h100_bench.reference import augment as ref_augment
from h100_bench.reference import layers, modular_unet, nested_res_unet
from h100_bench.reference.loss import hybrid_logistic_dice
from h100_bench.reference.predict import merge_halves, split_and_flip

CPU = torch.device("cpu")


def channels_first(x):
    return x.permute(0, 4, 1, 2, 3)


def test_nested_res_unet_forward_and_gradients():
    cfg = {"input_channels": 3, "output_channels": 2, "filters": 4, "dropout_p": 0.2}
    program = tsp.NestedResUNet(3, 2, filters=4, dropout_p=0.2)
    weights = data.make_weights(program.state_dict(), 7, CPU)
    program.load_state_dict(weights)
    reference = nested_res_unet.build(cfg)
    reference.load_state_dict(weights)
    x = torch.randn(2, 16, 16, 8, 3)
    program.eval(), reference.eval()
    with torch.no_grad():
        assert torch.allclose(channels_first(program(x)), reference(channels_first(x)),
                              atol=1e-6)
    program.train(), reference.train()
    outs, grads = [], []
    for net, inp in ((program, x), (reference, channels_first(x))):
        g = torch.Generator().manual_seed(3)
        y = net(inp, g)
        y = channels_first(y) if net is program else y
        (y[:, 1] ** 2).sum().backward()
        outs.append(y.detach())
        grads.append({n: p.grad for n, p in net.named_parameters()})
    assert torch.allclose(outs[0], outs[1], atol=1e-6)
    for name, grad in grads[1].items():
        assert float((grads[0][name] - grad).norm()) <= 1e-4 * float(grad.norm()) + 1e-6, name


def test_modular_unet_forward():
    cfg = {"input_channels": 2, "output_channels": 2, "filters": [4, 4, 8]}
    program = tsp.ModularUNet(2, 2, filters=[4, 4, 8], depth=3, block_params={"residual": True},
                              downsample_class=tsp.BlurConv3d,
                              downsample_params={"kernel_size": 3, "stride": 2, "padding": 1},
                              upsample_class=tsp.BlurConvTranspose3d,
                              upsample_params={"kernel_size": 3, "stride": 2, "padding": 1,
                                               "output_padding": 0})
    weights = data.make_weights(program.state_dict(), 8, CPU)
    program.load_state_dict(weights)
    reference = modular_unet.build(cfg)
    reference.load_state_dict(weights)
    x = torch.randn(1, 16, 16, 16, 2)
    with torch.no_grad():
        assert torch.allclose(channels_first(program.eval()(x)), reference.eval()(channels_first(x)),
                              atol=1e-6)


def test_loss_and_split():
    p = torch.softmax(torch.randn(2, 8, 6, 4, 2), -1)
    t = torch.nn.functional.one_hot(torch.randint(0, 2, (2, 8, 6, 4)), 2).float()
    program = tsp.HybridLogisticDiceLoss()(p, t)["loss"]
    assert torch.allclose(program, hybrid_logistic_dice(channels_first(p), channels_first(t)))
    x = torch.randn(2, 3, 8, 4, 4)
    assert torch.equal(merge_halves(split_and_flip(x)), x)


def test_augmentation_equals_the_program_at_the_same_draws():
    from segmentation_pipeline_torch.ops import augment as program

    spacing = tuple(float(np.float32(s)) for s in data.HIPPO_SPACING)
    cfg = dict(program.DMRI_REFERENCE_CONFIG, blur_spacing=spacing,
               elastic_max_displacement=tuple(7.5 / s for s in spacing))
    X = torch.rand(4, 16, 16, 8, 3) * 2 - 1
    y = (torch.rand(4, 16, 16, 8) > 0.7).to(torch.uint8)
    for seed in range(4):
        px, py = program.augment_batch(torch.Generator().manual_seed(seed), X, y, config=cfg)
        rx, ry = ref_augment.augment(torch.Generator().manual_seed(seed), X, y,
                                     ref_augment.config(spacing))
        assert torch.equal(px, rx) and torch.equal(py, ry)


def test_conv_counts_against_hand_counts():
    key = ("torch.float32", 8, 48, 88, 24, 40, 40)
    voxels = 8 * 48 * 88 * 24
    assert roofline.conv3x3_flops(key) == 2 * voxels * 40 * 40 * 27
    assert roofline.conv3x3_bytes("fwd", key) == 4 * (2 * voxels * 40 + 27 * 40 * 40)
    bound = roofline.conv3x3_bound_s("fwd", key)
    assert bound == max(2 * voxels * 1600 * 27 / 495e12, 4 * (2 * voxels * 40 + 43200) / 3.35e12)
    assert roofline.conv3x3_flops(("torch.bfloat16", 1, 2, 2, 2, 3, 5)) == 2 * 8 * 15 * 27


def test_meta_flop_count_is_the_conv_sum():
    cfg = {"input_channels": 3, "output_channels": 2, "filters": 4}
    flops = layers.conv_flops_meta(nested_res_unet.build(cfg), (2, 3, 16, 16, 8))
    # by hand: every block's convs at its level, the out conv
    f, total = 4, 0
    for name, width, residual in nested_res_unet.BLOCKS:
        level = int(name[4])
        voxels = 2 * (16 * 16 * 8) // 8 ** level
        cin = 3 if width == 0 else width * f
        total += voxels * 27 * (cin * f + f * f + (cin * f if residual else 0))
    total += 2 * 16 * 16 * 8 * 27 * f * 2
    assert flops == 2 * total


@pytest.mark.parametrize("mode", ["tf32", "fp8"])
def test_lower_precision_moves_the_reference(mode):
    x, w = torch.randn(1, 4, 8, 8, 8), torch.randn(4, 4, 3, 3, 3)
    exact = layers.conv3d(x, w, padding=1)
    with layers.precision(mode):
        low = layers.conv3d(x, w, padding=1)
    assert 0 < float((low - exact).abs().max()) < 0.5 * float(exact.abs().max())
