"""The Swin UNETR serving cell and the msseg2 training cell at small sizes on
the CPU, through the harness's ``overrides``: a whole traced run of each,
the comparison that decides ``correct`` (sound, and refused with a fault
planted in the program), the reference's FLOP count against a hand count,
and the window attention's operations and bytes."""
import itertools
import math
import time

import numpy as np
import pytest
import torch

from h100_bench import harness, roofline_window_attention
from h100_bench.reference import swin_unetr

SMALL = {
    "swin-unetr-btcv-serve-bf16": {
        "config": {"feature_size": 12, "num_heads": [1, 2, 3, 6]},
        "traffic": {"grid": [96, 64], "depths": [64], "pool": 1, "patch": 64, "overlap": 32,
                    "patch_batch": 2, "warmup_requests": 1, "trace_requests": 1, "kept": 1}},
    "msseg2-train-f32": {
        "config": {"filters": [4, 4, 8]},
        "traffic": {"patch": 32, "grid": [48, 48, 40], "semi_axes": [20.0, 20.0, 16.0],
                    "num_workers": 0, "warmup_iterations": 3, "trace_from": 1,
                    "trace_iterations": 15}},  # iterations 1-15: the Dice evaluation of 15
}


def small_driver(workload, seed, workdir):
    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], workload, "workload")
    config = {**harness.load_config(cell["config"]), **SMALL[workload]["config"]}
    traffic = {**harness.load_traffic(cell["traffic"]), **SMALL[workload]["traffic"]}
    driver = harness.load_driver(traffic["driver"]).Driver(config, traffic, seed,
                                                            torch.device("cpu"), workdir)
    driver.setup()
    driver.run(1.0, None, lambda: None)
    driver.release()
    return driver


def judged(workload, driver):
    return harness.judge(driver.check(), harness.load_limits(workload))


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_traced_run_of_the_cell(workload):
    torch.set_num_threads(2)
    result = harness.run_cell(harness.load_spec(), workload, 2 ** 31 + 7, 0.5, True,
                              time.time(), device="cpu", overrides=SMALL[workload])
    assert result["correct"] and not result["failed"] and result["attempted"] >= 1, result
    # the program's spans read here; the device-trace readers need a card
    metrics = result["metrics"]
    names = ("trainer_eval_ms.train", "trainer_dispatch_ms.train") \
        if workload == "msseg2-train-f32" \
        else ("predict_host_ms.serve", "library_conv_launches.serve")
    for name in names:
        assert math.isfinite(metrics[name]["value"]) and metrics[name]["value"] > 0, name


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_passes_and_a_fault_fails(monkeypatch, tmp_path, workload):
    sound = small_driver(workload, 5, str(tmp_path / "sound"))
    correct, table = judged(workload, sound)
    assert correct, table
    if workload == "msseg2-train-f32":
        from segmentation_pipeline_torch.training import trainer

        original = trainer.make_train_step

        def make(*args, **kwargs):
            inner = original(*args, **kwargs)

            def step(state, batch, generator):  # the update dropped
                before = {n: p.detach().clone() for n, p in state.params.items()}
                out = inner(state, batch, generator)
                with torch.no_grad():
                    for n, p in state.params.items():
                        p.copy_(before[n])
                return out
            return step
        monkeypatch.setattr(trainer, "make_train_step", make)
    else:
        from segmentation_pipeline_torch import prediction

        original = prediction.sliding_window_inference

        def altered(*args, **kwargs):  # the logits rolled over the classes
            return original(*args, **kwargs).roll(1, dims=0)
        monkeypatch.setattr(prediction, "sliding_window_inference", altered)
    correct, table = judged(workload, small_driver(workload, 5, str(tmp_path / "fault")))
    assert not correct, table


def test_swin_flops_against_a_hand_count():
    cfg = {"input_channels": 1, "output_channels": 14, "feature_size": 12,
           "depths": [2, 2, 2, 2], "num_heads": [1, 2, 3, 6], "window_size": 7,
           "patch_size": 2, "mlp_ratio": 4.0}
    fs, side = 12, 64
    macs = side ** 3 // 8 * 8 * fs  # the 2^3 stride-2 patch embedding
    # the Swin stages: qkv, proj and attention on the padded windows; the MLP on the
    # tokens; PatchMerging on the merged tokens
    for stage in range(4):
        c, heads, extent = fs * 2 ** stage, cfg["num_heads"][stage], side // 2 ** (stage + 1)
        w = min(7, extent)
        padded = -(-extent // w) * w
        n, windows = w ** 3, (padded // w) ** 3
        tokens = extent ** 3
        per_block = windows * n * (3 * c * c + c * c) + windows * heads * 2 * n * n * (c // heads) \
            + tokens * 8 * c * c
        macs += 2 * per_block + tokens // 8 * 8 * c * 2 * c
    # the residual blocks: two 3^3 convs and, where the width changes, a 1^3 conv
    blocks = [(1, fs, side), (fs, fs, side // 2), (2 * fs, 2 * fs, side // 4),
              (4 * fs, 4 * fs, side // 8), (16 * fs, 16 * fs, side // 32)]
    ups = [(16 * fs, 8 * fs, side // 32), (8 * fs, 4 * fs, side // 16),
           (4 * fs, 2 * fs, side // 8), (2 * fs, fs, side // 4), (fs, fs, side // 2)]
    for cin, cout, s in blocks:
        macs += s ** 3 * (27 * cin * cout + 27 * cout * cout + (cin * cout if cin != cout else 0))
    for cin, cout, s in ups:
        macs += s ** 3 * cin * cout * 8  # the 2^3 stride-2 transposed conv
        up = 2 * s
        macs += up ** 3 * (27 * 2 * cout * cout + 27 * cout * cout + 2 * cout * cout)
    macs += side ** 3 * fs * 14  # the out conv
    assert swin_unetr.flops(cfg, (1, 1, side, side, side)) == 2 * macs


def test_window_attention_operations_and_bytes():
    key = (0, 4 * 343, 343, 3, 16, True, "bfloat16")
    nw = roofline_window_attention.windows_per_volume((96, 96, 96), 2, 7, 0)
    assert nw == 343
    assert roofline_window_attention.windows_per_volume((96, 96, 96), 2, 7, 3) == 1
    assert roofline_window_attention.windows_per_volume((96, 96, 96), 2, 7, 2) == 8
    flops = 4.0 * 4 * 343 * 343 ** 2 * 16 * 3
    assert roofline_window_attention.attention_flops(key) == flops
    elements = 4 * 4 * 343 * 3 * 343 * 16 + 3 * 343 ** 2 + 343 * 343 ** 2
    assert roofline_window_attention.attention_bytes(key, nw) == 2 * elements
    assert roofline_window_attention.attention_bound_s(key, nw) == \
        max(flops / 989e12, 2 * elements / 3.35e12)
    unshifted = key[:5] + (False, "bfloat16")
    assert roofline_window_attention.attention_bytes(unshifted, nw) == \
        2 * (elements - 343 * 343 ** 2)


def test_ct_volumes_and_brain_box():
    from h100_bench import data_ct, data_msseg2

    x = data_ct.ct_volume(np.random.default_rng(3), (40, 32, 24), (1.5, 1.5, 2.0))
    assert x.shape == (1, 40, 32, 24) and x.dtype == np.float32
    assert 0.0 <= x.min() and x.max() <= 1.0 and (x == 0).any() and (x == 1).any()
    volumes = data_msseg2.msseg2_volumes(np.random.default_rng(4), (30, 36, 20), (10, 12, 6))
    mask = volumes["brain_mask"][0]
    box = tuple(int(np.ptp(np.nonzero(mask)[a]) + 1) for a in range(3))
    assert box == data_msseg2.brain_box((30, 36, 20), (10, 12, 6))
    assert (volumes["ground_truth"] <= volumes["brain_mask"]).all()
    assert set(itertools.chain(*[np.unique(volumes[k]).tolist()
                                 for k in ("brain_mask", "ground_truth")])) <= {0, 1}
