#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (segmentation_pipeline_torch) on one
NVIDIA GPU, and check what it computes.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the run with a non-zero exit code:

1. card: the card's name and power limit (nvidia-smi); TF32 off for
   convolutions and matmuls, so float32 stays float32 everywhere.
2. build: nvcc builds the CUDA kernel from segmentation_pipeline_torch/csrc.
3. kernels: the 3x3x3 conv kernel at each (spatial size, Cin, Cout) class of
   NestedResUNet-40 at the serving batch (8 half-volumes), in float32 and
   bfloat16, held against its plain PyTorch version on the same inputs and
   timed with CUDA events beside the plain version, F.conv3d (cuDNN) and the
   card's bound.
4. slice: dmri_hippo whole-volume inference, as a user calls it:
   StandardPredict(sagittal_split=True, device_argmax=True).predict on
   SegModel(NestedResUNet(3 -> 2, filters=40)) with random weights made in the
   flax layout from --seed and loaded through the weight bridge. Three
   float32 requests of 4 subjects of 3x96x88x24, then one bfloat16 request.
   Checks the kernel's launch counts, the one-hot answers and their affines,
   the first subject against the port run on the CPU, and a NIfTI round trip.
   One more float32 request runs under torch.profiler for the device time by
   kernel and the device's idle share.

The line before the last is a JSON object listing every kernel; the last line
is {"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from segmentation_pipeline_torch import LabelMap, ScalarImage, Subject
from segmentation_pipeline_torch.core.nifti import read_nifti, write_nifti
from segmentation_pipeline_torch.models import NestedResUNet, flax_to_state_dict
from segmentation_pipeline_torch.ops import build, conv3x3
from segmentation_pipeline_torch.ops.conv3x3 import conv3x3_s1p1, conv3x3_s1p1_plain
from segmentation_pipeline_torch.prediction import (StandardPredict, reverse_split_and_flip,
                                                    split_and_flip)
from segmentation_pipeline_torch.training.model import SegModel

# H100 SXM data-sheet peaks (dense): CUDA-core float32, tensor-core bf16, HBM3.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

# NestedResUNet(3 -> 2, filters=40) at the dmri_hippo crop 96x88x24 after the
# sagittal split: ((W, H, D), Cin, Cout, launches per forward).
CONV_CLASSES = [
    ((48, 88, 24), 3, 40, 2), ((48, 88, 24), 40, 40, 4),
    ((48, 88, 24), 80, 40, 6), ((48, 88, 24), 40, 2, 1),
    ((24, 44, 12), 40, 40, 4), ((24, 44, 12), 120, 40, 2),
    ((12, 22, 6), 40, 40, 3), ((12, 22, 6), 120, 40, 1),
    ((6, 11, 3), 40, 40, 2),
]
CONVS_PER_FORWARD = 25
SUBJECTS_PER_REQUEST = 4
CROP = (96, 88, 24)
IN_CHANNELS, OUT_CHANNELS, FILTERS = 3, 2, 40
# (name, input width in units of filters (0: the network's input), residual)
BLOCKS = [("conv0_0", 0, True), ("conv1_0", 1, False), ("conv0_1", 2, True),
          ("conv2_0", 1, False), ("conv1_1", 3, False), ("conv0_2", 2, True),
          ("conv3_0", 1, False), ("conv2_1", 3, False), ("conv1_2", 3, False),
          ("conv0_3", 2, True)]
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# Kernel against its plain float32 version on the same inputs, relative to
# max|ref|: float32 sums in another order; bfloat16 adds one rounding of the
# output to 8 mantissa bits.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The card's float32 answer against the port on the CPU: rounding only.
CPU_PROB_TOL = 1e-4
CPU_TIE = 1e-3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, trials: int = 15, calls: int = 5) -> float:
    """Median over ``trials`` of CUDA-event time per call, each trial timing
    ``calls`` back-to-back calls after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound_ms(n, spatial, cin, cout, dtype):
    voxels = n * spatial[0] * spatial[1] * spatial[2]
    flops = 2 * voxels * 27 * cin * cout
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (voxels * (cin + cout) + 27 * cin * cout) * size
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(device, batch: int, seed: int, card: str):
    """Each conv class in f32 and bf16: check against the plain version and
    time kernel, plain version and F.conv3d."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for spatial, cin, cout, _ in CONV_CLASSES:
            x = torch.rand((batch, *spatial, cin), generator=gen, device=device) * 2 - 1
            bound = 1 / np.sqrt(27 * cin)
            k = (torch.rand((3, 3, 3, cin, cout), generator=gen, device=device) * 2 - 1) * bound
            x, k = x.to(dtype), k.to(dtype)
            out = conv3x3_s1p1(x, k)
            ref = conv3x3_s1p1_plain(x.float(), k.float())
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            scale = ref.abs().max().item()
            name = f"conv3x3_s1p1_{DTYPE_NAMES[dtype]} {batch}x{'x'.join(map(str, spatial))} " \
                   f"{cin}->{cout}"
            if not (out.shape == ref.shape and err <= KERNEL_TOL[dtype] * scale):
                raise AssertionError(f"{name}: max abs err {err} > {KERNEL_TOL[dtype]} * {scale}")
            x_ncdhw = x.permute(0, 4, 1, 2, 3).contiguous()
            w_oi = k.permute(4, 3, 0, 1, 2).contiguous()
            b_ms, b_by = bound_ms(batch, spatial, cin, cout, dtype)
            rows.append({
                "name": name,
                "route": "cuda",
                "source": "segmentation_pipeline_torch/csrc/conv3x3_s1p1.cu",
                "replaces": "segmentation_pipeline_tpu/ops/pallas_conv.py:64",
                "launches": None,
                "max_abs_err": err,
                "ms": time_ms(lambda: conv3x3_s1p1(x, k)),
                "plain_ms": time_ms(lambda: conv3x3_s1p1_plain(x, k), trials=10, calls=1),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": time_ms(lambda: F.conv3d(x_ncdhw, w_oi, padding=1)),
                "_key": (str(dtype), batch, *spatial, cin, cout),
            })
            print(f"kernel {name}: err {err:.3g} (max|ref| {scale:.3g}) "
                  f"ms {rows[-1]['ms']:.4f} plain {rows[-1]['plain_ms']:.4f} "
                  f"cuDNN {rows[-1]['library_ms']:.4f} bound {b_ms:.4f} ({b_by}) [{card}]",
                  flush=True)
            del x, k, out, ref, x_ncdhw, w_oi
    return rows


def flax_weights(rng: np.random.Generator):
    """Random NestedResUNet(3 -> 2, filters=40) variables in the flax layout:
    torch's conv init, BatchNorm statistics with positive, non-unit
    variances."""
    def conv(cin, cout, bias):
        bound = 1 / np.sqrt(27 * cin)
        out = {"kernel": rng.uniform(-bound, bound, (3, 3, 3, cin, cout)).astype(np.float32)}
        if bias:
            out["bias"] = rng.uniform(-bound, bound, cout).astype(np.float32)
        return out

    def norm():
        return ({"scale": rng.uniform(0.8, 1.2, FILTERS).astype(np.float32),
                 "bias": rng.normal(0, 0.1, FILTERS).astype(np.float32)},
                {"mean": rng.normal(0, 0.05, FILTERS).astype(np.float32),
                 "var": rng.uniform(0.05, 0.2, FILTERS).astype(np.float32)})

    params, stats = {}, {}
    for name, width, residual in BLOCKS:
        cin = IN_CHANNELS if width == 0 else width * FILTERS
        block, block_stats = {}, {}
        for i, c in enumerate((cin, FILTERS)):
            block[f"Conv3d_{i}"] = conv(c, FILTERS, bias=False)
            block[f"BatchNorm_{i}"], block_stats[f"BatchNorm_{i}"] = norm()
        if residual:
            block["res_conv"] = conv(cin, FILTERS, bias=True)
        params[name], stats[name] = block, block_stats
    params["out_conv"] = conv(FILTERS, OUT_CHANNELS, bias=True)
    return {"params": params, "batch_stats": stats}


def make_subjects(volumes):
    subjects = []
    for i, vol in enumerate(volumes):
        affine = np.diag([1.2, 1.2, 1.5, 1.0])
        affine[:3, 3] = [-57.0 + i, -52.0, -18.0]
        s = Subject(name=f"sub-{i:03d}")
        s["X"] = ScalarImage(tensor=vol, affine=affine)
        subjects.append(s)
    return subjects


def check_answers(subjects, batch):
    assert tuple(batch["y_pred"].shape) == (len(subjects), OUT_CHANNELS, *CROP)
    assert torch.isfinite(batch["y_pred"]).all().item()
    for s in subjects:
        y = s["y_pred"]
        assert isinstance(y, LabelMap) and y.data.shape == (OUT_CHANNELS, *CROP), y
        assert set(np.unique(y.data)) <= {0.0, 1.0} and (y.data.sum(0) == 1).all()
        assert np.array_equal(y.affine, s["X"].affine)
        assert len(s.history) == 1


def expected_launches(dtype, requests, batch):
    return Counter({(str(dtype), batch, *spatial, cin, cout): n * requests
                    for spatial, cin, cout, n in CONV_CLASSES})


def run_requests(model, predictor, subjects, requests):
    """Answer ``requests`` requests of SUBJECTS_PER_REQUEST subjects; the
    kernel's counts are set to 0 just before and read just after."""
    conv3x3_s1p1.launches = 0
    conv3x3_s1p1.launches_by_shape.clear()
    torch.cuda.reset_peak_memory_stats()
    times, batches = [], []
    for r in range(requests):
        group = subjects[r * SUBJECTS_PER_REQUEST:(r + 1) * SUBJECTS_PER_REQUEST]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, batch = predictor.predict(model, group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check_answers(group, batch)
        batches.append(batch)
    return times, batches, conv3x3_s1p1.launches, Counter(conv3x3_s1p1.launches_by_shape)


def profile_request(model, predictor, subjects, card):
    """One more request under torch.profiler: device time by kernel, and the
    share of the request's wall time in which the device is busy (one
    stream, so kernel times do not overlap). The profiler's own overhead
    lengthens this request's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        predictor.predict(model, subjects)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an operator's own entry repeats the device
    # time of the kernels it launched
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print(f"profile: no device time traced; busy share not measured [{card}]")
        return
    print(f"profile (f32 request): wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f} [{card}]")
    for e in events[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:90]}")
    conv_ms = sum(e.self_device_time_total for e in events if "conv3x3_s1p1" in e.key) / 1e3
    print(f"profile: conv3x3_s1p1 kernel {conv_ms:.3f} ms of {busy_ms:.3f} ms device time",
          flush=True)


def slice_phase(card, seed, rows):
    rng = np.random.default_rng(seed)
    state = flax_to_state_dict(flax_weights(rng))
    assert all((v > 0).all() and not torch.equal(v, torch.ones_like(v))
               for k, v in state.items() if k.endswith("running_var"))
    model = SegModel(NestedResUNet(IN_CHANNELS, OUT_CHANNELS, filters=FILTERS, dropout_p=0.2),
                     device="cuda")
    model.load_state_dict(state)
    volumes = [rng.uniform(-1, 1, (IN_CHANNELS, *CROP)).astype(np.float32) for _ in range(12)]
    predictor = StandardPredict(sagittal_split=True, image_names=["X"], device_argmax=True)
    half_batch = 2 * SUBJECTS_PER_REQUEST

    subjects = make_subjects(volumes)
    times, batches, launches, by_shape = run_requests(model, predictor, subjects, 3)
    peak = torch.cuda.max_memory_allocated()
    assert launches == 3 * CONVS_PER_FORWARD, launches
    assert by_shape == expected_launches(torch.float32, 3, half_batch), by_shape
    for t in times:
        print(f"slice f32 request: {t:.3f} ms, {SUBJECTS_PER_REQUEST / t * 1e3:.3f} volumes/s "
              f"[{card}]")
    med = statistics.median(times)
    print(f"slice f32: median {med:.3f} ms per request, "
          f"{SUBJECTS_PER_REQUEST / med * 1e3:.3f} volumes/s, "
          f"max_memory_allocated {peak} bytes [{card}]", flush=True)

    # The first subject of the first request against the port on the CPU.
    torch.set_num_threads(os.cpu_count() or 1)
    cpu_model = SegModel(NestedResUNet(IN_CHANNELS, OUT_CHANNELS, filters=FILTERS),
                         device="cpu")
    cpu_model.load_state_dict(state)
    x0 = torch.from_numpy(volumes[0])[None]
    t0 = time.perf_counter()
    p_cpu = reverse_split_and_flip(cpu_model(split_and_flip(x0)))[0]
    cpu_s = time.perf_counter() - t0
    p_gpu = batches[0]["y_pred"][0].cpu()
    diff = (p_gpu - p_cpu).abs().max().item()
    labels_cpu = p_cpu.argmax(0)
    differ = torch.from_numpy(np.argmax(subjects[0]["y_pred"].data, 0)) != labels_cpu
    bad = (differ & ((p_cpu[1] - p_cpu[0]).abs() >= CPU_TIE)).sum().item()
    print(f"slice f32 vs CPU port (first subject): max abs prob diff {diff:.3g}, "
          f"{differ.sum().item()} labels differ, {bad} of them "
          f"outside |p1-p0| < {CPU_TIE}; CPU took {cpu_s:.1f} s; "
          f"probability spread {p_cpu[1].min().item():.3f}..{p_cpu[1].max().item():.3f}, "
          f"foreground share {labels_cpu.float().mean().item():.3f}", flush=True)
    assert diff <= CPU_PROB_TOL and bad == 0

    profile_request(model, predictor, make_subjects(volumes[:SUBJECTS_PER_REQUEST]), card)

    model.compute_dtype = "bfloat16"
    # one untimed, uncounted bf16 request first: the one-time costs of the
    # bf16 path (loading its PyTorch kernels, growing the allocator) stay out
    # of the timed one, as the median keeps them out of the f32 numbers
    predictor.predict(model, make_subjects(volumes[-SUBJECTS_PER_REQUEST:]))
    bf16_subjects = make_subjects(volumes[:SUBJECTS_PER_REQUEST])
    times_bf, batches_bf, launches_bf, by_shape_bf = run_requests(
        model, predictor, bf16_subjects, 1)
    peak_bf = torch.cuda.max_memory_allocated()
    assert launches_bf == CONVS_PER_FORWARD, launches_bf
    assert by_shape_bf == expected_launches(torch.bfloat16, 1, half_batch), by_shape_bf
    label_agree = np.mean([(np.argmax(a["y_pred"].data, 0) == np.argmax(b["y_pred"].data, 0)
                            ).mean() for a, b in zip(bf16_subjects, subjects)])
    bf_diff = (batches_bf[0]["y_pred"] - batches[0]["y_pred"]).abs().max().item()
    print(f"slice bf16 request: {times_bf[0]:.3f} ms, "
          f"{SUBJECTS_PER_REQUEST / times_bf[0] * 1e3:.3f} volumes/s, max_memory_allocated "
          f"{peak_bf} bytes; against f32: max abs prob diff {bf_diff:.3g}, voxel labels "
          f"agree {label_agree:.5f} [{card}]", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "y_pred.nii.gz")
        y = subjects[0]["y_pred"]
        write_nifti(path, y.data, y.affine)
        data, affine = read_nifti(path)
        assert np.array_equal(data, y.data)
        assert np.allclose(affine, y.affine, atol=1e-5)

    for row in rows:
        got = by_shape if row["_key"][0] == str(torch.float32) else by_shape_bf
        row["launches"] = got[row["_key"]]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    build.build([conv3x3.SOURCE])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    print(build.build_logs.get(conv3x3.SOURCE, "(library was already built)").strip(),
          flush=True)

    rows = kernel_phase(torch.device("cuda"), 2 * SUBJECTS_PER_REQUEST, args.seed, card)
    slice_phase(card, args.seed, rows)

    for row in rows:
        del row["_key"]
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
