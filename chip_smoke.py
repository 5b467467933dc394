#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (segmentation_pipeline_torch) on one
NVIDIA GPU, and check what it computes.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the run with a non-zero exit code:

1. card: the card's name and power limit (nvidia-smi); TF32 off for
   convolutions and matmuls, so float32 stays float32 everywhere.
2. build: nvcc builds both CUDA sources from segmentation_pipeline_torch/csrc
   (the conv kernel, which also runs the input gradient dX, and the weight
   gradient dW), in parallel, and prints their -Xptxas -v logs.
3. kernels: the 3x3x3 conv kernel at each (spatial size, Cin, Cout) class of
   NestedResUNet-40 at the serving batch (8 half-volumes), in float32 (3xTF32
   on the tensor cores) and bfloat16 (tensor cores), held against its plain
   PyTorch version on the same inputs (also bit for bit on small-integer
   inputs) and timed with CUDA events beside the plain version, F.conv3d
   (cuDNN) and the card's bound (float32: the 3xTF32 bound, with the
   CUDA-core one beside it).
4. gradient kernels: dX at every input-gradient class of the train step (the
   forward classes with Cin and Cout swapped, except the convs that read the
   network's input) and dW at every forward class, at the training batch
   (the same 8 half-volumes), in float32 (3xTF32 on the tensor cores) and
   bfloat16 (tensor cores), held against their plain versions (also bit for
   bit on small-integer inputs; dW twice, bitwise equal) and timed beside
   them, cuDNN's gradients (torch.nn.grad.conv3d_input / conv3d_weight) and
   the bound (float32: both).
5. slice: dmri_hippo whole-volume inference, as a user calls it:
   StandardPredict(sagittal_split=True, device_argmax=True).predict on
   SegModel(NestedResUNet(3 -> 2, filters=40)) with random weights made in the
   flax layout from --seed and loaded through the weight bridge. Requests
   of 4 subjects of 3x96x88x24: one cold and 8 timed float32 requests, then
   one untimed and 8 timed bfloat16 requests; the medians of the timed ones.
   Checks the kernel's launch counts, the one-hot answers and their affines,
   the first subject against the port run on the CPU, and a NIfTI round trip.
   One more float32 and one more bfloat16 request run under torch.profiler,
   each after one more as its warm-up, for the device time by kernel and the
   device's idle share.
6. train: the dmri_hippo train step, as the trainer calls it:
   make_train_step(sagittal_split=True) with HybridLogisticDiceLoss and
   Adam(lr=2e-4) on SegModel(NestedResUNet(3 -> 2, filters=40,
   dropout_p=0.2)), random flax-layout weights from --seed, a batch of 4
   subjects of 3x96x88x24 with labels as bench.py makes them, dropout drawn
   from a torch.Generator on the card. 2 warm-up and 5 timed steps in
   float32, then the same in bfloat16; ms per step, volumes/s, peak memory,
   the losses; the kernels' launches per step by class (25 forward, 23 dX,
   25 dW) and each kind's kernel, plain, cuDNN and bound time per step
   (float32: both bounds);
   running statistics that moved and conv weights with nonzero gradients.
   Two more steps in float32 and two in bfloat16 run under torch.profiler,
   the first of each as its warm-up, for the device time by kernel and the
   shares of forward + dX and of dW.
7. card against CPU: one float32 train step at dropout 0, the same weights
   and the first subject, on the card and on the port on the CPU: the loss
   and every parameter's gradient, beside how far a 1e-7 change of the
   input moves the CPU's own gradients.

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

from segmentation_pipeline_torch import (Adam, HybridLogisticDiceLoss, LabelMap, ScalarImage,
                                         Subject, collate_to_device, create_train_state,
                                         make_train_step)
from segmentation_pipeline_torch.core.nifti import read_nifti, write_nifti
from segmentation_pipeline_torch.models import Conv3d, NestedResUNet, flax_to_state_dict
from segmentation_pipeline_torch.ops import build, conv3x3
from segmentation_pipeline_torch.ops.conv3x3 import (conv3x3_s1p1, conv3x3_s1p1_dw,
                                                     conv3x3_s1p1_dw_plain, conv3x3_s1p1_dx,
                                                     conv3x3_s1p1_dx_plain, conv3x3_s1p1_plain,
                                                     reset_launch_counts)
from segmentation_pipeline_torch.prediction import (StandardPredict, reverse_split_and_flip,
                                                    split_and_flip)
from segmentation_pipeline_torch.training.model import SegModel

# H100 SXM data-sheet peaks (dense): CUDA-core float32, tensor-core bf16, HBM3.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# float32 on the tensor cores as 3xTF32: three TF32 products per
# multiply-add at the dense TF32 peak, 495 TFLOP/s. This is the fastest
# f32-accurate rate the card has, so it gives every f32 row's bound_ms,
# whichever unit the kernel uses; the CUDA-core bound is printed beside it.
PEAK_FLOPS_3XTF32 = 495e12 / 3
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
# Timed requests: float32 after one cold request, bfloat16 after one untimed
# request; host time varies by several ms from request to request.
F32_REQUESTS, BF16_REQUESTS = 8, 8
CROP = (96, 88, 24)
IN_CHANNELS, OUT_CHANNELS, FILTERS = 3, 2, 40
# The input gradient runs for every conv but the two that read the network's
# input: ((W, H, D), Cout, Cin) of the forward (the conv dX runs), launches
# per train step.
DX_CLASSES = [(spatial, cout, cin, n) for spatial, cin, cout, n in CONV_CLASSES
              if cin != IN_CHANNELS]
DX_PER_STEP = 23
TRAIN_STEPS, WARMUP_STEPS = 5, 2
REPLACES = {"fwd": "segmentation_pipeline_tpu/ops/pallas_conv.py:64",
            "dx": "segmentation_pipeline_tpu/ops/pallas_conv.py:120",
            "dw": "segmentation_pipeline_tpu/ops/pallas_conv.py:129-142"}
# (name, input width in units of filters (0: the network's input), residual)
BLOCKS = [("conv0_0", 0, True), ("conv1_0", 1, False), ("conv0_1", 2, True),
          ("conv2_0", 1, False), ("conv1_1", 3, False), ("conv0_2", 2, True),
          ("conv3_0", 1, False), ("conv2_1", 3, False), ("conv1_2", 3, False),
          ("conv0_3", 2, True)]
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# Every f32 kernel (forward, dX, dW: 3xTF32) against its plain float32
# version on the same inputs, relative to max|ref|: each product within about
# 2**-21 of the f32 one, sums in another order. One TF32 product per
# multiply-add would miss it.
TF32X3_TOL = 1e-5
# bfloat16 adds one rounding of the output to 8 mantissa bits.
KERNEL_TOL = {torch.float32: TF32X3_TOL, torch.bfloat16: 2e-2}
# Integers in [-INT_MAX, INT_MAX] are exact in bf16 and in TF32 (lo = 0),
# and so is every f32 partial sum of a conv of them (at most 27 * 120 *
# INT_MAX**2) or of a weight gradient (at most 811,008 voxels * INT_MAX**2),
# both below 2**24: every kernel must then equal its plain version bit for
# bit in both types.
INT_MAX = 4
# The card's float32 answer against the port on the CPU: rounding only.
CPU_PROB_TOL = 1e-4
CPU_TIE = 1e-3
# The card's float32 train step against the port's on the CPU, each
# parameter's gradient relative to its max|grad|: sums in another order
# through 25 convs and 20 BatchNorms, forward and backward. The step on one
# subject is ill-conditioned in float32 (BatchNorm statistics of 2 half-
# volumes, ReLU kinks): a 1e-7 relative change of the input moves the CPU's
# own gradients by a few 1e-3 of max|grad|, which the comparison prints. A
# faulty kernel moves them by O(1); each f32 kernel is also held to 1e-5 of
# its plain version in the kernel phases.
CPU_GRAD_TOL = 2e-2
CPU_LOSS_TOL = 1e-5


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


def bound_ms(n, spatial, cin, cout, dtype, peak_flops=None):
    """max(operations / peak, bytes / 3.35 TB/s) in ms, and which bounds;
    the peak is the dtype's unless given."""
    voxels = n * spatial[0] * spatial[1] * spatial[2]
    flops = 2 * voxels * 27 * cin * cout
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (voxels * (cin + cout) + 27 * cin * cout) * size
    t_ops, t_bytes = flops / (peak_flops or PEAK_FLOPS[dtype]), nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_bound(n, spatial, cin, cout, dtype):
    """The card's bound for the function (f32 at the 3xTF32 rate), and in
    f32 the CUDA-core bound for the row's private key."""
    if dtype != torch.float32:
        b_ms, b_by = bound_ms(n, spatial, cin, cout, dtype)
        return b_ms, b_by, {}
    b_ms, b_by = bound_ms(n, spatial, cin, cout, dtype, PEAK_FLOPS_3XTF32)
    return b_ms, b_by, {"_bound_cuda_cores": bound_ms(n, spatial, cin, cout, dtype)[0]}


def bound_text(b_ms, b_by, both):
    if not both:
        return f"bound {b_ms:.4f} ({b_by})"
    return f"bound {b_ms:.4f} ({b_by}, 3xTF32), CUDA cores {both['_bound_cuda_cores']:.4f}"


def small_integers(gen, device, dtype, *shape):
    return torch.randint(-INT_MAX, INT_MAX + 1, shape, generator=gen,
                         device=device).to(dtype)


def check_exact(name, kernel, plain, *inputs):
    """A kernel against its plain version on small-integer inputs: bit
    equality."""
    out, ref = kernel(*inputs), plain(*inputs)
    torch.cuda.synchronize()
    if not (out.dtype == inputs[0].dtype and torch.equal(out, ref)):
        raise AssertionError(f"{name}: differs from the plain version on integer inputs "
                             f"(max abs diff {(out.float() - ref.float()).abs().max().item()})")
    print(f"kernel {name}: bit-exact against the plain version on integer inputs", flush=True)


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
            tol = KERNEL_TOL[dtype]
            if not (out.shape == ref.shape and err <= tol * scale):
                raise AssertionError(f"{name}: max abs err {err} > {tol} * {scale}")
            check_exact(name, conv3x3_s1p1, conv3x3_s1p1_plain,
                        small_integers(gen, device, dtype, batch, *spatial, cin),
                        small_integers(gen, device, dtype, 3, 3, 3, cin, cout))
            x_ncdhw = x.permute(0, 4, 1, 2, 3).contiguous()
            w_oi = k.permute(4, 3, 0, 1, 2).contiguous()
            b_ms, b_by, both = kernel_bound(batch, spatial, cin, cout, dtype)
            rows.append({
                "name": name,
                "route": "cuda",
                "source": "segmentation_pipeline_torch/csrc/conv3x3_s1p1.cu",
                "replaces": REPLACES["fwd"],
                "launches": None,
                "max_abs_err": err,
                "ms": time_ms(lambda: conv3x3_s1p1(x, k)),
                "plain_ms": time_ms(lambda: conv3x3_s1p1_plain(x, k), trials=10, calls=1),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": time_ms(lambda: F.conv3d(x_ncdhw, w_oi, padding=1)),
                "_key": (str(dtype), batch, *spatial, cin, cout),
                "_kind": "fwd",
                **both,
            })
            print(f"kernel {name}: err {err:.3g} (max|ref| {scale:.3g}) "
                  f"ms {rows[-1]['ms']:.4f} plain {rows[-1]['plain_ms']:.4f} "
                  f"cuDNN {rows[-1]['library_ms']:.4f} {bound_text(b_ms, b_by, both)} [{card}]",
                  flush=True)
            del x, k, out, ref, x_ncdhw, w_oi
    return rows


def grad_kernel_phase(device, batch: int, seed: int, card: str):
    """dX at each input-gradient class and dW at each forward class, in f32
    and bf16: check against the plain versions and time kernel, plain
    version and cuDNN's gradient."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def uniform(dtype, *shape, scale=1.0):
        return ((torch.rand(shape, generator=gen, device=device) * 2 - 1) * scale).to(dtype)

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for spatial, cin, cout, _ in CONV_CLASSES:
            x = uniform(dtype, batch, *spatial, cin)
            g = uniform(dtype, batch, *spatial, cout)
            k = uniform(dtype, 3, 3, 3, cin, cout, scale=1 / np.sqrt(27 * cin))
            x_ncdhw = x.permute(0, 4, 1, 2, 3).contiguous()
            g_ncdhw = g.permute(0, 4, 1, 2, 3).contiguous()
            w_oi = k.permute(4, 3, 0, 1, 2).contiguous()
            cases = []
            if cin != IN_CHANNELS:
                cases.append(("dx", cout, cin, lambda: conv3x3_s1p1_dx(g, k),
                              lambda: conv3x3_s1p1_dx_plain(g, k),
                              lambda: conv3x3_s1p1_dx_plain(g.float(), k.float()),
                              lambda: torch.nn.grad.conv3d_input(x_ncdhw.shape, w_oi,
                                                                 g_ncdhw, padding=1),
                              (conv3x3_s1p1_dx, conv3x3_s1p1_dx_plain,
                               (batch, *spatial, cout), (3, 3, 3, cin, cout))))
            cases.append(("dw", cin, cout, lambda: conv3x3_s1p1_dw(x, g),
                          lambda: conv3x3_s1p1_dw_plain(x, g),
                          lambda: conv3x3_s1p1_dw_plain(x.float(), g.float()),
                          lambda: torch.nn.grad.conv3d_weight(x_ncdhw, w_oi.shape, g_ncdhw,
                                                              padding=1),
                          (conv3x3_s1p1_dw, conv3x3_s1p1_dw_plain,
                           (batch, *spatial, cin), (batch, *spatial, cout))))
            for kind, c_in, c_out, kernel, plain, reference, library, exact in cases:
                out, ref = kernel(), reference()
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item()
                scale = ref.abs().max().item()
                name = f"conv3x3_s1p1_{kind}_{DTYPE_NAMES[dtype]} " \
                       f"{batch}x{'x'.join(map(str, spatial))} {c_in}->{c_out}"
                tol = KERNEL_TOL[dtype]
                if not (out.shape == ref.shape and out.dtype == dtype and err <= tol * scale):
                    raise AssertionError(f"{name}: max abs err {err} > {tol} * {scale}")
                if kind == "dw" and not torch.equal(out, kernel()):
                    raise AssertionError(f"{name}: two runs differ")
                exact_kernel, exact_plain, *shapes = exact
                check_exact(name, exact_kernel, exact_plain,
                            *(small_integers(gen, device, dtype, *shape) for shape in shapes))
                b_ms, b_by, both = kernel_bound(batch, spatial, cin, cout, dtype)
                source = conv3x3.SOURCE if kind == "dx" else conv3x3.DW_SOURCE
                rows.append({
                    "name": name,
                    "route": "cuda",
                    "source": f"segmentation_pipeline_torch/csrc/{source}",
                    "replaces": REPLACES[kind],
                    "launches": None,
                    "max_abs_err": err,
                    "ms": time_ms(kernel),
                    "plain_ms": time_ms(plain, trials=10, calls=1),
                    "bound_ms": b_ms,
                    "bound_by": b_by,
                    "library_ms": time_ms(library),
                    "_key": (str(dtype), batch, *spatial, c_in, c_out),
                    "_kind": kind,
                    **both,
                })
                print(f"kernel {name}: err {err:.3g} (max|ref| {scale:.3g}) "
                      f"ms {rows[-1]['ms']:.4f} plain {rows[-1]['plain_ms']:.4f} "
                      f"cuDNN {rows[-1]['library_ms']:.4f} {bound_text(b_ms, b_by, both)} "
                      f"[{card}]", flush=True)
                del out, ref
            del x, g, k, x_ncdhw, g_ncdhw, w_oi, cases
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


def profiled(run):
    """Device-side events of ``run()`` under torch.profiler, longest first,
    and its wall time in ms (host clock, ending in a synchronize). ``run``
    goes twice, the first time as the profiler's warm-up: only the second
    is recorded, so that no launch falls into the tracer's start. Only
    kernels and copies count: an operator's own entry repeats the device
    time of the kernels it launched, and a user annotation (the profiler's
    step, the optimizer's step) spans them on the device's timeline."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    averages = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: averages.append(p.key_averages()),
                 acc_events=True) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    events = sorted((e for e in (averages[0] if averages else [])
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                     and not e.is_user_annotation),
                    key=lambda e: -e.self_device_time_total)
    return events, wall_ms


def profile_request(model, predictor, subjects, name, card):
    """One more request under torch.profiler (after one more as its
    warm-up): device time by kernel, and the share of the request's wall
    time in which the device is busy (one stream, so kernel times do not
    overlap). The profiler's own overhead lengthens this request's wall
    time."""
    events, wall_ms = profiled(lambda: predictor.predict(model, subjects))
    if not events:
        print(f"profile: no device time traced; busy share not measured [{card}]")
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile ({name} request): wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f} [{card}]")
    for e in events[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:90]}")
    picked = [e for e in events if "conv3x3_s1p1" in e.key]
    conv_ms = sum(e.self_device_time_total for e in picked) / 1e3
    print(f"profile {name} request: conv3x3_s1p1 kernels {conv_ms:.3f} ms in "
          f"{sum(e.count for e in picked)} launches, of {busy_ms:.3f} ms device time", flush=True)


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

    def cycled(requests):
        return make_subjects([volumes[i % len(volumes)]
                              for i in range(requests * SUBJECTS_PER_REQUEST)])

    subjects = cycled(1 + F32_REQUESTS)
    times, batches, launches, by_shape = run_requests(model, predictor, subjects,
                                                      1 + F32_REQUESTS)
    peak = torch.cuda.max_memory_allocated()
    assert launches == (1 + F32_REQUESTS) * CONVS_PER_FORWARD, launches
    assert by_shape == expected_launches(torch.float32, 1 + F32_REQUESTS, half_batch), by_shape
    for t in times:
        print(f"slice f32 request: {t:.3f} ms, {SUBJECTS_PER_REQUEST / t * 1e3:.3f} volumes/s "
              f"[{card}]")
    med = statistics.median(times[1:])
    print(f"slice f32: median {med:.3f} ms per request over {F32_REQUESTS} after the cold "
          f"one, {SUBJECTS_PER_REQUEST / med * 1e3:.3f} volumes/s, "
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

    profile_request(model, predictor, make_subjects(volumes[:SUBJECTS_PER_REQUEST]), "f32", card)

    model.compute_dtype = "bfloat16"
    # one untimed, uncounted bf16 request first: the one-time costs of the
    # bf16 path (loading its PyTorch kernels, growing the allocator) stay out
    # of the timed ones, as the cold f32 request stays out of the f32 median
    predictor.predict(model, make_subjects(volumes[-SUBJECTS_PER_REQUEST:]))
    bf16_subjects = cycled(BF16_REQUESTS)
    times_bf, batches_bf, launches_bf, by_shape_bf = run_requests(
        model, predictor, bf16_subjects, BF16_REQUESTS)
    peak_bf = torch.cuda.max_memory_allocated()
    assert launches_bf == BF16_REQUESTS * CONVS_PER_FORWARD, launches_bf
    assert by_shape_bf == expected_launches(torch.bfloat16, BF16_REQUESTS, half_batch), \
        by_shape_bf
    label_agree = np.mean([(np.argmax(a["y_pred"].data, 0) == np.argmax(b["y_pred"].data, 0)
                            ).mean() for a, b in zip(bf16_subjects, subjects)])
    bf_diff = (batches_bf[0]["y_pred"] - batches[0]["y_pred"]).abs().max().item()
    med_bf = statistics.median(times_bf)
    print("slice bf16 requests: " + ", ".join(f"{t:.3f}" for t in times_bf) + " ms", flush=True)
    print(f"slice bf16 request: median {med_bf:.3f} ms over {BF16_REQUESTS}, "
          f"{SUBJECTS_PER_REQUEST / med_bf * 1e3:.3f} volumes/s, max_memory_allocated "
          f"{peak_bf} bytes; against f32: max abs prob diff {bf_diff:.3g}, voxel labels "
          f"agree {label_agree:.5f} [{card}]", flush=True)
    profile_request(model, predictor, make_subjects(volumes[:SUBJECTS_PER_REQUEST]), "bf16",
                    card)

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


def train_batch(rng: np.random.Generator, subjects: int):
    """Channel-first X of N(0, 1) values and two-class one-hot labels from
    its first channel, as bench.py makes them."""
    X = rng.normal(size=(subjects, IN_CHANNELS, *CROP)).astype(np.float32)
    lab = (X[:, 0] > 0.5).astype(np.float32)
    return {"X": X, "y": np.stack([1 - lab, lab], axis=1)}


def expected_train_launches(dtype, steps, batch):
    """Forward, dX and dW launches by shape over ``steps`` train steps."""
    fwd = expected_launches(dtype, steps, batch)
    dx = Counter({(str(dtype), batch, *spatial, cin, cout): n * steps
                  for spatial, cin, cout, n in DX_CLASSES})
    return {"fwd": fwd, "dx": dx, "dw": fwd}


def launch_counts():
    return {kind: Counter(w.launches_by_shape) for kind, w in
            (("fwd", conv3x3_s1p1), ("dx", conv3x3_s1p1_dx), ("dw", conv3x3_s1p1_dw))}


def profile_train_step(step, state, batch, generator, name, card):
    """One train step under torch.profiler (after one more as its warm-up):
    device busy time, idle share and the kernels that take the most device
    time (the forward and dX share conv3x3_s1p1_tf32x3_kernel in float32 and
    conv3x3_s1p1_mma_kernel in bfloat16; dW is dw_partial_tf32x3_kernel in
    float32, dw_partial_mma_kernel in bfloat16, and dw_reduce_kernel). Returns the
    forward + dX kernels' device time, the dW kernels' and the device busy
    time, in ms (None if nothing was traced)."""
    events, wall_ms = profiled(lambda: step(state, batch, generator))
    if not events:
        print(f"profile train step: no device time traced; busy share not measured [{card}]")
        return None
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile ({name} train step): wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f} [{card}]")
    for e in events[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:90]}")
    by_label = {}
    for label, needle in (("conv3x3_s1p1_{tf32x3,mma}_kernel (forward + dX)", "conv3x3_s1p1_"),
                          ("dw_partial_{tf32x3,mma}_kernel + dw_reduce_kernel (dW)", "dw_")):
        picked = [e for e in events if needle in e.key]
        by_label[needle] = sum(e.self_device_time_total for e in picked) / 1e3
        print(f"profile {name} train step: {label} {by_label[needle]:.3f} ms in "
              f"{sum(e.count for e in picked)} launches, of {busy_ms:.3f} ms device time",
              flush=True)
    return by_label["conv3x3_s1p1_"], by_label["dw_"], busy_ms


def train_phase(card, seed, rows):
    """The dmri_hippo train step on the card, f32 then bf16; fills the
    launches per step of the gradient kernels' rows."""
    rng = np.random.default_rng(seed + 2)
    state_dict = flax_to_state_dict(flax_weights(rng))
    batch_cf = train_batch(rng, SUBJECTS_PER_REQUEST)
    model = SegModel(NestedResUNet(IN_CHANNELS, OUT_CHANNELS, filters=FILTERS, dropout_p=0.2),
                     device="cuda")
    model.load_state_dict(state_dict)
    optimizer, criterion = Adam(lr=2e-4), HybridLogisticDiceLoss()
    state = create_train_state(model, optimizer, batch_cf)
    batch = collate_to_device(batch_cf)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    half_batch = 2 * SUBJECTS_PER_REQUEST
    per_step = {}
    steps = {}
    for dtype in (torch.float32, torch.bfloat16):
        step = make_train_step(model.module, criterion, optimizer, sagittal_split=True,
                               compute_dtype=None if dtype == torch.float32 else "bfloat16")
        steps[dtype] = step
        for _ in range(WARMUP_STEPS):
            state, _, _ = step(state, batch, generator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times, losses = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, loss_dict, y_pred = step(state, batch, generator)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss_dict["loss"])
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [loss.item() for loss in losses]
        name = DTYPE_NAMES[dtype]
        assert all(np.isfinite(losses)), losses
        assert tuple(y_pred.shape) == (SUBJECTS_PER_REQUEST, *CROP, OUT_CHANNELS)
        assert torch.isfinite(y_pred).all().item()
        assert [sum(c.values()) for c in counts.values()] == \
            [CONVS_PER_FORWARD * TRAIN_STEPS, DX_PER_STEP * TRAIN_STEPS,
             CONVS_PER_FORWARD * TRAIN_STEPS], counts
        assert counts == expected_train_launches(dtype, TRAIN_STEPS, half_batch), counts
        per_step[str(dtype)] = counts
        med = statistics.median(times)
        print(f"train {name} steps: " + ", ".join(f"{t:.3f}" for t in times) + " ms", flush=True)
        print(f"train {name}: median {med:.3f} ms per step, "
              f"{SUBJECTS_PER_REQUEST / med * 1e3:.3f} volumes/s, max_memory_allocated "
              f"{peak} bytes; losses " + ", ".join(f"{v:.6f}" for v in losses)
              + f"; launches per step forward {counts['fwd'].total() // TRAIN_STEPS}, "
              f"dX {counts['dx'].total() // TRAIN_STEPS}, dW {counts['dw'].total() // TRAIN_STEPS}"
              f" [{card}]", flush=True)

    moved = [k for k, v in state.batch_stats.items() if not torch.equal(v.cpu(), state_dict[k])]
    assert len(moved) == len(state.batch_stats), "running statistics that did not move"
    conv_weights = [m.weight for m in model.module.modules() if isinstance(m, Conv3d)]
    assert len(conv_weights) == CONVS_PER_FORWARD
    assert all(w.grad is not None and torch.isfinite(w.grad).all().item()
               and w.grad.abs().max().item() > 0 for w in conv_weights)
    print(f"train: {len(moved)} running statistics moved; all {len(conv_weights)} conv "
          f"weights have finite, nonzero gradients", flush=True)
    shares = {name: profile_train_step(steps[dtype], state, batch, generator, name, card)
              for dtype, name in DTYPE_NAMES.items()}
    if all(shares.values()):
        print("profile train step, kernels' share of device time: " + ", ".join(
            f"{name} forward + dX {conv:.3f} of {busy:.3f} ms ({conv / busy:.4f}), "
            f"dW {dw:.3f} ({dw / busy:.4f})"
            for name, (conv, dw, busy) in shares.items()) + f" [{card}]", flush=True)

    for row in rows:
        if row["_kind"] == "fwd":
            continue
        count = per_step[row["_key"][0]][row["_kind"]][row["_key"]]
        assert count % TRAIN_STEPS == 0 and count > 0, (row["name"], count)
        row["launches"] = count // TRAIN_STEPS
    return state_dict, batch_cf


def step_totals(rows, card):
    """Each kernel kind's time per train step in each dtype (25 forward, 23
    dX, 25 dW launches), beside its plain version's, cuDNN's and the bound:
    sums of launches per step times ms per launch over the classes."""
    per_forward = {(*spatial, cin, cout): n for spatial, cin, cout, n in CONV_CLASSES}
    for dtype, name in DTYPE_NAMES.items():
        for kind in ("fwd", "dx", "dw"):
            picked = [(row, per_forward[row["_key"][2:]] if kind == "fwd" else row["launches"])
                      for row in rows if row["_kind"] == kind and row["_key"][0] == str(dtype)]
            keys = ["ms", "plain_ms", "library_ms", "bound_ms"]
            if dtype == torch.float32:
                keys.append("_bound_cuda_cores")
            total = {key: sum(row[key] * n for row, n in picked) for key in keys}
            both = (f" (3xTF32; CUDA cores {total['_bound_cuda_cores']:.4f})"
                    if dtype == torch.float32 else "")
            print(f"per train step {kind} {name}: kernel {total['ms']:.4f} ms, plain "
                  f"{total['plain_ms']:.4f}, cuDNN {total['library_ms']:.4f}, bound "
                  f"{total['bound_ms']:.4f}{both} ({sum(n for _, n in picked)} launches) "
                  f"[{card}]", flush=True)


def cpu_train_comparison(card, state_dict, batch_cf):
    """One f32 train step at dropout 0 on the first subject of the training
    batch, on the card and on the port on the CPU: the loss and every
    parameter's gradient. One more CPU step, on the input changed by about
    1e-7 relative, shows how far float32 rounding alone moves the
    gradients."""
    torch.set_num_threads(os.cpu_count() or 1)
    one = {k: v[:1] for k, v in batch_cf.items()}
    noise = np.random.default_rng(0).standard_normal(one["X"].shape)
    nudged = dict(one, X=(one["X"] * (1 + 1e-7 * noise)).astype(np.float32))

    def run(device, batch):
        model = SegModel(NestedResUNet(IN_CHANNELS, OUT_CHANNELS, filters=FILTERS),
                         device=device)
        model.load_state_dict(state_dict)
        optimizer = Adam(lr=2e-4)
        state = create_train_state(model, optimizer, batch)
        step = make_train_step(model.module, HybridLogisticDiceLoss(), optimizer,
                               sagittal_split=True)
        t0 = time.perf_counter()
        state, loss_dict, _ = step(state, collate_to_device(batch, device=device), None)
        loss = loss_dict["loss"].item()
        return (loss, {k: p.grad.detach().cpu() for k, p in state.params.items()},
                time.perf_counter() - t0)

    def worst(grads, ref):
        return max(((grads[k] - g).abs().max().item() / g.abs().max().item(), k)
                   for k, g in ref.items())

    (loss_gpu, grads_gpu, _), (loss_cpu, grads_cpu, cpu_s) = run("cuda", one), run("cpu", one)
    _, grads_nudged, _ = run("cpu", nudged)
    card_diff, own = worst(grads_gpu, grads_cpu), worst(grads_nudged, grads_cpu)
    loss_diff = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    print(f"train f32 vs CPU port (first subject, dropout 0): loss {loss_gpu:.7f} vs "
          f"{loss_cpu:.7f} (rel diff {loss_diff:.3g}); worst gradient max abs diff / "
          f"max|grad| {card_diff[0]:.3g} at {card_diff[1]} over {len(grads_cpu)} parameters; "
          f"the CPU against itself on the input changed by 1e-7: {own[0]:.3g} at {own[1]}; "
          f"CPU step took {cpu_s:.1f} s [{card}]", flush=True)
    assert loss_diff <= CPU_LOSS_TOL and card_diff[0] <= CPU_GRAD_TOL


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
    build.build(conv3x3.SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for source in conv3x3.SOURCES:
        print(f"{source}:\n" + build.build_logs.get(source, "(library was already built)").strip(),
              flush=True)

    device, half_batch = torch.device("cuda"), 2 * SUBJECTS_PER_REQUEST
    rows = kernel_phase(device, half_batch, args.seed, card)
    grad_rows = grad_kernel_phase(device, half_batch, args.seed, card)
    slice_phase(card, args.seed, rows)
    state_dict, batch_cf = train_phase(card, args.seed, grad_rows)
    step_totals(rows + grad_rows, card)
    cpu_train_comparison(card, state_dict, batch_cf)

    rows = [{key: value for key, value in row.items() if not key.startswith("_")}
            for row in rows + grad_rows]
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
