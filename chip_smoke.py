#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (segmentation_pipeline_torch) on one
NVIDIA GPU, and check what it computes.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the run with a non-zero exit code:

1. card: the card's name and power limit (nvidia-smi); TF32 off for
   convolutions and matmuls, so float32 stays float32 everywhere.
2. build: nvcc builds both CUDA sources from segmentation_pipeline_torch/csrc
   (the conv kernel, which also runs the input gradient dX, and the weight
   gradient dW), in parallel, and prints their -Xptxas -v logs; g++ builds
   the native connected-component labeller (csrc/ccl.cpp) that the host
   post-processing and the instance evaluator label on.
3. kernels: the 3x3x3 conv kernel at each (spatial size, Cin, Cout) class of
   NestedResUNet-40 at the serving batch (8 half-volumes) and at the TTA
   batch (32: 4 flips of 8 half-volumes), in float32 (3xTF32 on the tensor
   cores) and bfloat16 (tensor cores), held against its plain PyTorch
   version on the same inputs (also bit for bit on small-integer inputs)
   and timed with CUDA events beside the plain version, F.conv3d (cuDNN)
   and the card's bound (float32: the 3xTF32 bound, with the CUDA-core one
   beside it). Then, untimed in both types, every class at the affine TTA
   batch (128: 4 warps of the 32), and in float32 every class of the 6
   permuted grids an EnsembleOrientations request gives it (16
   half-volumes).
4. gradient kernels: dX at every input-gradient class of the train step (the
   forward classes with Cin and Cout swapped, except the convs that read the
   network's input) and dW at every forward class, at the training batch
   (the same 8 half-volumes), in float32 (3xTF32 on the tensor cores) and
   bfloat16 (tensor cores), held against their plain versions (also bit for
   bit on small-integer inputs; dW twice, bitwise equal) and timed beside
   them, cuDNN's gradients (torch.nn.grad.conv3d_input / conv3d_weight) and
   the bound (float32: both). Then, untimed in both types, the forward, dX
   and dW at every class at N=16 (phase 16's step at world 1 and its TTA
   forward on each rank).
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
6. tta: dmri_hippo TTA serving back to the scanner grid, as
   research/dmri_hippo/hippo_inference.py --ensemble-flips --ensemble-folds
   --batched-tta runs it: raw subjects of 112x104x20 (mean_dwi, md and fa
   with a few NaN voxels, the whole-hippocampus labels and the atlas mask;
   a negative first axis) through the config's default pipeline, which
   crops them to 96x88x24; two folds of NestedResUNet(3 -> 2, filters=40,
   dropout_p=0.2) from --seed and --seed + 1, each under
   EnsembleFlips("majority", spatial_dims=(3, 4), batched=True), under
   EnsembleModels("majority"); StandardPredict(sagittal_split=True); the
   inversion of each answer through its subject's tape and the
   post-processing (remove_holes, keep_components). Requests of 4
   subjects: one untimed and 5 timed in float32, then the same in
   bfloat16; ms per request, ms for inversion plus post-processing, peak
   memory, launches (2 forwards of 25 at N=32 per request), and one
   profiled request in each type. In float32 also: one unrolled request (8
   forwards of 25 at N=8, labels equal to the batched one's), one request
   with device_argmax (the bit-packed fetch equal to the plain one), fold
   0's flip members on the first subject against the port on the CPU, and
   one EnsembleOrientations("majority", batched=True) request of one
   subject (6 forwards of 25 at N=16), with one permuted forward against
   the CPU. Then affine TTA as hippo_inference --ensemble-affines 4
   --ensemble-flips --ensemble-folds --batched-tta composes it (per fold,
   4 warps of the 4 flips in one forward): one untimed and 3 timed
   requests in float32 and in bfloat16 (2 forwards of 25 at N=128), peak
   memory, and fold 0's composition with the identity and one warp on a
   24x48x24 cut of the first subject's first half-volume against the port
   on the CPU (labels equal on at least 0.999 of the voxels). Every answer
   ends on the 112x104x20 grid with labels in {0, 1, 2}.
7. msseg2: msseg2 serving, as research/msseg2/competition/ms_inference.py
   runs it (non-fused) and as the msseg2 trainer's validation sweep
   predicts: the forward kernel at the 15 classes of
   ModularUNet(2 -> 2, filters (40, 40, 80, 80, 120, 120), depth 6) at a
   96^3 patch, N=1, in float32 and bfloat16, as in phase 3; untimed, the
   class 32x96^3 80->40 (2.26e9 input elements, past 2**31) in both types,
   and the 15 classes at the validation sweep's N=12 in both types.
   Then two raw subjects of 256x256x144 at (0.9375, 0.9375, 1.2) mm (two
   FLAIRs and a brain mask) through msseg2's default pipeline (about
   150x182x146 in model space), the network with random weights from
   --seed, PatchPredict(patch_batch_size=1, patch 96, overlap 48, edge,
   device_argmax) and the way back: inversion, remove_holes(64),
   remove_small_components(3), resample onto the raw grid. One untimed and
   2 timed requests in float32, then in bfloat16 (27 forwards of 34
   launches at N=1 each), the host's pipeline and way back timed apart;
   1 + 2 validation sweeps (PatchPredict(patch_batch_size=32, overlap 12)
   over both subjects, one forward of N=12 each, no halving) per type.
   In float32 also: device_argmax against the full fetch, batch 32 against
   batch 1, one 96^3 patch against the port on the CPU, and the port's
   strided and transposed convs with cuDNN's TF32 switched on for the
   process against float64 (beside a bare F call). One profiled request
   per type. Then serving determinism: the competition request's
   probabilities (no argmax) on one raw subject, twice per type, in this
   process and in one started afresh, bit for bit.
8. train: the dmri_hippo train step, as the trainer calls it:
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
9. card against CPU: one float32 train step at dropout 0, the same weights
   and the first subject, on the card and on the port on the CPU: the loss
   and every parameter's gradient, beside how far a 1e-7 change of the
   input moves the CPU's own gradients.
10. msseg2-train: msseg2 training as research/msseg2/msseg2.py:163-231 runs
   it (tpu_fast_path=False). First, with the kernel phases, the forward,
   dX and dW at the 15 classes of a 96^3 patch at the training batch N=4,
   in float32 and bfloat16, checked as in phases 3 and 4 and timed at less
   depth (medians of 5 trials of 3 calls, the plain version's of 3). Then
   five raw subjects of 256x256x144 (with a lesion ground truth) written
   in msseg2's layout and read by the configuration's SubjectFolder; its
   training cohort (four) through msseg2's ``training`` pipeline and
   PatchDataLoader(max_length=100, samples_per_volume=1,
   WeightedSampler(96, "patch_probability")): one batch of four 96^3
   patches on that path, the pipeline once more over the cohort (timed per
   subject), three more batches from the loader alone over copies of the
   transformed subjects (timed per batch); each batch stacked and uploaded
   as the trainer does it (stack_batch, upload_batch: y as uint8 class
   ids, one-hot on the card). On the full-width rematerialized network with
   SGD(lr=0.001, momentum=0.95) and HybridLogisticDiceLoss(
   logistic_class_weights=[1, 100]): 2 warm-up and 5 timed steps in
   float32, then in bfloat16, over those batches; ms per step, patches/s,
   peak memory, the losses and the launches per step by class (forward 67
   = 34 + 33 recomputed, dX 32, dW 34); one profiled step per dtype. Then
   one float32 step with remat against one without (cuDNN deterministic):
   equal loss, gradients within 1e-6 of each leaf's max|grad|, running
   statistics moved once, both peak memories. Last, one float32 step on
   the first patch cut to 64^3 (N=1; a step on four 96^3 patches takes
   minutes on the CPU) on the card and on the port on the CPU, as in
   phase 9.
11. trainer: the sustained training loop, as research/dmri_hippo/run.py
   and research/msseg2/run.py drive it. 16 dmri_hippo subjects of
   112x104x20 written in the dataset's layout (4 cbbrain_validation, 8
   training, 4 ab300_validation with ages), the ported configuration's
   get_context at full width, init_components and
   SegmentationTrainer.train(max_iterations=51, num_workers=4,
   validation_batch_size=16, logger=FileLogger(...)), once in float32 and
   once with compute_dtype="bfloat16": the launches per iteration (25
   forward, 23 dX, 25 dW) and per validation batch (25 forward), which
   evaluators ran at which iterations, model_score at 0 and 50, the
   checkpoints, and each checkpoint reloaded into a fresh Context
   answering a probe batch as its model did when it was saved, bit for
   bit. Iterations per second of the float32 trainer against num_workers
   in {2, 8} (12 iterations each, once; 4 is the runs above) and, at 4,
   process workers and then threads again, with the timer's median split,
   the validation sweep's time, the synchronous part of a checkpoint save,
   peak memory and the idle share over 5 profiled iterations. Then
   msseg2's trainer on the dataset of phase 10 for 3 iterations in
   float32: 67/32/34
   launches per iteration, 34 forward per validation patch batch. First of
   all, SubjectFolder's load ms per subject of both datasets through the
   native NIfTI reader against the numpy codec, in turns, arrays equal. Where
   matplotlib or PIL is missing, one line says so and the contour-image
   schedules are dropped from both contexts before they train.
12. fast-path: the configurations' tpu_fast_path=True (device_cache and
   device_augmentation="auto") over phase 11's datasets. First
   ops/augment.py at the trainers' batches (4 x 96x88x24 x 3 for
   dmri_hippo, 4 x 96^3 x 2 for msseg2, uint8 label ids) on the card
   against the port on the CPU at the same draws, made on the CPU and
   moved: both reference configurations in float32 and bfloat16 (X within
   1e-5 of max|CPU| in float32, one bf16 step in bfloat16; labels bit for
   bit) and timed (augment_batch, draws included), then every gate on in
   float32. Then dmri_hippo's trainer as in phase 11, 51 iterations in
   float32 and in bfloat16, with the same readings and assertions plus the
   cache's bytes and the host's pretransform time, each followed by a
   profile of 5 plain iterations (idle share); then msseg2's trainer for
   31 iterations in float32 (67/32/34 launches per iteration) with 5 plain
   iterations profiled within the run (left out of its rate), and its
   DevicePatchCache checked against extract_patch at the drawn starts and
   timed.
13. cli: the port's entry points as users start them, through their main
   functions, over phase 11's datasets (the modules under
   segmentation_pipeline_torch/research/ and
   segmentation_pipeline_torch/run_inference.py): dmri_hippo's run.py main
   for 6 iterations on fold 0 and, with --tpu-fast-path, on fold 1 (25/23/25
   launches per iteration and 25 in the validation sweep asserted;
   iterations/s); hippo_inference over both folds' last checkpoints with
   --ensemble-flips --ensemble-folds --batched-tta on the 4 validation
   subjects, in f32 and with --bf16 (50 launches at N=32; NIfTIs on the
   scanner grid, report, settings JSON; wall time per subject split into
   model load, device work and host work), and the same with
   --ensemble-affines 4 (50 launches at N=128, peak memory); evaluate.py on the f32
   predictions where pandas imports; run_inference at 48 orientations on
   two subjects (25 launches per orientation at N=1), and its first 4
   orientations of one subject against the port on the CPU from the same
   checkpoint; msseg2/run.py --tpu-fast-path for 6 iterations (67/32/34
   asserted), ms_inference on its checkpoint with and without
   --device-argmax (34 launches per patch; identical masks), ms_run in a
   subprocess on one raw FLAIR pair (its mask equals ms_inference's on the
   staged folder).
14. qsm-dwi: qsm's configuration (segmentation_pipeline_torch/research/
   qsm_deep_grey_matter: NestedResUNet(2 -> 10, filters=40) on the
   reference crop 120x144x96 of 256x288x128 volumes) and dmri_hippo's DWI
   augmentation modes. First the forward, dX and dW at qsm's nine classes
   (Cout 10 in the out conv, Cin 10 in its dX), held against their plain
   versions as in phases 3-4 and timed beside cuDNN and the bound at N=4
   and N=2 in both dtypes (the kernels line holds the (N, dtype) each
   training run uses: 4, f32 and 2, bf16). Then 6 synthetic subjects in qsm's layout (MPRAGE,
   QSM, vB_PS_r with the 17 structures, IC, pulv; Cb_Brain_058 and
   Cb_Brain_106 the validation cohort) through the configuration's
   get_context at full width: the reference (batch 4, f32, the default
   path, 4 threads, 16 iterations) and the configuration's recipe
   (microbatch=2 with Adam(accumulate_steps=2), tpu_fast_path=True,
   compute_dtype="bfloat16", 18 micro-steps; the parameters move after
   every second micro-step only), each with iterations/s, the timer's
   split, peak memory, the idle share over 5 profiled iterations within
   the run, the iteration-0 sweep and the launches per micro-step by class
   (25/23/25; the recipe's remat adds the blocks' 24 forward convs). Then
   NestedResUNet(use_norm=False) on a 64x64x32 cut: two micro-steps of N=2
   with accumulate_steps=2 against one step of N=4, and one f32 qsm step
   against the port on the CPU. Last, phase 11's dmri_hippo dataset gets a
   full_dwi series of 96 volumes (6 at b=0, 30 at b=500, 60 at b=1000)
   and its gradient table: run.py augmentation_experiment
   --augmentation-mode combined for 6 iterations, without and with
   --tpu-fast-path (the hybrid device cache: ms per
   HybridHostAugment.apply, one call's cProfile by function, bytes
   uploaded per batch, the cached channels
   other than mean_dwi unchanged by the splice), then run.py debug for 2
   iterations.
15. cascade-cleanup: (a) the dmri_hippo cascade (configs/cascade.py). The
   kernels at its new classes at N=8 (the out conv 40 -> 4 with its dX 4 ->
   40 and dW, and the classes of the basic_unet ModularUNet(3 -> 4, [40,
   80, 120], depth 3) that dmri_hippo lacks), held against their plain
   versions in float32 and bfloat16 (bit for bit on integers) and timed in
   float32, the type the cascade trains in; a prior per subject of phase
   11's dataset (whole_roi with 5% of its voxels flipped within their
   hemisphere); run.py cascade_experiment for 6 iterations at full width
   with 4 threads (25/23/25 launches per iteration, the 40 -> 4 class in
   each, 25 in the iteration-0 sweep of the refined validation predictor;
   iterations/s, the sweep's ms, peak memory); every transition matrix of
   a served batch column-stochastic; one refined f32 step against the port
   on the CPU and one profiled step; then --model-type basic_unet for one
   iteration. (b) The fused cleanup: ms_inference's inference() with
   device_postprocess on two msseg2 subjects of 144x192x144 in model
   geometry (12 patches each, phase 13's msseg2 checkpoint): the fused path
   taken, 34 forward launches per patch, the masks equal to the host
   chain's on the same argmax voxel for voxel, device against host cleanup
   ms and CC sweeps per call (the model's argmax and a thresholded FLAIR);
   then the CLI with --device-postprocess on msseg2's dataset and the path
   each subject took. (c) The device sweep reductions: dmri_hippo's
   trainer with a device_argmax validation predictor and Segmentation and
   InstanceSegmentation evaluators every iteration: the manager from probe
   to on (the probe holds the device counts to the host chain's, exactly),
   each sweep's ms by state beside a host-path run's, the bytes fetched per
   subject; overlap_histogram_device against the host instance chain on
   lesion masks of that grid, with a capacity it overflows.
16. mesh: the data-parallel mesh (segmentation_pipeline_torch/parallel).
   NCCL refuses two ranks on one card, so the mesh runs at world size 2 as
   two processes on the card that the port's launcher starts
   (launch_multihost.launch_local; each runs this script with --mesh-rank),
   joined by gloo, which carries the CUDA tensors, and at world size 1
   under NCCL in this process; each
   against this process without a mesh, on the same inputs: (a) dmri_hippo's
   train step (NestedResUNet(3 -> 2, filters=40, dropout_p=0.2), sagittal
   split, Adam(lr=2e-4)) at a global batch of 8 subjects of 3x96x88x24 (4 a
   rank at world 2), 3 steps in f32 and in bf16 from the same weights and
   dropout seed, 25/23/25 launches a step asserted on each rank: the losses
   (f32 within 1e-4, bf16 within 4e-3, relative), the f32 gradient and
   update after each step (within 1e-4, or within the farthest that the
   one process moves from itself when its batch or its weights are nudged
   by one rounding, four nudges), every rank's weights bit for bit, the
   trainer's stop vote; (b) hippo_inference --ensemble-flips --batched-tta
   --tta-mesh on one fold's checkpoint and the 4 validation subjects of
   phase 11's dataset (one forward of 25 launches at N=16 on each rank):
   the labels on the scanner grid equal voxel for voxel; (c) the msseg2
   competition predictor with mesh= on one raw 256x256x144 subject in
   model space (the 27 patches padded to 28, 14 a rank, 34 launches each):
   probabilities within 1e-5, masks equal. Each path's time beside the one
   process's, each part's seconds and the ranks' timeline; the ranks are
   joined before the phase ends.

The line before the last is a JSON object listing every kernel; the last line
is {"ok": true, "device": {...}}. Exits non-zero without a CUDA device.

`python3 chip_smoke.py --compare PARENT . . PARENT` runs none of the phases:
it times msseg2 competition requests in each checkout given (one process
each, on that checkout's port), to hold a commit against its parent on one
card (compare_requests).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import cProfile
import datetime
import gc
import inspect
import itertools
import json
import os
import pickle
import pstats
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

import segmentation_pipeline_torch as tsp
from segmentation_pipeline_torch import (SGD, Adam, EnsembleAffines, EnsembleFlips,
                                         EnsembleModels, EnsembleOrientations,
                                         HybridLogisticDiceLoss, LabelMap,
                                         PatchDataLoader, PatchPredict, ScalarImage, Subject,
                                         WeightedSampler, collate_to_device, create_train_state,
                                         make_train_step, seed_all)
from segmentation_pipeline_torch.core.nifti import read_nifti, write_nifti
from segmentation_pipeline_torch.models import (BatchNorm, BlurConv3d, BlurConvTranspose3d,
                                                Conv3d, ModularUNet, NestedResUNet,
                                                flax_to_state_dict)
from segmentation_pipeline_torch import native
from segmentation_pipeline_torch.ops import build, conv3x3, convolution
from segmentation_pipeline_torch.ops.conv3x3 import (conv3x3_s1p1, conv3x3_s1p1_dw,
                                                     conv3x3_s1p1_dw_plain, conv3x3_s1p1_dx,
                                                     conv3x3_s1p1_dx_plain, conv3x3_s1p1_plain,
                                                     reset_launch_counts)
from segmentation_pipeline_torch.core.subject import collate_subjects
from segmentation_pipeline_torch.data.loader import extract_patch
from segmentation_pipeline_torch.ops.sliding_window import grid_locations
from segmentation_pipeline_torch.parallel.mesh import any_rank
from segmentation_pipeline_torch.prediction import (StandardPredict, apply_stochastic_matrix,
                                                    reverse_split_and_flip, split_and_flip)
from segmentation_pipeline_torch.research.dmri_hippo.configs import cascade as cascade_config
from segmentation_pipeline_torch.research.dmri_hippo.configs import main_config as hippo_config
from segmentation_pipeline_torch import run_inference as cli_run_inference
from segmentation_pipeline_torch.research.dmri_hippo import evaluate as cli_evaluate
from segmentation_pipeline_torch.research.dmri_hippo import hippo_inference as cli_hippo
from segmentation_pipeline_torch.research.dmri_hippo import run as cli_run_module
from segmentation_pipeline_torch.research.dmri_hippo.hippo_inference import (
    invert_predictions, post_process)
from segmentation_pipeline_torch.research.msseg2 import msseg2 as msseg2_config
from segmentation_pipeline_torch.research.msseg2 import run as cli_ms_run
from segmentation_pipeline_torch.research.msseg2.competition import ms_inference as cli_ms_inference
from segmentation_pipeline_torch.research.msseg2.competition.ms_inference import (
    competition_predictor, ms_to_raw_grid)
from segmentation_pipeline_torch.research.qsm_deep_grey_matter import \
    qsm_deep_grey_matter as qsm_config
from segmentation_pipeline_torch.research.scripts import launch_multihost
from segmentation_pipeline_torch.training import trainer as trainer_module
from segmentation_pipeline_torch.training.hybrid_augment import HybridHostAugment
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
# and so is every f32 partial sum of a conv of them (at most 27 * 240 *
# INT_MAX**2) or of a weight gradient (at most 811,008 voxels * INT_MAX**2
# at dmri_hippo's batch), below 2**24: every kernel must then equal its
# plain version bit for bit in both types. At msseg2's training batch (four
# 96^3 patches, 3,538,944 voxels) the worst case passes 2**24, but sums of
# products of random sign stay within a few spreads (about 1.3e4) of 0, so
# they are exact all the same.
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


def time_ms(fn, trials: int = 15, calls: int = 5, warmup: int = 3) -> float:
    """Median over ``trials`` of CUDA-event time per call, each trial timing
    ``calls`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
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


# time_ms's arguments for the kernel and cuDNN, and for the plain version
TIMING = (dict(trials=8, calls=5), dict(trials=5, calls=1))
DTYPES = (torch.float32, torch.bfloat16)


def kernel_phase(device, batch: int, seed: int, card: str, classes=CONV_CLASSES,
                 dtypes=DTYPES, timing=TIMING):
    """Each conv class in each of ``dtypes``: check against the plain
    version and time kernel, plain version and F.conv3d (``timing=None``:
    check only, no rows)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for dtype in dtypes:
        for spatial, cin, cout, _ in classes:
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
            if timing is None:
                print(f"kernel {name} (untimed): err {err:.3g} (max|ref| {scale:.3g}) [{card}]",
                      flush=True)
                del x, k, out, ref
                torch.cuda.empty_cache()
                continue
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
                "ms": time_ms(lambda: conv3x3_s1p1(x, k), **timing[0]),
                "plain_ms": time_ms(lambda: conv3x3_s1p1_plain(x, k), **timing[1]),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": time_ms(lambda: F.conv3d(x_ncdhw, w_oi, padding=1), **timing[0]),
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


def grad_kernel_phase(device, batch: int, seed: int, card: str, classes=CONV_CLASSES,
                      in_channels=IN_CHANNELS, dtypes=DTYPES, timing=TIMING):
    """dX at each input-gradient class (every conv of ``classes`` but those
    that read the network's ``in_channels``) and dW at each forward class,
    in each of ``dtypes``: check against the plain versions and time kernel,
    plain version and cuDNN's gradient (``timing=None``: check only, no
    rows)."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def uniform(dtype, *shape, scale=1.0):
        return ((torch.rand(shape, generator=gen, device=device) * 2 - 1) * scale).to(dtype)

    rows = []
    for dtype in dtypes:
        for spatial, cin, cout, _ in classes:
            x = uniform(dtype, batch, *spatial, cin)
            g = uniform(dtype, batch, *spatial, cout)
            k = uniform(dtype, 3, 3, 3, cin, cout, scale=1 / np.sqrt(27 * cin))
            x_ncdhw = x.permute(0, 4, 1, 2, 3).contiguous()
            g_ncdhw = g.permute(0, 4, 1, 2, 3).contiguous()
            w_oi = k.permute(4, 3, 0, 1, 2).contiguous()
            cases = []
            if cin != in_channels:
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
                if timing is None:
                    print(f"kernel {name} (untimed): err {err:.3g} (max|ref| {scale:.3g}) "
                          f"[{card}]", flush=True)
                    del out, ref
                    continue
                b_ms, b_by, both = kernel_bound(batch, spatial, cin, cout, dtype)
                source = conv3x3.SOURCE if kind == "dx" else conv3x3.DW_SOURCE
                rows.append({
                    "name": name,
                    "route": "cuda",
                    "source": f"segmentation_pipeline_torch/csrc/{source}",
                    "replaces": REPLACES[kind],
                    "launches": None,
                    "max_abs_err": err,
                    "ms": time_ms(kernel, **timing[0]),
                    "plain_ms": time_ms(plain, **timing[1]),
                    "bound_ms": b_ms,
                    "bound_by": b_by,
                    "library_ms": time_ms(library, **timing[0]),
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
            torch.cuda.empty_cache()
    return rows


def flax_weights(rng: np.random.Generator, filters: int = FILTERS):
    """Random NestedResUNet(3 -> 2, filters) variables in the flax layout:
    torch's conv init, BatchNorm statistics with positive, non-unit
    variances."""
    def conv(cin, cout, bias):
        bound = 1 / np.sqrt(27 * cin)
        out = {"kernel": rng.uniform(-bound, bound, (3, 3, 3, cin, cout)).astype(np.float32)}
        if bias:
            out["bias"] = rng.uniform(-bound, bound, cout).astype(np.float32)
        return out

    def norm():
        return ({"scale": rng.uniform(0.8, 1.2, filters).astype(np.float32),
                 "bias": rng.normal(0, 0.1, filters).astype(np.float32)},
                {"mean": rng.normal(0, 0.05, filters).astype(np.float32),
                 "var": rng.uniform(0.05, 0.2, filters).astype(np.float32)})

    params, stats = {}, {}
    for name, width, residual in BLOCKS:
        cin = IN_CHANNELS if width == 0 else width * filters
        block, block_stats = {}, {}
        for i, c in enumerate((cin, filters)):
            block[f"Conv3d_{i}"] = conv(c, filters, bias=False)
            block[f"BatchNorm_{i}"], block_stats[f"BatchNorm_{i}"] = norm()
        if residual:
            block["res_conv"] = conv(cin, filters, bias=True)
        params[name], stats[name] = block, block_stats
    params["out_conv"] = conv(filters, OUT_CHANNELS, bias=True)
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
    """Answer ``requests`` requests of SUBJECTS_PER_REQUEST subjects, with
    the kernel's counts set to 0 just before and read just after."""
    def run():
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
        return times, batches

    torch.cuda.reset_peak_memory_stats()
    (times, batches), launches, by_shape = launches_counted(run)
    return times, batches, launches, by_shape


def launches_counted(run):
    """``run()`` with the forward kernel's counts set to 0 just before and
    read just after."""
    conv3x3_s1p1.launches = 0
    conv3x3_s1p1.launches_by_shape.clear()
    out = run()
    return out, conv3x3_s1p1.launches, Counter(conv3x3_s1p1.launches_by_shape)


def profiled(run):
    """Device-side events of ``run()`` under torch.profiler, longest first,
    and its wall time in ms (host clock, ending in a synchronize). ``run``
    goes twice, the first time as the profiler's warm-up: only the second
    is recorded, so that no launch falls into the tracer's start. Only
    kernels and copies count: an operator's own entry repeats the device
    time of the kernels it launched, and a user annotation (the profiler's
    step, the optimizer's step) spans them on the device's timeline."""
    averages = []
    with warm_profiler(averages) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    return device_events(averages), wall_ms


def warm_profiler(averages):
    """A torch.profiler that warms up until its first step() and records
    until its second, then appends the key averages to ``averages``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                   on_trace_ready=lambda p: averages.append(p.key_averages()),
                   acc_events=True)


def device_events(averages):
    """The kernels and copies of a recorded window, longest first."""
    from torch.autograd import DeviceType

    return sorted((e for e in (averages[0] if averages else [])
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not e.is_user_annotation),
                  key=lambda e: -e.self_device_time_total)


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


# dmri_hippo's modalities and whole-hippocampus labels, from its configuration.
INPUT_IMAGES = hippo_config.INPUT_IMAGES
WHOLE_LABELS = hippo_config.WHOLE_LABELS


def hippo_volumes(rng: np.random.Generator, grid):
    """One raw dmri_hippo subject on the scanner grid ``grid`` (W, H, D):
    the three modalities with a few NaN voxels, the whole-hippocampus label
    map (1 left, 2 right) and the atlas union mask, and an affine whose
    first axis is negative (world x falls as W grows, so the right
    hemisphere is the lower half of W)."""
    W, H, D = grid
    out = {}
    for name in INPUT_IMAGES:
        vol = rng.gamma(2.0, 1.0, (1, W, H, D)).astype(np.float32)
        vol.reshape(-1)[rng.choice(vol.size, 5, replace=False)] = np.nan
        out[name] = vol
    roi = np.zeros((1, W, H, D), np.int32)
    hw, hh, dd = max(W // 8, 1), max(H // 6, 1), max(D // 4, 1)
    h0, d0 = H // 2 + int(rng.integers(-1, 2)), D // 2
    roi[0, W // 2 - 3 * hw:W // 2 - hw, h0 - hh:h0 + hh, d0 - dd:d0 + dd] = 2  # right
    roi[0, W // 2 + hw:W // 2 + 3 * hw, h0 - hh:h0 + hh, d0 - dd:d0 + dd] = 1  # left
    union = np.zeros_like(roi)
    union[0, W // 2 - 3 * hw - 1:W // 2 + 3 * hw + 1, h0 - hh - 1:h0 + hh + 1,
          d0 - dd - 1:d0 + dd + 1] = 1
    out["whole_roi"], out["whole_roi_union"] = roi, union
    affine = np.diag([-1.2, 1.2, 1.5, 1.0])
    affine[:3, 3] = [0.6 * W, -0.6 * H, -0.75 * D]
    return out, affine


def hippo_subject(pkg, volumes, affine, name):
    """A Subject of ``pkg`` (the port, or any package with the same data
    model) holding copies of ``volumes``."""
    s = pkg.Subject(name=name)
    for key in INPUT_IMAGES:
        s[key] = pkg.ScalarImage(tensor=volumes[key].copy(), affine=affine)
    s["whole_roi"] = pkg.LabelMap(tensor=volumes["whole_roi"].copy(), affine=affine,
                                  label_values=dict(WHOLE_LABELS))
    s["whole_roi_union"] = pkg.LabelMap(tensor=volumes["whole_roi_union"].copy(),
                                        affine=affine)
    return s


# dmri_hippo TTA serving (research/dmri_hippo/hippo_inference.py
# --ensemble-flips --ensemble-folds --batched-tta): 2 folds, 4 flips each,
# folded into the batch of the 8 half-volumes of a request.
ORIGINAL_GRID = (112, 104, 20)
FOLDS, FLIP_DIMS = 2, (3, 4)
TTA_BATCH = 2 * SUBJECTS_PER_REQUEST * 2 ** len(FLIP_DIMS)
TTA_REQUESTS = 3
# EnsembleOrientations: one subject, the 8 flips of each of the 6
# permutations folded into one forward of its 2 half-volumes.
ORIENT_BATCH = 2 * 8


def tta_subjects(rng: np.random.Generator, n: int):
    """``n`` raw subjects on the scanner grid through the default pipeline."""
    pipeline = hippo_config.build_transforms(CROP, False)["default"]
    out = []
    for i in range(n):
        volumes, affine = hippo_volumes(rng, ORIGINAL_GRID)
        s = hippo_subject(tsp, volumes, affine, f"sub-{i:03d}")
        s["raw_affine"] = affine
        out.append(pipeline(s))
    return out


def fold_models(seed, device):
    models = []
    for k in range(FOLDS):
        model = SegModel(NestedResUNet(IN_CHANNELS, OUT_CHANNELS, filters=FILTERS,
                                       dropout_p=0.2), device=device)
        model.load_state_dict(flax_to_state_dict(
            flax_weights(np.random.default_rng(seed + k), FILTERS)))
        models.append(model)
    return models


def fold_flip_tta(folds, batched=True):
    return EnsembleModels([EnsembleFlips(m, "majority", spatial_dims=FLIP_DIMS, batched=batched)
                           for m in folds], "majority")


# affine TTA (hippo_inference --ensemble-affines 4 --ensemble-flips
# --ensemble-folds --batched-tta): per fold, 4 warps of the 4 flips of the
# 8 half-volumes in one forward
AFFINE_MEMBERS = 4
AFFINE_BATCH = AFFINE_MEMBERS * TTA_BATCH
AFFINE_REQUESTS = 2
# the CPU check: the identity and one warp on a cut of one half-volume
# (the full composition of one subject takes about two minutes on the card
# host's CPU); the cut keeps each side a multiple of 8 for the 3 pools
AFFINE_CPU_MEMBERS = 2
AFFINE_CPU_CUT = (24, 48, 24)
# its labels, card against CPU: the network's outputs agree within
# CPU_PROB_TOL, so a label moves only where a member's top two
# probabilities nearly tie or a vote ties; at most this share may differ
AFFINE_LABEL_AGREEMENT = 0.999


def affine_flip_tta(folds, members=AFFINE_MEMBERS):
    """hippo_inference's composition: each fold under batched flip TTA under
    batched affine TTA of ``members`` (majority, scales 0.1, degrees 10,
    seed 0), and a majority over the folds."""
    return EnsembleModels(
        [EnsembleAffines(EnsembleFlips(m, "majority", spatial_dims=FLIP_DIMS, batched=True),
                         num_members=members, scales=0.1, degrees=10,
                         strategy="majority", batched=True) for m in folds], "majority")


def check_original_grid(subjects):
    """Answers inverted to the scanner grid and post-processed: int32 labels
    in {0, 1, 2} on the original grid, with the original affine."""
    for s in subjects:
        y = s["y_pred"]
        assert y.data.shape == (1, *ORIGINAL_GRID) and y.data.dtype == np.int32, y
        assert set(np.unique(y.data)) <= {0, 1, 2}
        assert np.array_equal(y.affine, s["raw_affine"])


def labels_of(subjects):
    return [np.argmax(s["y_pred"].data, 0) for s in subjects]


def tta_requests(tta, predictor, pool, requests):
    """Answer ``requests`` TTA requests of SUBJECTS_PER_REQUEST fresh copies
    of subjects from ``pool``. Times, in ms on the host clock: the request
    (StandardPredict.predict on the ensemble, ending in a synchronize), the
    inversion to the scanner grid and the post-processing. Also returns the
    crop-space labels and the first subject's post-processing report of
    each request."""
    times = {"request": [], "inversion": [], "post-processing": []}
    labels, reports = [], []
    for r in range(requests):
        group = [copy.deepcopy(pool[(r * SUBJECTS_PER_REQUEST + i) % len(pool)])
                 for i in range(SUBJECTS_PER_REQUEST)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        group, batch = predictor.predict(tta, group)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        labels.append(labels_of(group))
        t2 = time.perf_counter()
        invert_predictions(group)
        t3 = time.perf_counter()
        reports.append([post_process(s["y_pred"]) for s in group][0])
        t4 = time.perf_counter()
        for key, (a, b) in zip(times, ((t0, t1), (t2, t3), (t3, t4))):
            times[key].append((b - a) * 1e3)
        assert tuple(batch["y_pred"].shape) == (SUBJECTS_PER_REQUEST, OUT_CHANNELS, *CROP)
        check_original_grid(group)
    shares = np.bincount(np.concatenate([s["y_pred"].data.ravel() for s in group]),
                         minlength=3) / (len(group) * np.prod(ORIGINAL_GRID))
    return times, labels, reports, shares


def orientation_launches(dtype, requests):
    """The forward's launches by shape for ``requests`` EnsembleOrientations
    requests of one subject: each class on each of the 6 permuted grids."""
    out = Counter()
    for perm in itertools.permutations(range(3)):
        for spatial, cin, cout, n in CONV_CLASSES:
            grid = tuple(spatial[p] for p in perm)
            out[(str(dtype), ORIENT_BATCH, *grid, cin, cout)] += n * requests
    return out


def check_orientation_grids(device, seed, card):
    """The forward kernel at every class of the 6 permuted grids of an
    orientation request, in float32, against its plain version."""
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    worst = 0.0
    keys = orientation_launches(torch.float32, 1)
    for _, n, w, h, d, cin, cout in keys:
        x = torch.rand((n, w, h, d, cin), generator=gen, device=device) * 2 - 1
        k = (torch.rand((3, 3, 3, cin, cout), generator=gen, device=device) * 2 - 1) \
            / np.sqrt(27 * cin)
        out, ref = conv3x3_s1p1(x, k), conv3x3_s1p1_plain(x, k)
        torch.cuda.synchronize()
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        if not err <= TF32X3_TOL:
            raise AssertionError(f"conv3x3_s1p1_f32 {n}x{w}x{h}x{d} {cin}->{cout}: max abs err "
                                 f"{err} of max|ref| > {TF32X3_TOL}")
        worst = max(worst, err)
    print(f"kernel conv3x3_s1p1_f32 at the {len(keys)} classes of the 6 permuted grids "
          f"(N={ORIENT_BATCH}): within {worst:.3g} of max|ref| of the plain version [{card}]",
          flush=True)


def tta_phase(card, seed, rows):
    """dmri_hippo TTA serving on the card: requests of 4 raw subjects
    (112x104x20) through the default pipeline, 2 folds of NestedResUNet-40
    under batched flip TTA and a majority vote, StandardPredict with the
    sagittal split, the inversion to the scanner grid and the
    post-processing; f32, then bf16. Fills the launches of the N=32 rows."""
    rng = np.random.default_rng(seed + 5)
    pool = tta_subjects(rng, 2 * SUBJECTS_PER_REQUEST)
    folds = fold_models(seed, "cuda")
    tta = fold_flip_tta(folds)
    predictor = StandardPredict(sagittal_split=True, image_names=["X"])
    per_request = FOLDS * CONVS_PER_FORWARD
    by_dtype = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = DTYPE_NAMES[dtype]
        for m in folds:
            m.compute_dtype = None if dtype == torch.float32 else "bfloat16"
        # one untimed, uncounted request first (f32: the cold one)
        tta_requests(tta, predictor, pool, 1)
        torch.cuda.reset_peak_memory_stats()
        (times, labels, reports, shares), launches, by_shape = launches_counted(
            lambda: tta_requests(tta, predictor, pool, TTA_REQUESTS))
        peak = torch.cuda.max_memory_allocated()
        assert launches == TTA_REQUESTS * per_request, launches
        assert by_shape == expected_launches(dtype, TTA_REQUESTS * FOLDS, TTA_BATCH), by_shape
        by_dtype[str(dtype)] = by_shape
        for key, values in times.items():
            print(f"tta {name} {key}: " + ", ".join(f"{t:.3f}" for t in values) + " ms",
                  flush=True)
        med = {key: statistics.median(values) for key, values in times.items()}
        print(f"tta {name}: median {med['request']:.3f} ms per request over {TTA_REQUESTS} "
              f"({FOLDS} folds x {2 ** len(FLIP_DIMS)} flips, {per_request} launches per request "
              f"at N={TTA_BATCH}), {SUBJECTS_PER_REQUEST / med['request'] * 1e3:.3f} volumes/s, "
              f"max_memory_allocated {peak} bytes; per request, inversion median "
              f"{med['inversion']:.3f} ms and post-processing median "
              f"{med['post-processing']:.3f} ms (host) [{card}]", flush=True)
        print(f"tta {name} answers on {'x'.join(map(str, ORIGINAL_GRID))}: label shares "
              + ", ".join(f"{c}: {v:.4f}" for c, v in enumerate(shares))
              + " (last request); first subject's post-processing per request: "
              + " | ".join(r.replace("\n", " ") for r in reports), flush=True)
        profile_request(tta, predictor, [copy.deepcopy(s) for s in pool[:SUBJECTS_PER_REQUEST]],
                        f"tta {name}", card)
        if dtype == torch.float32:
            tta_checks(card, seed, folds, predictor, pool, labels[0])
    affine_part(card, seed, folds, predictor, pool)
    for row in rows:
        row["launches"] = by_dtype[row["_key"][0]][row["_key"]]
        assert row["launches"] > 0, row["name"]


def affine_part(card, seed, folds, predictor, pool):
    """Affine TTA requests (affine_flip_tta) of 4 subjects in f32 and bf16:
    ms per request, peak memory, 2 forwards of 25 launches at N=128; then
    fold 0's composition (AFFINE_CPU_MEMBERS members) on a cut of the
    first subject's first half-volume on the card and on the port on the
    CPU."""
    tta = affine_flip_tta(folds)
    per_request = FOLDS * CONVS_PER_FORWARD
    for dtype in DTYPES:
        name = DTYPE_NAMES[dtype]
        for m in folds:
            m.compute_dtype = None if dtype == torch.float32 else "bfloat16"
        with uncounted():
            tta_requests(tta, predictor, pool, 1)
        torch.cuda.reset_peak_memory_stats()
        (times, _, _, shares), launches, by_shape = launches_counted(
            lambda: tta_requests(tta, predictor, pool, AFFINE_REQUESTS))
        peak = torch.cuda.max_memory_allocated()
        assert launches == AFFINE_REQUESTS * per_request, launches
        assert by_shape == expected_launches(dtype, AFFINE_REQUESTS * FOLDS, AFFINE_BATCH), \
            by_shape
        host_ms = statistics.median(times["inversion"]) \
            + statistics.median(times["post-processing"])
        print(f"tta affine {name} (--ensemble-affines {AFFINE_MEMBERS} --ensemble-flips "
              f"--ensemble-folds --batched-tta): median "
              f"{statistics.median(times['request']):.3f} ms per request over "
              f"{AFFINE_REQUESTS} (" + ", ".join(f"{t:.3f}" for t in times["request"])
              + f"), {per_request} launches per request at N={AFFINE_BATCH}, "
              f"max_memory_allocated {peak} bytes; inversion + post-processing median "
              f"{host_ms:.3f} ms (host); label shares " + ", ".join(f"{v:.4f}" for v in shares)
              + f" [{card}]", flush=True)
    for m in folds:
        m.compute_dtype = None
    # fold 0's composition with the identity and one warp, on a cut of the
    # first subject's first half-volume (8 forwards on the CPU)
    torch.set_num_threads(os.cpu_count() or 1)
    x = split_and_flip(collate_subjects([copy.deepcopy(pool[0])], ["X"], device="cuda")["X"])
    x = x[:1, :, :AFFINE_CPU_CUT[0], :AFFINE_CPU_CUT[1], :AFFINE_CPU_CUT[2]].contiguous()
    cpu_fold = fold_models(seed, "cpu")[0]
    with uncounted():
        on_card = affine_flip_tta([folds[0]], AFFINE_CPU_MEMBERS)(x).cpu()
    t0 = time.perf_counter()
    on_cpu = affine_flip_tta([cpu_fold], AFFINE_CPU_MEMBERS)(x.cpu())
    cpu_s = time.perf_counter() - t0
    a, b = on_card.argmax(1), on_cpu.argmax(1)
    agree = float((a == b).float().mean())
    print(f"tta affine f32 fold 0 composition ({AFFINE_CPU_MEMBERS} members x "
          f"{2 ** len(FLIP_DIMS)} flips, a {'x'.join(map(str, x.shape[2:]))} cut of one "
          f"half-volume) vs CPU port: labels equal on "
          f"{agree:.6f} of the voxels ({int((a != b).sum())} differ; at least "
          f"{AFFINE_LABEL_AGREEMENT} required); CPU took {cpu_s:.1f} s [{card}]",
          flush=True)
    assert agree >= AFFINE_LABEL_AGREEMENT, agree


def tta_checks(card, seed, folds, predictor, pool, batched_labels):
    """f32 only: unrolled against batched, the bit-packed fetch against the
    plain one, fold 0's flip TTA against the port on the CPU, and one
    EnsembleOrientations request with one permuted forward against the
    CPU."""
    first = [copy.deepcopy(s) for s in pool[:SUBJECTS_PER_REQUEST]]
    (subjects, _), launches, by_shape = launches_counted(
        lambda: predictor.predict(fold_flip_tta(folds, batched=False),
                                  [copy.deepcopy(s) for s in first]))
    unrolled_forwards = FOLDS * 2 ** len(FLIP_DIMS)
    assert launches == unrolled_forwards * CONVS_PER_FORWARD, launches
    assert by_shape == expected_launches(torch.float32, unrolled_forwards,
                                         2 * SUBJECTS_PER_REQUEST), by_shape
    same = all(np.array_equal(a, b) for a, b in zip(labels_of(subjects), batched_labels))
    x = collate_subjects(first, ["X"], device="cuda")["X"]
    split = split_and_flip(x)
    probs = [EnsembleFlips(folds[0], "mean", FLIP_DIMS, batched=b)(split) for b in (True, False)]
    diff = (probs[0] - probs[1]).abs().max().item()
    print(f"tta f32 unrolled ({unrolled_forwards} forwards x {CONVS_PER_FORWARD} launches at "
          f"N={2 * SUBJECTS_PER_REQUEST}) against batched: labels equal {same}; fold 0's flip "
          f"mean, max abs prob diff {diff:.3g} [{card}]", flush=True)
    assert same

    packed = StandardPredict(sagittal_split=True, image_names=["X"], device_argmax=True)
    subjects, _ = packed.predict(fold_flip_tta(folds), [copy.deepcopy(s) for s in first])
    plain, _ = predictor.predict(fold_flip_tta(folds), [copy.deepcopy(s) for s in first])
    assert all(np.array_equal(a["y_pred"].data, b["y_pred"].data)
               for a, b in zip(subjects, plain))
    print("tta f32 device_argmax: the bit-packed fetch gives the plain fetch's answers",
          flush=True)

    # The first subject's first half-volume through fold 0's flip TTA, on
    # the card and the CPU (both halves took 31-37 s of CPU).
    torch.set_num_threads(os.cpu_count() or 1)
    cpu_fold = fold_models(seed, "cpu")[0]
    card_flips = EnsembleFlips(folds[0], "majority", FLIP_DIMS, batched=True)
    cpu_flips = EnsembleFlips(cpu_fold, "majority", FLIP_DIMS, batched=True)
    half = split[:1]
    t0 = time.perf_counter()
    members_cpu = cpu_flips._members(half.cpu())
    cpu_s = time.perf_counter() - t0
    members_gpu = [m.cpu() for m in card_flips._members(half)]
    compare_cpu("tta f32 fold 0 flips vs CPU port (first subject's first half-volume)",
                members_gpu, members_cpu, cpu_s, card)

    orient = EnsembleOrientations(folds[0], "majority", batched=True)
    one = [copy.deepcopy(pool[0])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (answered, batch), launches, by_shape = launches_counted(
        lambda: predictor.predict(orient, one))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    assert launches == 6 * CONVS_PER_FORWARD, launches
    assert by_shape == orientation_launches(torch.float32, 1), by_shape
    assert tuple(batch["y_pred"].shape) == (1, OUT_CHANNELS, *CROP)
    invert_predictions(answered)
    post_process(answered[0]["y_pred"])
    check_original_grid(answered)
    print(f"tta f32 EnsembleOrientations (majority, batched; 1 subject, 6 forwards x "
          f"{CONVS_PER_FORWARD} launches at N={ORIENT_BATCH}): {ms:.3f} ms [{card}]", flush=True)
    perm = (4, 2, 3)
    x_perm = half.permute(0, 1, *perm).contiguous()
    t0 = time.perf_counter()
    p_cpu = cpu_fold(x_perm.cpu())
    cpu_s = time.perf_counter() - t0
    compare_cpu(f"tta f32 permuted forward {tuple(x_perm.shape[2:])} vs CPU port",
                [folds[0](x_perm).cpu()], [p_cpu], cpu_s, card)


def compare_cpu(name, card_probs, cpu_probs, cpu_s, card):
    """Probabilities within CPU_PROB_TOL; labels equal where no member's
    top two probabilities are within CPU_TIE."""
    diff = max((g - c).abs().max().item() for g, c in zip(card_probs, cpu_probs))
    tie = torch.zeros_like(cpu_probs[0][:, 0], dtype=torch.bool)
    differ = torch.zeros_like(tie)
    for g, c in zip(card_probs, cpu_probs):
        top2 = torch.topk(c, 2, dim=1).values
        tie |= (top2[:, 0] - top2[:, 1]) < CPU_TIE
        differ |= g.argmax(1) != c.argmax(1)
    bad = (differ & ~tie).sum().item()
    print(f"{name}: max abs prob diff {diff:.3g} over {len(cpu_probs)} member(s), "
          f"{differ.sum().item()} labels differ, {bad} of them outside a top-two gap < "
          f"{CPU_TIE}; CPU took {cpu_s:.1f} s [{card}]", flush=True)
    assert diff <= CPU_PROB_TOL and bad == 0


# msseg2 serving (research/msseg2/msseg2.py, research/msseg2/competition/
# ms_inference.py): the depth-6 BlurConv ModularUNet on 96^3 patches.
MS_TIMEPOINTS = msseg2_config.TIMEPOINTS
MS_FILTERS = (40, 40, 80, 80, 120, 120)
MS_IN_CHANNELS, MS_OUT_CHANNELS = 2, 2
MS_PATCH = 96


def msseg2_network(filters=MS_FILTERS, remat=True):
    """msseg2's model (research/msseg2/msseg2.py:163-176): ModularUNet(2 -> 2,
    depth len(filters)), residual blocks, BlurConv3d down-samplers and
    BlurConvTranspose3d up-samplers, rematerialized blocks unless ``remat``
    is False."""
    return ModularUNet(MS_IN_CHANNELS, MS_OUT_CHANNELS, filters=list(filters),
                       depth=len(filters),
                       block_params={"residual": True},
                       downsample_class=BlurConv3d,
                       downsample_params={"kernel_size": 3, "stride": 2, "padding": 1},
                       upsample_class=BlurConvTranspose3d,
                       upsample_params={"kernel_size": 3, "stride": 2, "padding": 1,
                                        "output_padding": 0},
                       remat=remat)


def msseg2_state(rng: np.random.Generator, module):
    """Random weights for ``module`` in the port's state-dict layout: torch's
    conv init for every conv kernel, small nonzero biases, BatchNorm scales
    and statistics off their init values (positive, non-unit variances)."""
    out = {}
    for key, value in module.state_dict().items():
        shape, leaf = tuple(value.shape), key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[key] = torch.tensor(0)
            continue
        if value.dim() == 5:
            bound = 1 / np.sqrt(np.prod(shape[1:]))
            v = rng.uniform(-bound, bound, shape)
        elif leaf == "running_var":
            v = rng.uniform(0.1, 0.2, shape)
        elif leaf == "running_mean":
            v = rng.normal(0, 0.05, shape)
        elif leaf == "weight":
            v = rng.uniform(0.8, 1.2, shape)
        else:
            v = rng.normal(0, 0.1, shape)
        out[key] = torch.from_numpy(v.astype(np.float32))
    return out


def msseg2_model(seed, device):
    module = msseg2_network()
    state = msseg2_state(np.random.default_rng(seed), module)
    model = SegModel(module, device=device)
    model.load_state_dict(state)
    return model


def msseg2_volumes(rng: np.random.Generator, grid, spacing, semi_axes_mm):
    """One raw msseg2 subject on the scanner grid ``grid`` (W, H, D) of
    ``spacing`` mm: the brain mask (an ellipsoid of ``semi_axes_mm`` around
    the centre), two FLAIRs (tissue brighter than the background, with noise
    and a few bright lesions, more of them in the second), the ground truth
    (the second FLAIR's lesions) and an affine whose first axis is
    negative."""
    centre = [(n - 1) / 2 for n in grid]
    axes = np.ogrid[tuple(slice(0, n) for n in grid)]
    r2 = sum(((a - c) * s / r) ** 2 for a, c, s, r in zip(axes, centre, spacing, semi_axes_mm))
    brain = r2 <= 1.0
    inside = np.argwhere(brain)
    out = {"brain_mask": brain[None].astype(np.int32)}
    lesions = np.zeros(grid, np.int32)
    for t, name in enumerate(MS_TIMEPOINTS):
        flair = np.where(brain, 1.0, 0.1).astype(np.float32)
        flair += rng.normal(0, 0.05, grid).astype(np.float32)
        for w, h, d in inside[rng.choice(len(inside), 4 + 2 * t, replace=False)]:
            box = (slice(max(w - 2, 0), w + 3), slice(max(h - 2, 0), h + 3),
                   slice(max(d - 1, 0), d + 2))
            flair[box] += 0.8
            if t == 1:
                lesions[box] = 1
        out[name] = flair[None]
    out["ground_truth"] = lesions[None]
    affine = np.diag([-spacing[0], spacing[1], spacing[2], 1.0])
    affine[:3, 3] = [spacing[0] * grid[0] / 2, -spacing[1] * grid[1] / 2,
                     -spacing[2] * grid[2] / 2]
    return out, affine


def msseg2_subject(pkg, volumes, affine, name, ground_truth=False):
    """A raw Subject of ``pkg`` (the port, or any package with the same data
    model) holding copies of ``volumes``, as msseg2's loaders make it: a
    serving subject, or with ``ground_truth`` a training one."""
    s = pkg.Subject(name=name)
    for key in MS_TIMEPOINTS:
        s[key] = pkg.ScalarImage(tensor=volumes[key].copy(), affine=affine)
    s["brain_mask"] = pkg.LabelMap(tensor=volumes["brain_mask"].copy(), affine=affine,
                                   label_values={"brain": 1})
    if ground_truth:
        s["ground_truth"] = pkg.LabelMap(tensor=volumes["ground_truth"].copy(), affine=affine,
                                         label_values={"lesion": 1})
    return s


def validation_predictor():
    """The msseg2 trainer's validation predictor
    (research/msseg2/msseg2.py:213-219)."""
    return PatchPredict(patch_batch_size=32, patch_size=MS_PATCH,
                        patch_overlap=MS_PATCH // 8, padding_mode=None,
                        overlap_mode="average", image_names=["X"])


# The msseg2 phase: a raw subject of 256x256x144 at (0.9375, 0.9375, 1.2) mm,
# which TargetResample(1, 0.11) takes to 256x256x192 at (0.9375, 0.9375,
# 0.9), with a brain of (70, 85, 65.5) mm semi-axes: about 150x182x146 in
# model space, 27 patches for the competition predictor (3 per axis, the
# last snapped to the boundary), 12 for the validation one.
MS_RAW_GRID = (256, 256, 144)
MS_RAW_SPACING = (0.9375, 0.9375, 1.2)
MS_SEMI_AXES_MM = (70.0, 85.0, 65.5)
# ModularUNet(2 -> 2, MS_FILTERS) on a 96^3 patch: ((W, H, D), Cin, Cout,
# launches per forward) of its 3x3x3 convs.
MS_CONV_CLASSES = [
    ((96,) * 3, 2, 40, 2), ((96,) * 3, 40, 40, 2), ((96,) * 3, 80, 40, 2),
    ((96,) * 3, 40, 2, 1),
    ((48,) * 3, 40, 40, 4), ((48,) * 3, 120, 40, 2),
    ((24,) * 3, 40, 80, 2), ((24,) * 3, 80, 80, 2), ((24,) * 3, 160, 80, 2),
    ((12,) * 3, 80, 80, 4), ((12,) * 3, 200, 80, 2),
    ((6,) * 3, 80, 120, 2), ((6,) * 3, 120, 120, 2), ((6,) * 3, 240, 120, 2),
    ((3,) * 3, 120, 120, 3),
]
MS_CONVS_PER_FORWARD = 34
# timed requests a dtype: each carries about 5 s of host pipeline and way
# back, within the script's time budget
MS_REQUESTS, MS_SWEEPS = 1, 1
# The validation batch at which one activation passes 2**31 elements:
# up_block_0's input, 32 x 96^3 x 80.
MS_LARGE_BATCH, MS_LARGE_CLASSES = 32, [((96,) * 3, 80, 40, 1)]


def check_classes(device, seed, card, n, classes):
    """The forward kernel at batch ``n`` at each class of ``classes``,
    untimed, in f32 and bf16: against its plain version on random inputs
    and bit for bit on small integers."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        for spatial, cin, cout, _ in classes:
            name = (f"conv3x3_s1p1_{DTYPE_NAMES[dtype]} {n}x{'x'.join(map(str, spatial))} "
                    f"{cin}->{cout}")
            x = (torch.rand((n, *spatial, cin), generator=gen, device=device) * 2 - 1).to(dtype)
            k = ((torch.rand((3, 3, 3, cin, cout), generator=gen, device=device) * 2 - 1)
                 / np.sqrt(27 * cin)).to(dtype)
            out = conv3x3_s1p1(x, k)
            ref = conv3x3_s1p1_plain(x, k).float()
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            scale = ref.abs().max().item()
            del out, ref
            if not err <= KERNEL_TOL[dtype] * scale:
                raise AssertionError(f"{name}: max abs err {err} > {KERNEL_TOL[dtype]} * {scale}")
            print(f"kernel {name} ({x.numel()} input elements, untimed): err {err:.3g} "
                  f"(max|ref| {scale:.3g}) [{card}]", flush=True)
            del x
            x = torch.randint(-INT_MAX, INT_MAX + 1, (n, *spatial, cin), generator=gen,
                              device=device, dtype=torch.int8).to(dtype)
            k = torch.randint(-INT_MAX, INT_MAX + 1, (3, 3, 3, cin, cout), generator=gen,
                              device=device, dtype=torch.int8).to(dtype)
            check_exact(name, conv3x3_s1p1, conv3x3_s1p1_plain, x, k)
            del x, k
            torch.cuda.empty_cache()


def ms_expected_launches(dtype, forwards, batch):
    return Counter({(str(dtype), batch, *spatial, cin, cout): n * forwards
                    for spatial, cin, cout, n in MS_CONV_CLASSES})


def ms_requests(model, predictor, raws, requests):
    """Answer ``requests`` competition requests, each one raw subject from
    ``raws`` through the default pipeline, the prediction and the way back
    to the raw grid. Times in ms on the host clock (the request ends in a
    synchronize); answers checked on the raw grid."""
    pipeline = msseg2_config.build_pipelines(MS_PATCH)["default"]
    times = {"pipeline": [], "request": [], "back to the raw grid": []}
    answers = []
    for r in range(requests):
        raw = raws[r % len(raws)]
        t0 = time.perf_counter()
        subject = pipeline(copy.deepcopy(raw))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        [subject], _ = predictor.predict(model, [subject])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        label, report = ms_to_raw_grid(subject, raw)
        t3 = time.perf_counter()
        for key, (a, b) in zip(times, ((t0, t1), (t1, t2), (t2, t3))):
            times[key].append((b - a) * 1e3)
        first = raw.get_first_image()
        assert label.data.shape == (1, *first.spatial_shape) and label.data.dtype == np.int32
        assert set(np.unique(label.data)) <= {0, 1}, np.unique(label.data)
        assert np.array_equal(label.affine, first.affine)
        answers.append((label, report))
    return times, answers


def msseg2_phase(card, seed, rows):
    """msseg2 serving on the card, as research/msseg2/competition/
    ms_inference.py runs it (non-fused) and as the trainer's validation sweep
    predicts: raw FLAIR pairs of 256x256x144 through the default pipeline,
    PatchPredict on the depth-6 BlurConv ModularUNet, the inversion, the
    cleanup and the resample back; f32, then bf16. Fills the launches of the
    N=1 rows."""
    rng = np.random.default_rng(seed + 7)
    raws = [msseg2_subject(tsp, *msseg2_volumes(rng, MS_RAW_GRID, MS_RAW_SPACING,
                                                MS_SEMI_AXES_MM), f"ms-{i}") for i in range(2)]
    t0 = time.perf_counter()
    pipeline = msseg2_config.build_pipelines(MS_PATCH)["default"]
    subjects = [pipeline(copy.deepcopy(r)) for r in raws]
    pipeline_ms = (time.perf_counter() - t0) * 1e3 / len(raws)
    shape = subjects[0]["X"].spatial_shape
    assert all(s["X"].spatial_shape == shape for s in subjects)
    spacing = subjects[0]["X"].spacing
    patches = len(grid_locations(shape, (MS_PATCH,) * 3, (MS_PATCH // 2,) * 3))
    val_patches = len(grid_locations(shape, (MS_PATCH,) * 3, (MS_PATCH // 8,) * 3))
    print(f"msseg2 subject: raw {'x'.join(map(str, MS_RAW_GRID))} at {MS_RAW_SPACING} mm, "
          f"model space 2x{'x'.join(map(str, shape))} at "
          f"({', '.join(f'{v:.4f}' for v in spacing)}) mm; {patches} patches per competition "
          f"request (overlap {MS_PATCH // 2}), {val_patches} per validation subject (overlap "
          f"{MS_PATCH // 8}); default "
          f"pipeline {pipeline_ms:.1f} ms per subject (host)", flush=True)
    # the validation sweep runs each class at N=val_patches: held there too
    check_classes(torch.device("cuda"), seed + 9, card, val_patches, MS_CONV_CLASSES)

    model = msseg2_model(seed, "cuda")
    competition = competition_predictor(device_argmax=True)
    by_dtype = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = DTYPE_NAMES[dtype]
        model.compute_dtype = None if dtype == torch.float32 else "bfloat16"
        # one untimed, uncounted request first (f32: the cold one)
        t0 = time.perf_counter()
        ms_requests(model, competition, raws, 1)
        cold_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats()
        (times, answers), launches, by_shape = launches_counted(
            lambda: ms_requests(model, competition, raws, MS_REQUESTS))
        peak = torch.cuda.max_memory_allocated()
        assert launches == MS_REQUESTS * patches * MS_CONVS_PER_FORWARD, launches
        assert by_shape == ms_expected_launches(dtype, MS_REQUESTS * patches, 1), by_shape
        by_dtype[str(dtype)] = by_shape
        for key, values in times.items():
            print(f"msseg2 {name} {key}: " + ", ".join(f"{t:.3f}" for t in values) + " ms",
                  flush=True)
        med = {key: statistics.median(values) for key, values in times.items()}
        shares = [float((label.data == 1).mean()) for label, _ in answers]
        print(f"msseg2 {name} competition request (patch_batch_size=1, overlap "
              f"{MS_PATCH // 2}, edge, "
              f"device_argmax): median {med['request']:.3f} ms over {MS_REQUESTS} after an "
              f"untimed one ({cold_ms:.3f} ms with its host work), {patches} forwards x "
              f"{MS_CONVS_PER_FORWARD} launches at N=1, max_memory_allocated {peak} bytes; "
              f"host: default pipeline median {med['pipeline']:.3f} ms, inversion + cleanup + "
              f"resample back median {med['back to the raw grid']:.3f} ms; lesion share on "
              f"the raw grid {', '.join(f'{v:.4f}' for v in shares)}; cleanup (holes filled, "
              f"voxels removed) {[r for _, r in answers]} [{card}]", flush=True)
        ms_validation_sweeps(card, model, subjects, dtype, val_patches)
        if dtype == torch.float32:
            ms_checks(card, seed, model, subjects)
        profile_request(model, competition, [copy.deepcopy(subjects[0])],
                        f"msseg2 {name}", card)
    model.compute_dtype = None
    for row in rows:
        row["launches"] = by_dtype[row["_key"][0]][row["_key"]]
        assert row["launches"] > 0, row["name"]


def ms_validation_sweeps(card, model, subjects, dtype, val_patches):
    """1 + MS_SWEEPS sweeps of the trainer's validation predictor over the
    subjects: one forward of all their patches each (the batch is not
    halved), the full probabilities fetched."""
    name = DTYPE_NAMES[dtype]
    predictor = validation_predictor()
    predictor.predict(model, [copy.deepcopy(s) for s in subjects])
    torch.cuda.reset_peak_memory_stats()
    times = []

    def sweeps():
        for _ in range(MS_SWEEPS):
            group = [copy.deepcopy(s) for s in subjects]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, batch = predictor.predict(model, group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            assert batch["y_pred"].shape == (len(subjects), 2, *subjects[0]["X"].spatial_shape)
            assert np.isfinite(batch["y_pred"]).all()

    _, launches, by_shape = launches_counted(sweeps)
    peak = torch.cuda.max_memory_allocated()
    assert predictor._effective_patch_batch == predictor.patch_batch_size, "batch was halved"
    assert launches == MS_SWEEPS * len(subjects) * MS_CONVS_PER_FORWARD, launches
    assert by_shape == ms_expected_launches(dtype, MS_SWEEPS * len(subjects), val_patches), \
        by_shape
    print(f"msseg2 {name} validation sweep (patch_batch_size=32, overlap {MS_PATCH // 8}, "
          f"{len(subjects)} subjects, one forward of N={val_patches} each): "
          + ", ".join(f"{t:.3f}" for t in times) + f" ms, median {statistics.median(times):.3f} "
          f"ms per sweep after an untimed one, max_memory_allocated {peak} bytes, batch not "
          f"halved [{card}]", flush=True)


def ms_checks(card, seed, model, subjects):
    """f32 only: a device_argmax request against a full-probability one, the
    validation batch against batches of 1, one patch cut to MS_CPU_PATCH^3
    against the port on the CPU, and cuDNN's TF32 against the port's library
    convs."""
    one = subjects[0]
    [packed], _ = competition_predictor(device_argmax=True).predict(model, [copy.deepcopy(one)])
    [full], _ = competition_predictor(device_argmax=False).predict(model, [copy.deepcopy(one)])
    probs = np.asarray(full["y_pred"].data)
    assert np.array_equal(np.argmax(packed["y_pred"].data, 0), np.argmax(probs, 0))
    print(f"msseg2 f32 device_argmax: the bit-packed ids give the full fetch's argmax "
          f"(foreground share {np.argmax(probs, 0).mean():.4f}, probability of class 1 "
          f"{probs[1].min():.3f}..{probs[1].max():.3f})", flush=True)

    _, batched = validation_predictor().predict(model, [copy.deepcopy(one)])
    single = validation_predictor()
    single.patch_batch_size = 1
    _, unbatched = single.predict(model, [copy.deepcopy(one)])
    diff = np.abs(batched["y_pred"] - unbatched["y_pred"]).max()
    print(f"msseg2 f32 validation predictor at batch 32 against batch 1: max abs prob diff "
          f"{diff:.3g} [{card}]", flush=True)
    assert diff <= CPU_PROB_TOL

    torch.set_num_threads(os.cpu_count() or 1)
    cpu_model = msseg2_model(seed, "cpu")
    cut = MS_CPU_PATCH  # a 96^3 patch took 17-19 s on the CPU
    x = torch.from_numpy(np.ascontiguousarray(one["X"].data[:, :cut, :cut, :cut]))
    t0 = time.perf_counter()
    p_cpu = cpu_model(x[None])
    cpu_s = time.perf_counter() - t0
    compare_cpu(f"msseg2 f32 {cut}^3 patch vs CPU port", [model(x[None]).cpu()], [p_cpu],
                cpu_s, card)

    xs = torch.from_numpy(np.random.default_rng(seed).normal(size=(2, 48, 48, 48, 40))
                          .astype(np.float32)).cuda()
    k = torch.from_numpy((np.random.default_rng(seed + 1).uniform(-1, 1, (4, 4, 4, 40, 40))
                          / np.sqrt(64 * 40)).astype(np.float32)).cuda()
    for conv in (convolution.conv3d, convolution.conv_transpose3d):
        ref = conv(xs.double(), k.double(), stride=2, padding=1)
        torch.backends.cudnn.allow_tf32 = True
        try:
            port = conv(xs, k, stride=2, padding=1)
            cf = xs.permute(0, 4, 1, 2, 3)
            bare = (F.conv3d(cf, k.permute(4, 3, 0, 1, 2), stride=2, padding=1)
                    if conv is convolution.conv3d else
                    F.conv_transpose3d(cf, k.permute(3, 4, 0, 1, 2), stride=2, padding=1)
                    ).permute(0, 2, 3, 4, 1)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        scale = ref.abs().max().item()
        errs = [(t.double() - ref).abs().max().item() / scale for t in (port, bare)]
        print(f"msseg2 f32 {conv.__name__} with cuDNN's TF32 on for the process: the port's "
              f"conv within {errs[0]:.3g} of max|ref| of float64, a bare F call "
              f"{errs[1]:.3g} [{card}]", flush=True)
        assert errs[0] <= TF32X3_TOL


def ms_totals(rows, card):
    """The forward kernel's time per competition request in each dtype
    (patches x 34 launches at N=1), beside its plain version's, cuDNN's and
    the bound."""
    for dtype, name in DTYPE_NAMES.items():
        picked = [(row, row["launches"] / MS_REQUESTS) for row in rows
                  if row["_key"][0] == str(dtype)]
        total = {key: sum(row[key] * n for row, n in picked)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"per msseg2 request fwd {name}: kernel {total['ms']:.4f} ms, plain "
              f"{total['plain_ms']:.4f}, cuDNN {total['library_ms']:.4f}, bound "
              f"{total['bound_ms']:.4f} ({sum(n for _, n in picked):.0f} launches at N=1) "
              f"[{card}]", flush=True)


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


def tta_totals(rows, card):
    """The forward kernel's time per TTA request in each dtype (FOLDS
    forwards of 25 launches at N=TTA_BATCH), beside its plain version's,
    cuDNN's and the bound."""
    per_forward = {(*spatial, cin, cout): n for spatial, cin, cout, n in CONV_CLASSES}
    for dtype, name in DTYPE_NAMES.items():
        picked = [(row, row["launches"] // TTA_REQUESTS) for row in rows
                  if row["_key"][0] == str(dtype)]
        assert all(n == FOLDS * per_forward[row["_key"][2:]] for row, n in picked)
        total = {key: sum(row[key] * n for row, n in picked)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"per TTA request fwd {name}: kernel {total['ms']:.4f} ms, plain "
              f"{total['plain_ms']:.4f}, cuDNN {total['library_ms']:.4f}, bound "
              f"{total['bound_ms']:.4f} ({sum(n for _, n in picked)} launches at "
              f"N={TTA_BATCH}) [{card}]", flush=True)


def step_totals(label, rows, launches_per_step, card):
    """Each kernel kind's time per train step in each dtype, beside its
    plain version's, cuDNN's and the bound: sums of launches per step
    (``launches_per_step(row)``) times ms per launch over the classes."""
    for dtype, name in DTYPE_NAMES.items():
        for kind in ("fwd", "dx", "dw"):
            picked = [(row, launches_per_step(row)) for row in rows
                      if row["_kind"] == kind and row["_key"][0] == str(dtype)]
            if not picked:
                continue
            keys = ["ms", "plain_ms", "library_ms", "bound_ms"]
            if dtype == torch.float32:
                keys.append("_bound_cuda_cores")
            total = {key: sum(row[key] * n for row, n in picked) for key in keys}
            both = (f" (3xTF32; CUDA cores {total['_bound_cuda_cores']:.4f})"
                    if dtype == torch.float32 else "")
            print(f"{label} {kind} {name}: kernel {total['ms']:.4f} ms, plain "
                  f"{total['plain_ms']:.4f}, cuDNN {total['library_ms']:.4f}, bound "
                  f"{total['bound_ms']:.4f}{both} ({sum(n for _, n in picked)} launches) "
                  f"[{card}]", flush=True)


def cpu_train_comparison(card, name, make_module, make_optimizer, criterion, state_dict, one,
                         sagittal_split=False, refine_image=None):
    """One f32 train step on the channel-first batch ``one``, on the card and
    on the port on the CPU, from ``state_dict``: the loss and every
    parameter's gradient."""
    torch.set_num_threads(os.cpu_count() or 1)

    def run(device, batch):
        model = SegModel(make_module(), device=device)
        model.load_state_dict(state_dict)
        optimizer = make_optimizer()
        state = create_train_state(model, optimizer, batch)
        step = make_train_step(model.module, criterion, optimizer, sagittal_split=sagittal_split,
                               refine_image=refine_image)
        t0 = time.perf_counter()
        state, loss_dict, _ = step(state, collate_to_device(batch, device=device), None)
        loss = loss_dict["loss"].item()
        return (loss, {k: p.grad.detach().cpu() for k, p in state.params.items()},
                time.perf_counter() - t0)

    def worst(grads, ref):
        return max(((grads[k] - g).abs().max().item() / g.abs().max().item(), k)
                   for k, g in ref.items())

    (loss_gpu, grads_gpu, _), (loss_cpu, grads_cpu, cpu_s) = run("cuda", one), run("cpu", one)
    card_diff = worst(grads_gpu, grads_cpu)
    loss_diff = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    print(f"{name}: loss {loss_gpu:.7f} vs "
          f"{loss_cpu:.7f} (rel diff {loss_diff:.3g}); worst gradient max abs diff / "
          f"max|grad| {card_diff[0]:.3g} at {card_diff[1]} over {len(grads_cpu)} parameters; "
          f"CPU step took {cpu_s:.1f} s [{card}]", flush=True)
    assert loss_diff <= CPU_LOSS_TOL and card_diff[0] <= CPU_GRAD_TOL


# msseg2 training, as research/msseg2/msseg2.py:163-231 runs it
# (tpu_fast_path=False): raw training subjects through the ``training``
# pipeline, PatchDataLoader(max_length=100, samples_per_volume=1,
# WeightedSampler(96, "patch_probability")), batches of 4 patches of 96^3,
# make_train_step on the rematerialized network with SGD(lr=0.001,
# momentum=0.95) and HybridLogisticDiceLoss(logistic_class_weights=[1, 100]).
MS_TRAIN_BATCH = MS_TRAIN_SUBJECTS = 4
# the 15 classes' timings at N=4 in three kinds and two types took about a
# minute at TIMING's depth; this depth makes room for the qsm-dwi phase
MS_TRAIN_TIMING = (dict(trials=3, calls=3), dict(trials=2, calls=1, warmup=1))
MS_CLASS_WEIGHTS = [1, 100]
# remat runs the forward of every conv again in the backward but out_conv's
# (the one conv outside the blocks, the only one with MS_OUT_CHANNELS
# outputs); dX runs for every conv but the two that read the network's
# MS_IN_CHANNELS input channels.
MS_FWD_PER_STEP = 2 * MS_CONVS_PER_FORWARD - 1
MS_DX_PER_STEP = MS_CONVS_PER_FORWARD - 2
# The card against the port on the CPU: one patch of 64^3 (N=1), since a
# step on four 96^3 patches takes minutes on the CPU.
MS_CPU_PATCH = 64


def ms_optimizer():
    return SGD(lr=0.001, momentum=0.95)


def write_msseg2_dataset(root, seed):
    """MS_TRAIN_SUBJECTS + 1 raw subjects of MS_RAW_GRID in msseg2's layout
    (one folder each: both FLAIRs, the brain mask and the lesion ground
    truth), from msseg2_volumes; RandomFoldFilter(5 folds, seed 0xDEADBEEF)
    puts one of the five in the validation fold."""
    rng = np.random.default_rng(seed)
    for i in range(MS_TRAIN_SUBJECTS + 1):
        volumes, affine = msseg2_volumes(rng, MS_RAW_GRID, MS_RAW_SPACING, MS_SEMI_AXES_MM)
        folder = os.path.join(root, f"ms-{i:02d}")
        os.makedirs(folder)
        for name in (*MS_TIMEPOINTS, "brain_mask", "ground_truth"):
            write_nifti(os.path.join(folder, f"{name}.nii.gz"), volumes[name], affine)


def ms_training_set(root):
    """The msseg2 configuration's SubjectFolder over ``root``, restricted to
    its training cohort (the ``training`` pipeline on item access)."""
    context = msseg2_config.get_context(variables={"DATASET_PATH": root})
    context.keep_components(("dataset",))
    context.init_components()
    return context.dataset.get_cohort_dataset("training")


def ms_train_batches(card, seed, root):
    """The training cohort of the dataset under ``root`` through the
    ``training`` pipeline and the patch queue: one batch on the main path
    (pipeline and queue timed together, on the trainers' TRAINER_WORKERS
    threads), stacked and uploaded as the trainer does it
    (trainer.stack_batch, trainer.upload_batch). Returns the host batches
    (X channel-first, y class ids, and the class count) and the device
    batches."""
    seed_all(seed)
    factory = PatchDataLoader(max_length=100, samples_per_volume=1,
                              sampler=WeightedSampler(patch_size=MS_PATCH,
                                                      probability_map="patch_probability"))
    dataset = ms_training_set(root)
    assert len(dataset) == MS_TRAIN_SUBJECTS, len(dataset)
    t0 = time.perf_counter()
    batches = list(factory.get_data_loader(dataset, MS_TRAIN_BATCH,
                                           num_workers=TRAINER_WORKERS))
    first_ms = (time.perf_counter() - t0) * 1e3
    assert [len(b) for b in batches] == [MS_TRAIN_BATCH], [len(b) for b in batches]
    host = [trainer_module.stack_batch(b) for b in batches]
    for b, n_classes in host:
        assert n_classes == 2 and b["y"].dtype == np.uint8, n_classes
        assert tuple(b["X"].shape) == (MS_TRAIN_BATCH, 2, *(MS_PATCH,) * 3), b["X"].shape
        assert b["y"].shape == (MS_TRAIN_BATCH, *(MS_PATCH,) * 3)
        assert torch.isfinite(b["X"]).all().item()
    lesion = [float((b["y"] == 1).mean()) for b, _ in host]
    print(f"msseg2 train data: {MS_TRAIN_SUBJECTS} raw training subjects of "
          f"{'x'.join(map(str, MS_RAW_GRID))} at {MS_RAW_SPACING} mm with ground truth read "
          f"by the configuration's SubjectFolder; the batch (training pipeline + "
          f"PatchDataLoader, 4 subjects, {TRAINER_WORKERS} threads) {first_ms:.1f} ms; "
          f"lesion share of its patches "
          + ", ".join(f"{v:.5f}" for v in lesion) + f" [{card}]", flush=True)
    return host, [trainer_module.upload_batch(b, n, "cuda") for b, n in host]


def channel_first_one_hot(batch_cf, n_classes):
    """A stack_batch host batch as float32 channel-first X and one-hot y."""
    y = np.moveaxis(np.eye(n_classes, dtype=np.float32)[batch_cf["y"]], -1, 1)
    return {"X": batch_cf["X"].float().numpy(), "y": y}


def ms_expected_train_launches(dtype, steps):
    """Forward (with remat's recompute), dX and dW launches by shape over
    ``steps`` msseg2 train steps at the training batch."""
    out = {"fwd": Counter(), "dx": Counter(), "dw": Counter()}
    for spatial, cin, cout, n in MS_CONV_CLASSES:
        key = (str(dtype), MS_TRAIN_BATCH, *spatial, cin, cout)
        out["fwd"][key] = (n if cout == MS_OUT_CHANNELS else 2 * n) * steps
        out["dw"][key] = n * steps
        if cin != MS_IN_CHANNELS:
            out["dx"][(str(dtype), MS_TRAIN_BATCH, *spatial, cout, cin)] = n * steps
    return out


def ms_train_phase(card, seed, rows, root):
    """msseg2 training on the card: raw subjects through the training
    pipeline and the patch queue, then 2 warm-up and TRAIN_STEPS timed steps
    in f32 and in bf16 on the full-width rematerialized network (launches
    per step by class asserted), one profiled step per dtype, the remat
    check and the card against the CPU. Fills the launches per step of the
    N=4 rows. Every step takes the one batch: the step does not wait on the
    host's pipeline, which is timed apart."""
    host, batches = ms_train_batches(card, seed, root)
    stacked = [channel_first_one_hot(b, n) for b, n in host]
    module = msseg2_network()
    state_dict = msseg2_state(np.random.default_rng(seed + 12), module)
    model = SegModel(module, device="cuda")
    model.load_state_dict(state_dict)
    criterion = HybridLogisticDiceLoss(logistic_class_weights=MS_CLASS_WEIGHTS)
    optimizer = ms_optimizer()
    state = create_train_state(model, optimizer, stacked[0])
    per_step, steps = {}, {}
    for dtype, name in DTYPE_NAMES.items():
        step = make_train_step(module, criterion, optimizer,
                               compute_dtype=None if dtype == torch.float32 else "bfloat16")
        steps[dtype] = step
        for i in range(WARMUP_STEPS):
            state, _, _ = step(state, batches[i % len(batches)], None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times, losses = [], []
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, loss_dict, y_pred = step(state, batches[i % len(batches)], None)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss_dict["loss"])
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [loss.item() for loss in losses]
        assert all(np.isfinite(losses)), losses
        assert tuple(y_pred.shape) == (MS_TRAIN_BATCH, *(MS_PATCH,) * 3, 2)
        assert torch.isfinite(y_pred).all().item()
        assert [c.total() for c in counts.values()] == \
            [n * TRAIN_STEPS for n in (MS_FWD_PER_STEP, MS_DX_PER_STEP, MS_CONVS_PER_FORWARD)], \
            counts
        assert counts == ms_expected_train_launches(dtype, TRAIN_STEPS), counts
        per_step[str(dtype)] = counts
        med = statistics.median(times)
        print(f"msseg2 train {name} steps: " + ", ".join(f"{t:.3f}" for t in times) + " ms",
              flush=True)
        print(f"msseg2 train {name}: median {med:.3f} ms per step, "
              f"{MS_TRAIN_BATCH / med * 1e3:.3f} patches/s, max_memory_allocated {peak} bytes; "
              "losses " + ", ".join(f"{v:.6f}" for v in losses)
              + f"; launches per step forward {counts['fwd'].total() // TRAIN_STEPS} "
              f"({MS_CONVS_PER_FORWARD} + {MS_CONVS_PER_FORWARD - 1} recomputed), dX "
              f"{counts['dx'].total() // TRAIN_STEPS}, dW {counts['dw'].total() // TRAIN_STEPS}; "
              "by class (forward/dX/dW per step): " + ", ".join(
                  f"{'x'.join(map(str, spatial))} {cin}->{cout} "
                  f"{counts['fwd'][key] // TRAIN_STEPS}/"
                  f"{counts['dx'][(*key[:5], cout, cin)] // TRAIN_STEPS}/"
                  f"{counts['dw'][key] // TRAIN_STEPS}"
                  for spatial, cin, cout, _ in MS_CONV_CLASSES
                  for key in [(str(dtype), MS_TRAIN_BATCH, *spatial, cin, cout)])
              + f" [{card}]", flush=True)

    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    assert all(int(m.num_batches_tracked) == 2 * (WARMUP_STEPS + TRAIN_STEPS) for m in norms)
    moved = [k for k, v in state.batch_stats.items() if not torch.equal(v.cpu(), state_dict[k])]
    assert len(moved) == len(state.batch_stats), "running statistics that did not move"
    conv_weights = [m.weight for m in module.modules() if isinstance(m, Conv3d)]
    assert len(conv_weights) == MS_CONVS_PER_FORWARD
    assert all(w.grad is not None and torch.isfinite(w.grad).all().item()
               and w.grad.abs().max().item() > 0 for w in conv_weights)
    print(f"msseg2 train: {len(moved)} running statistics moved, each BatchNorm counted "
          f"{2 * (WARMUP_STEPS + TRAIN_STEPS)} steps (once a step under remat); all "
          f"{len(conv_weights)} conv weights have finite, nonzero gradients", flush=True)
    shares = {name: profile_train_step(steps[dtype], state, batches[0], None, f"msseg2 {name}",
                                       card)
              for dtype, name in DTYPE_NAMES.items()}
    if all(shares.values()):
        print("profile msseg2 train step, kernels' share of device time: " + ", ".join(
            f"{name} forward + dX {conv:.3f} of {busy:.3f} ms ({conv / busy:.4f}), "
            f"dW {dw:.3f} ({dw / busy:.4f})"
            for name, (conv, dw, busy) in shares.items()) + f" [{card}]", flush=True)
    del model, module, state, steps, y_pred
    torch.cuda.empty_cache()

    for row in rows:
        count = per_step[row["_key"][0]][row["_kind"]][row["_key"]]
        assert count % TRAIN_STEPS == 0 and count > 0, (row["name"], count)
        row["launches"] = count // TRAIN_STEPS
    ms_remat_check(card, state_dict, stacked[0], batches[0], criterion)
    one = {k: np.ascontiguousarray(v[:1, :, :MS_CPU_PATCH, :MS_CPU_PATCH, :MS_CPU_PATCH])
           for k, v in stacked[0].items()}
    cpu_train_comparison(card, f"msseg2 train f32 vs CPU port (first patch cut to "
                         f"{MS_CPU_PATCH}^3)", msseg2_network, ms_optimizer, criterion,
                         state_dict, one)


def ms_remat_check(card, state_dict, batch_cf, batch, criterion):
    """One f32 step from the same weights and batch with remat and without,
    with cuDNN held to its deterministic algorithms: the loss equal, every
    gradient within 1e-6 of its max|g|, the running statistics equal and
    moved once; both peak memories."""
    previous = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for remat in (True, False):
            model = SegModel(msseg2_network(remat=remat), device="cuda")
            model.load_state_dict(state_dict)
            optimizer = ms_optimizer()
            state = create_train_state(model, optimizer, batch_cf)
            step = make_train_step(model.module, criterion, optimizer)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, loss_dict, _ = step(state, batch, None)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            out[remat] = (loss_dict["loss"].item(), torch.cuda.max_memory_allocated(), ms,
                          {k: p.grad.detach().clone() for k, p in state.params.items()},
                          {k: v.clone() for k, v in model.module.state_dict().items()
                           if "running" in k or k.endswith("num_batches_tracked")})
            del model, state, step, optimizer
    finally:
        torch.backends.cudnn.deterministic = previous
    (loss_r, peak_r, ms_r, grads_r, stats_r), (loss_p, peak_p, ms_p, grads_p, stats_p) = \
        out[True], out[False]
    worst = max(((grads_r[k] - g).abs().max().item() / g.abs().max().item(), k)
                for k, g in grads_p.items())
    same_bits = all(torch.equal(grads_r[k], g) for k, g in grads_p.items())
    moved_once = all(int(v) == 1 for k, v in stats_r.items() if k.endswith("num_batches_tracked"))
    stats_equal = all(torch.equal(stats_r[k], v) for k, v in stats_p.items())
    print(f"msseg2 train f32 remat check (cuDNN deterministic): loss {loss_r:.7f} with remat, "
          f"{loss_p:.7f} without; worst gradient max abs diff / max|grad| {worst[0]:.3g} at "
          f"{worst[1]} over {len(grads_p)} parameters (bitwise equal: {same_bits}); running "
          f"statistics equal {stats_equal}, moved once {moved_once}; max_memory_allocated "
          f"{peak_r} bytes with remat, {peak_p} without; step {ms_r:.3f} ms with remat, "
          f"{ms_p:.3f} without [{card}]", flush=True)
    assert loss_r == loss_p and worst[0] <= 1e-6 and stats_equal and moved_once


# The trainer phase: the sustained training loop as research/dmri_hippo/run.py
# and research/msseg2/run.py drive it (tpu_fast_path=False): a subject folder
# on disk, the configuration's get_context, init_components and
# SegmentationTrainer.train with a FileLogger.
HIPPO_SUBJECTS = {"validation": 4, "training": 8, "ab300": 4}
# the fast path's f32 run reaches the schedule's interval of 50 (a second
# validation sweep, score and checkpoint); the host-loader runs and the
# fast bf16 run, host-bound or a repeat of it, stop after the evaluators of
# interval 10 have run once more
TRAINER_ITERATIONS, SHORT_TRAINER_ITERATIONS = 51, 11
VALIDATION_BATCH = 16
TRAINER_WORKERS = 4
# the process workers' run; thread counts other than TRAINER_WORKERS, which
# the runs above read, are left out to keep the script's time
WORKER_ITERATIONS = 8
PROFILE_WARMUP_ITERATIONS = 3
PROFILED_ITERATIONS = 5
# host-bound (seconds an iteration): 2 iterations, cut from 6 for later phases
MS_TRAINER_ITERATIONS = 2
# the fast-path phase: msseg2's iterations and the batch of the
# augmentation checks (the trainers' batch)
MS_FAST_ITERATIONS, MS_FAST_PROFILE_START = 21, 1
AUG_BATCH = 4
# dmri_hippo's schedule (main_config.py build_evaluation_schedule): the
# evaluators each iteration runs, by interval.
HIPPO_SCHEDULE = {"training_segmentation_eval": 10, "contour_image_training": 50,
                  "predicted_label_eval": 50, "segmentation_eval": 50,
                  "contour_image_axial": 250, "contour_image_coronal": 250}


def write_hippo_dataset(root, seed):
    """dmri_hippo's layout under ``root``: subjects/<name>/{mean_dwi, md, fa,
    whole_roi}.nii.gz and attributes.json (protocol, age; fold for cbbrain),
    atlas/whole_roi_union.nii.gz, and attributes/{cross_validation_split,
    ab300_validation_subjects, cbbrain_test_subjects}.json. Subjects on the
    ORIGINAL_GRID scanner grid from hippo_volumes: cbbrain subjects in fold
    0 (cbbrain_validation) and in folds 1-4 (training), and ab300 subjects
    (ab300_validation) with ages."""
    rng = np.random.default_rng(seed)
    n_cbbrain = HIPPO_SUBJECTS["validation"] + HIPPO_SUBJECTS["training"]
    split, ab300 = {}, {}
    for i in range(n_cbbrain + HIPPO_SUBJECTS["ab300"]):
        cbbrain = i < n_cbbrain
        name = f"cbbrain_{i:03d}" if cbbrain else f"ab300_{i:03d}"
        folder = os.path.join(root, "subjects", name)
        os.makedirs(folder)
        volumes, affine = hippo_volumes(rng, ORIGINAL_GRID)
        for key in (*INPUT_IMAGES, "whole_roi"):
            write_nifti(os.path.join(folder, f"{key}.nii.gz"), volumes[key], affine)
        if i == 0:
            os.makedirs(os.path.join(root, "atlas"))
            write_nifti(os.path.join(root, "atlas", "whole_roi_union.nii.gz"),
                        volumes["whole_roi_union"], affine)
        attributes = {"protocol": "cbbrain" if cbbrain else "ab300", "age": 20.0 + 2.5 * i}
        if cbbrain:
            attributes["fold"] = 0 if i < HIPPO_SUBJECTS["validation"] else 1 + i % 4
            split[name] = {"fold": attributes["fold"]}
        else:
            ab300[name] = {"ab300_validation": True}
        with open(os.path.join(folder, "attributes.json"), "w") as f:
            json.dump(attributes, f)
    os.makedirs(os.path.join(root, "attributes"))
    for file_name, data in (("cross_validation_split", split),
                            ("ab300_validation_subjects", ab300),
                            ("cbbrain_test_subjects", {})):
        with open(os.path.join(root, "attributes", f"{file_name}.json"), "w") as f:
            json.dump(data, f)


# the cascade's first-stage predictions (phase 15), made from the targets
PRIOR_FLIP = 0.05


def write_priors(root, predictions, seed, flip=PRIOR_FLIP):
    """A cascade prior for every subject of the dmri_hippo dataset at
    ``root``: ``<predictions>/subjects/<name>/standard.nii.gz``, the
    subject's whole_roi with a share ``flip`` of its voxels, drawn from
    ``seed``, flipped between background and their hemisphere's label (2 in
    the lower half of W, the right hemisphere, 1 in the upper; none within
    a voxel of the midline), so that the prior is not the target and labels
    each hemisphere as a first-stage prediction does."""
    rng = np.random.default_rng(seed)
    subjects = os.path.join(root, "subjects")
    for name in sorted(os.listdir(subjects)):
        path = os.path.join(subjects, name, "whole_roi.nii.gz")
        if not os.path.exists(path):
            continue
        data, affine = read_nifti(path)
        data = np.asarray(data).astype(np.int32)
        W = data.shape[1]
        w = np.arange(W)[None, :, None, None]
        side = np.broadcast_to(np.where(w < W // 2, 2, 1), data.shape)
        flipped = (rng.random(data.shape) < flip) & (np.abs(w - W // 2 + 0.5) > 1.5)
        data[flipped] = np.where(data[flipped] > 0, 0, side[flipped])
        folder = os.path.join(predictions, "subjects", name)
        os.makedirs(folder, exist_ok=True)
        write_nifti(os.path.join(folder, "standard.nii.gz"), data, affine)


# dmri_hippo's full DWI series for the augmentation ablation's DWI modes:
# 6 volumes at b=0, 30 at b=500 (the shell ReconstructMeanDWI averages) and
# 60 at b=1000 s/mm^2
DWI_BVALS = (0.0,) * 6 + (500.0,) * 30 + (1000.0,) * 60


def write_full_dwi(root, seed, bvals=DWI_BVALS):
    """Each subject's full DWI series beside its images, on its mean_dwi
    grid: subjects/<name>/full_dwi.nii (uncompressed, (volumes, W, H, D))
    and full_dwi_grad.b (one "x y z b" line per volume, unit directions, 0 0
    0 at b=0): the files the augmentation config's loaders read. Returns
    the bytes of one series."""
    rng = np.random.default_rng(seed)
    bvals = np.asarray(bvals, np.float64)
    nbytes = 0
    for folder in sorted(os.listdir(os.path.join(root, "subjects"))):
        folder = os.path.join(root, "subjects", folder)
        mean_dwi, affine = read_nifti(os.path.join(folder, "mean_dwi.nii.gz"))
        signal = np.nan_to_num(mean_dwi, nan=1.0)
        series = (signal * np.exp(-bvals / 1000.0)[:, None, None, None]
                  * rng.uniform(0.7, 1.3, (len(bvals), *signal.shape[1:]))).astype(np.float32)
        write_nifti(os.path.join(folder, "full_dwi.nii"), series, affine)
        bvecs = rng.normal(size=(len(bvals), 3))
        bvecs /= np.linalg.norm(bvecs, axis=1, keepdims=True)
        bvecs[bvals == 0] = 0.0
        np.savetxt(os.path.join(folder, "full_dwi_grad.b"),
                   np.concatenate([bvecs, bvals[:, None]], axis=1), fmt="%.6f")
        nbytes = series.nbytes
    return nbytes


def missing_render_packages():
    """The import error of matplotlib or PIL, which ContourImageEvaluator
    renders with, or None when both import."""
    try:
        import matplotlib  # noqa: F401
        import PIL  # noqa: F401
    except ImportError as error:
        return error
    return None


def without_contour_images(context):
    """Drop the ContourImageEvaluator schedules from the context's trainer."""
    params = context.get_component_definition("trainer")["params"]
    keep = lambda scheduled: [s for s in scheduled  # noqa: E731
                              if not isinstance(s.evaluator, tsp.ContourImageEvaluator)]
    context.update_component("trainer", training_evaluators=keep(params["training_evaluators"]),
                             validation_evaluators=keep(params["validation_evaluators"]))


@contextlib.contextmanager
def uncounted():
    """Leave the kernels' launch counts as they were: for launches that
    check the main path rather than belong to it."""
    wrappers = (conv3x3_s1p1, conv3x3_s1p1_dx, conv3x3_s1p1_dw)
    saved = [(w.launches, Counter(w.launches_by_shape)) for w in wrappers]
    try:
        yield
    finally:
        for w, (n, by_shape) in zip(wrappers, saved):
            w.launches = n
            w.launches_by_shape.clear()
            w.launches_by_shape.update(by_shape)


class ProbeLogger(tsp.FileLogger):
    """A FileLogger that times the synchronous part of each checkpoint save
    (the host snapshot and the hand-off to the writer thread) and records,
    uncounted, the model's answer on one probe batch at each save: what the
    checkpoint must give back when it is reloaded."""

    def __init__(self, logs_dir, probe):
        super().__init__(logs_dir)
        self.probe, self.answers, self.save_ms = probe, {}, []

    def save_context(self, context, folder, iteration):
        t0 = time.perf_counter()
        path = super().save_context(context, folder, iteration)
        self.save_ms.append((time.perf_counter() - t0) * 1e3)
        with uncounted():
            self.answers[path] = (context.model(self.probe), context.model.compute_dtype)
        return path


class MemoryLogger(tsp.NonLogger):
    """Keeps the records in memory; saves nothing."""

    def __init__(self):
        self.records = []

    def log(self, log_dict):
        self.records.append(log_dict)


class Profiling:
    """Traces the trainer's steady state between two of its log calls:
    torch.profiler starts at the log of iteration ``start``, warms up until
    that of ``start + warmup`` and records until that of ``start + warmup +
    span``. The trainer logs a plain iteration at the same point of the next
    one, so the recorded window is ``span`` whole iterations, with none of
    train()'s set-up. No synchronize bounds it: the loop is periodic. Mixed
    into a logger."""

    def profile(self, start, warmup=PROFILE_WARMUP_ITERATIONS, span=PROFILED_ITERATIONS):
        self.start, self.stop = start, start + warmup + span
        self.marks = {start: "start", start + warmup: "record", self.stop: "stop"}
        self.averages, self.prof, self.t0, self.wall_ms = [], None, None, None
        return self

    def log(self, log_dict):
        super().log(log_dict)
        mark = self.marks.get(log_dict["iteration"])
        if mark == "start":
            self.prof = warm_profiler(self.averages)
            self.prof.start()
        elif mark == "record":
            self.prof.step()
            self.t0 = time.perf_counter()
        elif mark == "stop":
            self.wall_ms = (time.perf_counter() - self.t0) * 1e3
            self.prof.step()
            self.prof.stop()


class ProfilingLogger(Profiling, MemoryLogger):
    pass


class ProfilingFileLogger(Profiling, tsp.FileLogger):
    pass


def profile_text(logger, workers=TRAINER_WORKERS):
    """The device busy time and idle share of a Profiling logger's window."""
    assert logger.wall_ms is not None
    events = device_events(logger.averages)
    if not events:
        return "no device time traced; idle share not measured"
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    recorded = range(logger.stop - PROFILED_ITERATIONS + 1, logger.stop + 1)
    return (f"profile over {PROFILED_ITERATIONS} plain iterations in steady state (iterations "
            f"{recorded.start}-{recorded.stop - 1}, num_workers={workers}): wall "
            f"{logger.wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
            f"{1 - busy_ms / logger.wall_ms:.4f}")


def timer_totals(records):
    """Seconds per timer entry summed over a run's records, largest first:
    where the whole call's time beyond the plain iterations went."""
    totals = Counter()
    for r in records:
        for key, value in r["timer"].items():
            totals[key.split(".")[0]] += value
    return ", ".join(f"{k} {v:.3f}" for k, v in totals.most_common())


def read_records(logger):
    with open(logger.run_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def plain_iterations(records, first):
    """The timer splits of the iterations that ran no evaluator, score or
    save (the first of a run excluded: it fetches its batch unprefetched)."""
    return [r["timer"] for r in records if r["iteration"] != first
            and set(r["timer"]) == {"data_loading", "next_batch_prefetch", "train_step"}]


def split_text(timers, iterations, wall_s):
    """Iterations per second over the plain iterations ``timers`` (with the
    median of each split) and over the whole train() call: ``iterations``
    in ``wall_s`` seconds, evaluators, saves and set-up included."""
    totals = [sum(t.values()) for t in timers]
    medians = {k: statistics.median(t[k] for t in timers) * 1e3
               for k in ("data_loading", "next_batch_prefetch", "train_step")}
    return (len(totals) / sum(totals),
            f"{len(totals) / sum(totals):.3f} iterations/s over {len(totals)} plain iterations "
            f"(median {statistics.median(totals) * 1e3:.1f} ms; median split " + ", ".join(
                f"{k} {v:.1f}" for k, v in medians.items()) + " ms); "
            f"{iterations / wall_s:.3f} iterations/s over the train() call ({iterations} "
            f"iterations in {wall_s:.3f} s, set-up, evaluators and saves included)")


def check_reloads(logger, root):
    """Each checkpoint, loaded by file path into a fresh Context, answers the
    probe as the model did when it was saved, bit for bit."""
    for path, (answer, compute_dtype) in logger.answers.items():
        restored = tsp.Context(file_path=str(path), variables={"DATASET_PATH": root})
        restored.keep_components(("model",))
        restored.init_components()
        restored.model.compute_dtype = compute_dtype
        with uncounted():
            again = restored.model(logger.probe)
        assert torch.equal(again, answer), path
    return len(logger.answers)


def hippo_trainer_run(card, root, logs, dtype, drop_contours, fast_path=False,
                      iterations=SHORT_TRAINER_ITERATIONS):
    """dmri_hippo's configuration at full width trained for ``iterations``
    iterations (``fast_path``: with tpu_fast_path=True): launches,
    schedule, checkpoints and their reloads asserted; times printed.
    Returns the context."""
    name = DTYPE_NAMES[dtype]
    context = hippo_config.get_context(
        variables={"DATASET_PATH": root}, tpu_fast_path=fast_path,
        compute_dtype=None if dtype == torch.float32 else "bfloat16")
    if drop_contours:
        without_contour_images(context)
    context.init_components()
    probe = np.random.default_rng(0).normal(size=(1, IN_CHANNELS, *CROP)).astype(np.float32)
    logger = ProbeLogger(logs, probe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    context.trainer.train(context, max_iterations=iterations,
                          num_workers=TRAINER_WORKERS,
                          validation_batch_size=VALIDATION_BATCH, logger=logger)
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    # launches: every iteration's step at the training batch (8 half-volumes),
    # and one forward of 16 half-volumes per validation sweep (iterations 0, 50)
    swept = list(range(0, iterations, 50))
    sweeps = len(swept)
    expected = expected_train_launches(dtype, iterations, 2 * SUBJECTS_PER_REQUEST)
    expected["fwd"] = expected["fwd"] + expected_launches(dtype, sweeps, VALIDATION_BATCH)
    assert counts == expected, counts
    per_iteration = {kind: sum(n for key, n in c.items() if key[1] == 2 * SUBJECTS_PER_REQUEST)
                     // iterations for kind, c in counts.items()}
    per_sweep = sum(n for key, n in counts["fwd"].items() if key[1] == VALIDATION_BATCH) // sweeps
    assert per_iteration == {"fwd": CONVS_PER_FORWARD, "dx": DX_PER_STEP,
                             "dw": CONVS_PER_FORWARD} and per_sweep == CONVS_PER_FORWARD

    # the schedule: which evaluators ran where, the score, the checkpoints
    records = read_records(logger)
    assert [r["iteration"] for r in records] == list(range(iterations))
    schedule = {k: v for k, v in HIPPO_SCHEDULE.items()
                if not (drop_contours and k.startswith("contour"))}
    images = sorted(p.name for p in (logger.run_dir / "images").glob("*.png")) \
        if (logger.run_dir / "images").exists() else []
    expected_images = []
    for r in records:
        it = r["iteration"]
        ran = {k for k in schedule if it % schedule[k] == 0}
        # the training montage is a bare image: FileLogger writes it to
        # images/ and leaves it out of the record
        assert {k for k in r if k in HIPPO_SCHEDULE} == ran - {"contour_image_training"}, \
            (it, sorted(r))
        assert ("model_score" in r) == (it % 50 == 0), it
        for k in ran:
            if k == "contour_image_training":
                expected_images.append(f"{k}-iter{it:08}.png")
            elif k.startswith("contour"):
                expected_images += [f"{k}.{c}-iter{it:08}.png"
                                    for c in ("cbbrain_validation", "ab300_validation_plot")]
    assert images == sorted(expected_images), images
    scores = {r["iteration"]: r["model_score"] for r in records if "model_score" in r}
    assert list(scores) == swept and all(np.isfinite(list(scores.values())))
    assert all(np.isfinite(r["loss"]) for r in records)
    checkpoints = sorted(p.name for p in (logger.run_dir / "checkpoints").iterdir())
    assert checkpoints == [f"dmri-hippo-iter{i:08}.ckpt" for i in (0, iterations)]
    best = sorted(p.name for p in (logger.run_dir / "best_checkpoints").iterdir())
    assert best[0] == "dmri-hippo-iter00000000.ckpt", best
    reloaded = check_reloads(logger, root)

    rate, text = split_text(plain_iterations(records, 0), iterations, wall_s)
    sweep_ms = [r["timer"]["model_forward_evaluation"] * 1e3 for r in records
                if "model_forward_evaluation" in r["timer"]]
    label = f"trainer dmri_hippo {name} with num_workers={TRAINER_WORKERS}"
    if fast_path:
        label = f"fast-path dmri_hippo {name}: {fast_path_text(context.trainer)}"
        text += f"; seconds by timer entry over the run: {timer_totals(records)}"
    print(f"{label}: {text}; launches "
          f"per iteration forward {per_iteration['fwd']}, dX {per_iteration['dx']}, dW "
          f"{per_iteration['dw']}, forward {per_sweep} per validation batch of "
          f"{VALIDATION_BATCH} half-volumes; validation sweep (8 subjects) "
          + ", ".join(f"{t:.1f}" for t in sweep_ms) + f" ms (iterations {swept}); synchronous "
          "part of a checkpoint save " + ", ".join(f"{t:.1f}" for t in logger.save_ms)
          + f" ms; max_memory_allocated {peak} bytes; losses {records[0]['loss']:.6f} -> "
          f"{records[-1]['loss']:.6f}; model_score " + ", ".join(
              f"{v:.6f} (it {it})" for it, v in scores.items())
          + f"; checkpoints {checkpoints}, best {best}; {reloaded} "
          f"reloaded checkpoints answer bit for bit as saved; {len(images)} contour images "
          f"[{card}]", flush=True)
    return context, rate


def process_worker_run(card, context):
    """Iterations per second of the f32 trainer with TRAINER_WORKERS process
    workers (the training loader's use_processes), over the iterations with
    no evaluator (beside the timer's median split) and over the whole
    train() call; the first run of the phase reads as many threads."""
    factory = context.trainer.train_dataloader_factory
    logger = MemoryLogger()
    first = context.trainer.iteration
    factory.use_processes = True
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        context.trainer.train(context, max_iterations=WORKER_ITERATIONS,
                              num_workers=TRAINER_WORKERS,
                              validation_batch_size=VALIDATION_BATCH, logger=logger)
    finally:
        factory.close_pools()
        factory.use_processes = False
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    assert counts["dw"].total() == CONVS_PER_FORWARD * WORKER_ITERATIONS, counts["dw"]
    _, text = split_text(plain_iterations(logger.records, first), WORKER_ITERATIONS, wall_s)
    print(f"trainer dmri_hippo f32 num_workers={TRAINER_WORKERS} processes: {text} [{card}]",
          flush=True)


def profile_trainer(card, context, label="trainer dmri_hippo f32"):
    """PROFILED_ITERATIONS plain dmri_hippo iterations in the trainer's
    steady state under torch.profiler, after PROFILE_WARMUP_ITERATIONS as
    its warm-up: device busy time and idle share. The window lies between
    two iterations that run evaluators (multiples of 10)."""
    first = context.trainer.iteration
    start = first + (1 - first) % 10
    if start - first < 2:  # the first iteration fetches its batch unprefetched
        start += 10
    logger = ProfilingLogger().profile(start)
    assert logger.stop < start - 1 + 10
    with uncounted():
        # the plain iteration ``stop`` is logged during the next one
        context.trainer.train(context, max_iterations=logger.stop + 2 - first,
                              num_workers=TRAINER_WORKERS, logger=logger)
    print(f"{label} {profile_text(logger)} [{card}]", flush=True)


def ms_trainer_run(card, root, logs, drop_contours, fast_path=False,
                   iterations=MS_TRAINER_ITERATIONS):
    """msseg2's configuration at full width (``fast_path``: with
    tpu_fast_path=True) trained for ``iterations`` iterations in f32: the
    step's launches (67 forward with remat's recompute, 32 dX, 34 dW) and
    34 forward per validation patch batch. Returns the context."""
    context = msseg2_config.get_context(variables={"DATASET_PATH": root},
                                        tpu_fast_path=fast_path)
    if drop_contours:
        without_contour_images(context)
    context.init_components()
    # the fast path's profile window lies in this run, between the
    # training evaluators of iterations 0 and 15 (a second train() call
    # would pretransform the training set again)
    logger = (ProfilingFileLogger(logs).profile(MS_FAST_PROFILE_START) if fast_path
              else tsp.FileLogger(logs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    context.trainer.train(context, max_iterations=iterations,
                          num_workers=TRAINER_WORKERS, validation_batch_size=1, logger=logger)
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step = ms_expected_train_launches(torch.float32, iterations)
    assert counts["dx"] == step["dx"] and counts["dw"] == step["dw"], counts
    # the validation sweep's forwards: the 15 classes at the patch batch, each
    # as often as one forward has it times the number of patch batches
    validation = counts["fwd"] - step["fwd"]
    training = counts["fwd"] - validation
    assert training == step["fwd"], counts["fwd"]
    per_forward = {(*spatial, cin, cout): m for spatial, cin, cout, m in MS_CONV_CLASSES}
    val_batches = {n / per_forward[key[2:]] for key, n in validation.items()}
    assert len(val_batches) == 1 and validation.total() == \
        MS_CONVS_PER_FORWARD * next(iter(val_batches)) > 0, validation
    val_batches = int(next(iter(val_batches)))
    records = read_records(logger)
    assert [r["iteration"] for r in records] == list(range(iterations))
    assert {"training_segmentation_eval", "training_label_eval", "segmentation_eval",
            "model_score"} <= set(records[0]) and np.isfinite(records[0]["model_score"])
    assert all(np.isfinite(r["loss"]) for r in records)
    profiled_window = range(logger.start, logger.stop + 2) if fast_path else range(0)
    timers = plain_iterations([r for r in records if r["iteration"] not in profiled_window], 0)
    rate, text = split_text(timers, iterations, wall_s)
    per_iteration = {kind: divmod(c.total(), iterations) for kind, c in
                     (("fwd", training), ("dx", counts["dx"]), ("dw", counts["dw"]))}
    assert all(rest == 0 for _, rest in per_iteration.values()), per_iteration
    loading = sum(t["data_loading"] + t["next_batch_prefetch"] for t in timers) / \
        sum(sum(t.values()) for t in timers)
    label = f"trainer msseg2 f32 with num_workers={TRAINER_WORKERS}"
    if fast_path:
        label = f"fast-path msseg2 f32: {fast_path_text(context.trainer)}"
        text += (f" (iterations {profiled_window.start}-{profiled_window.stop - 1} left out: "
                 f"{profile_text(logger)}); seconds by timer entry over the run: "
                 f"{timer_totals(records)}")
    print(f"{label}: {text}; host data "
          f"(data_loading + next_batch_prefetch) share {loading:.4f}; launches per iteration "
          f"forward {per_iteration['fwd'][0]}, dX {per_iteration['dx'][0]}, dW "
          f"{per_iteration['dw'][0]}, forward {MS_CONVS_PER_FORWARD} per validation patch "
          f"batch ({val_batches} batch(es)); validation sweep "
          f"{records[0]['timer']['model_forward_evaluation'] * 1e3:.1f} ms; model_score "
          f"{records[0]['model_score']:.6f}; max_memory_allocated {peak} bytes [{card}]",
          flush=True)
    return context


def reader_check(card, root, ms_root, rounds=1, count=2):
    """SubjectFolder's load ms per subject of the configurations' datasets
    (dmri_hippo under ``root``, msseg2 under ``ms_root``; the first
    ``count`` of each) through the native NIfTI reader (read_nifti's
    path) and through the numpy codec alone (the reader made to refuse
    every file), in turns (codec, reader, reader, codec) per round; every
    array and affine equal."""
    parts = []
    for label, config, folder in (("dmri_hippo", hippo_config, root),
                                  ("msseg2", msseg2_config, ms_root)):
        context = config.get_context(variables={"DATASET_PATH": folder})
        context.keep_components(("dataset",))
        context.init_components()
        dataset = context.dataset
        times, loaded = {"reader": [], "codec": []}, {}
        for path in (("codec", "reader", "reader", "codec") * rounds):
            subjects = [copy.deepcopy(s) for s in dataset.all_subjects[:count]]
            with contextlib.ExitStack() as stack:
                if path == "codec":
                    stack.enter_context(patched(native, "nifti_read_raw_native",
                                                lambda _: None))
                t0 = time.perf_counter()
                for s in subjects:
                    s.load()
                times[path].append((time.perf_counter() - t0) * 1e3 / len(subjects))
            loaded[path] = subjects
        for a, b in zip(loaded["reader"], loaded["codec"]):
            for key, image in a.get_images_dict(intensity_only=False).items():
                assert np.array_equal(image.data, b[key].data, equal_nan=True), \
                    (label, a["name"], key)
                assert np.array_equal(image.affine, b[key].affine), (label, a["name"], key)
        med = {k: statistics.median(v) for k, v in times.items()}
        parts.append(f"{label} ({len(subjects)} subjects) reader {med['reader']:.2f}, codec "
                     f"{med['codec']:.2f} ms per subject")
    print("nifti reader: SubjectFolder load, medians of " + str(2 * rounds) + " each: "
          + "; ".join(parts) + f"; arrays and affines equal [{card}]", flush=True)


def trainer_phase(card, root, ms_root, tmp, drop_contours):
    """The sustained training loop on the card: dmri_hippo in f32 and bf16
    over the dataset under ``root``, the f32 trainer with process workers
    and its profile, then msseg2 in f32 over the dataset under
    ``ms_root``; first, the NIfTI reader against the codec on both."""
    reader_check(card, root, ms_root)
    contexts = {}
    for dtype in (torch.float32, torch.bfloat16):
        contexts[dtype], _ = hippo_trainer_run(
            card, root, os.path.join(tmp, f"logs-{DTYPE_NAMES[dtype]}"), dtype, drop_contours)
    del contexts[torch.bfloat16]
    torch.cuda.empty_cache()
    process_worker_run(card, contexts[torch.float32])
    profile_trainer(card, contexts[torch.float32])
    del contexts
    torch.cuda.empty_cache()
    ms_trainer_run(card, ms_root, os.path.join(tmp, "logs-msseg2"), drop_contours)


# The fast-path phase: the configurations' tpu_fast_path=True (the device
# cache and the device augmentation derived from the declared pipeline).

def fast_path_text(trainer, augmented=True):
    """The device cache's size and set-up times of the last train() call
    (``augmented``: asserting that a device augmentation was derived)."""
    phases = trainer.startup_phases
    assert trainer._cache is not None
    assert (trainer.resolved_device_augmentation is not None) == augmented
    return (f"device cache {trainer._cache.nbytes} bytes ({trainer._cache.n_subjects} "
            f"subjects), host pretransform {phases['pretransform_s']} s, cache build "
            f"{phases['cache_build_s']} s")


def augment_checks(card, seed):
    """ops/augment.py on the card against the port on the CPU at the same
    draws (made on the CPU, then moved), at the trainers' batch of
    dmri_hippo (4 x 96x88x24 x 3) and msseg2 (4 x 96^3 x 2) with uint8
    label ids: the reference configurations in f32 and bf16, timed
    (augment_batch, draws included), and every gate on in f32. X within
    1e-5 of max|CPU| in f32 (one bf16 step in bf16), labels bit for bit."""
    from segmentation_pipeline_torch.ops import augment

    rng = np.random.default_rng(seed + 31)
    forced = dict(flip_p=1.0, bias_p=1.0, gamma_p=1.0, noise_p=1.0, blur_p=1.0)
    cases = (("dmri_hippo", augment.DMRI_REFERENCE_CONFIG, CROP, IN_CHANNELS,
              dict(affine_p=1.0, elastic_p=1.0)),
             ("msseg2", augment.MSSEG2_REFERENCE_CONFIG, (MS_PATCH,) * 3, MS_IN_CHANNELS,
              dict(oneof_p=1.0, oneof_affine_weight=0.5)))
    for name, reference, spatial, channels, spatial_on in cases:
        X = torch.from_numpy(rng.normal(size=(AUG_BATCH, *spatial, channels)).astype(np.float32))
        ids = torch.from_numpy(rng.integers(0, 2, size=(AUG_BATCH, *spatial)).astype(np.uint8))
        for gates, cfg, dtypes in (("reference gates", reference, (torch.float32, torch.bfloat16)),
                                   ("every gate on", dict(reference, **forced, **spatial_on),
                                    (torch.float32,))):
            draws = augment.draw_augmentation(torch.Generator().manual_seed(seed + 32),
                                              AUG_BATCH, spatial, channels, cfg)
            ran = augment._host_gates(draws, augment.resolve_config(cfg))
            ran = ", ".join(f"{k} {int(v.sum())}" for k, v in ran.items()
                            if k in ("affine", "elastic", "bias", "gamma", "noise", "blur"))
            card_draws = {k: v.cuda() for k, v in draws.items()}
            for dtype in dtypes:
                x = X.to(dtype)
                t0 = time.perf_counter()
                cpu_x, cpu_y = augment.apply_augmentation(x, ids, draws, cfg)
                cpu_s = time.perf_counter() - t0
                card_x, card_y = augment.apply_augmentation(x.cuda(), ids.cuda(), card_draws, cfg)
                ref = cpu_x.float()
                err = float((card_x.float().cpu() - ref).abs().max() / ref.abs().max())
                tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
                assert card_x.dtype == dtype and err <= tol, (name, gates, dtype, err)
                assert torch.equal(card_y.cpu(), cpu_y), (name, gates, dtype)
                timed = ""
                if gates == "reference gates":
                    generator = torch.Generator(device="cuda").manual_seed(seed)
                    xc, yc = x.cuda(), ids.cuda()
                    ms = time_ms(lambda: augment.augment_batch(generator, xc, yc, cfg),
                                 trials=5, calls=3)
                    timed = f"; augment_batch {ms:.3f} ms per batch (draws included)"
                print(f"fast-path augment {name} {DTYPE_NAMES[dtype]} {gates} "
                      f"({AUG_BATCH} x {'x'.join(map(str, spatial))} x {channels}; samples "
                      f"per stage: {ran}): card against CPU max|diff|/max|CPU| {err:.3e} "
                      f"(limit {tol:.3e}), labels bit for bit; CPU {cpu_s:.2f} s{timed} "
                      f"[{card}]", flush=True)


def patch_cache_check(card, context, seed):
    """The msseg2 trainer's DevicePatchCache: one batch of patches drawn on
    the card equals extract_patch of the pretransformed subjects at the
    drawn starts; ms per sample() call."""
    trainer = context.trainer
    cache, subjects = trainer._cache, trainer._cache_dataset.subjects
    idx = list(range(min(AUG_BATCH, len(subjects))))
    generator = torch.Generator(device="cuda").manual_seed(seed)
    batch, starts = cache.sample(idx, generator)
    starts = starts.cpu().numpy()
    for k, i in enumerate(idx):
        patch = extract_patch(subjects[i], starts[k], cache.patch_size)
        assert np.array_equal(batch["X"][k].cpu().numpy(),
                              np.moveaxis(np.asarray(patch["X"].data), 0, -1)), i
        assert np.array_equal(batch["y"][k].cpu().numpy(),
                              np.asarray(patch["y"].data).argmax(0)), i
    ms = time_ms(lambda: cache.sample(idx, generator), trials=5, calls=5)
    print(f"fast-path msseg2 DevicePatchCache: {len(idx)} patches of "
          f"{'x'.join(map(str, cache.patch_size))} from volumes padded to "
          f"{'x'.join(map(str, cache.volume_shape))} equal extract_patch at the drawn starts; "
          f"sample() {ms:.3f} ms per batch; {cache.nbytes} bytes with the CDFs [{card}]",
          flush=True)


def fast_path_phase(card, seed, root, ms_root, tmp, drop_contours):
    """tpu_fast_path=True on the card: the augmentation checks, dmri_hippo's
    trainer in f32 and bf16 (each profiled in steady state) over phase 11's
    dataset under ``root``, then msseg2's in f32 over ``ms_root``, profiled
    within its run, and the patch cache's check."""
    augment_checks(card, seed)
    for dtype in (torch.float32, torch.bfloat16):
        name = DTYPE_NAMES[dtype]
        context, _ = hippo_trainer_run(
            card, root, os.path.join(tmp, f"logs-fast-{name}"), dtype, drop_contours,
            fast_path=True,
            iterations=TRAINER_ITERATIONS if dtype == torch.float32 else SHORT_TRAINER_ITERATIONS)
        profile_trainer(card, context, f"fast-path dmri_hippo {name}")
        del context
        torch.cuda.empty_cache()
    context = ms_trainer_run(card, ms_root, os.path.join(tmp, "logs-fast-msseg2"),
                             drop_contours, fast_path=True, iterations=MS_FAST_ITERATIONS)
    patch_cache_check(card, context, seed)


# Phase 13, cli: the port's entry points as users start them, through their
# main functions (ms_run as a subprocess, as the competition runs it), over
# phase 11's datasets on disk.
CLI_ITERATIONS = 6
CLI_HIPPO_COHORT = "cbbrain_validation"
# run_inference: the orientations of its CPU comparison (full volumes at
# N=1 take seconds each on the CPU); the first 8 share one grid
CLI_CPU_ORIENTATIONS = 4
HIPPO_OUTPUT = "dmri-hippo-dmri-hippo"


@contextlib.contextmanager
def patched(owner, name, value):
    original = owner.__dict__[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, original)


@contextlib.contextmanager
def timed(targets):
    """Seconds spent in each of ``targets`` (label -> (owner, attribute):
    a module's function or a class's method), from a synchronize to a
    synchronize, summed over the calls."""
    spent = Counter()
    with contextlib.ExitStack() as stack:
        for label, (owner, name) in targets.items():
            def wrapper(*args, fn=getattr(owner, name), label=label, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    torch.cuda.synchronize()
                    spent[label] += time.perf_counter() - t0
            stack.enter_context(patched(owner, name, wrapper))
        yield spent


def cli_run(targets, run):
    """``run()`` with the launch counts from 0 and ``targets`` timed: its
    result, wall seconds, seconds by target and launch counts."""
    reset_launch_counts()
    with timed(targets) as spent:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return result, wall, spent, launch_counts()


def split_per_subject(wall, spent, subjects):
    """Per subject: model load, device work (the predictor's calls) and the
    rest, the host's (data pipeline, inversion, post-processing, NIfTI
    writes), in seconds."""
    host = wall - spent["load"] - spent["device"]
    return (f"{wall / subjects:.3f} s per subject over {subjects}: model load "
            f"{spent['load'] / subjects:.3f}, device work {spent['device'] / subjects:.3f}, "
            f"host {host / subjects:.3f}")


@contextlib.contextmanager
def cli_contexts(drop_contours):
    """The configurations as the CLIs build them, without the contour-image
    schedules where matplotlib or PIL is missing."""
    def dropping(get_context):
        def wrapped(*args, **kwargs):
            context = get_context(*args, **kwargs)
            without_contour_images(context)
            return context
        return wrapped

    if not drop_contours:
        yield
        return
    with patched(hippo_config, "get_context", dropping(hippo_config.get_context)), \
            patched(cli_ms_run, "get_context", dropping(cli_ms_run.get_context)):
        yield


def cli_train_checks(card, label, logs, wall, counts, iterations, convs=CONVS_PER_FORWARD,
                     dx=DX_PER_STEP):
    """A dmri_hippo training CLI run: launches per iteration (25/23/25 at
    the training batch for NestedResUNet; ``convs``/``dx``/``convs`` for
    another network) and per validation batch, the checkpoints, the rates;
    returns the last checkpoint."""
    per_iteration = {kind: sum(n for key, n in c.items() if key[1] == 2 * SUBJECTS_PER_REQUEST)
                     for kind, c in counts.items()}
    assert per_iteration == {"fwd": convs * iterations, "dx": dx * iterations,
                             "dw": convs * iterations}, counts
    # the validation sweep at iteration 0: its subjects in one batch
    validation = counts["fwd"].total() - per_iteration["fwd"]
    assert validation == convs, counts["fwd"]
    [run_dir] = [os.path.join(logs, d) for d in os.listdir(logs)]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["iteration"] for r in records] == list(range(iterations))
    assert all(np.isfinite(r["loss"]) for r in records)
    checkpoints = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    assert checkpoints == [f"dmri-hippo-iter{i:08}.ckpt" for i in (0, iterations)], checkpoints
    timers = plain_iterations(records, 0)
    text = split_text(timers, iterations, wall)[1] if timers else (
        f"{iterations / wall:.3f} iterations/s over the CLI call ({iterations} iteration(s) in "
        f"{wall:.3f} s, set-up, evaluators and saves included)")
    print(f"cli {label}: {text.replace('train() call', 'CLI call')}; launches per iteration "
          f"forward {convs}, dX {dx}, dW {convs} at "
          f"N={2 * SUBJECTS_PER_REQUEST}, {validation} forward in the validation sweep (one "
          f"batch); checkpoints {checkpoints} [{card}]", flush=True)
    return os.path.join(run_dir, "checkpoints", checkpoints[-1])


def cli_dmri_training(card, root, tmp):
    """run.py main for two folds, fold 0 on the default path and fold 1 with
    --tpu-fast-path; their last checkpoints in one ensemble folder."""
    ensemble = os.path.join(tmp, "cli-ensemble")
    os.makedirs(ensemble)
    for fold, fast in ((0, False), (1, True)):
        logs = os.path.join(tmp, f"cli-dmri-fold{fold}")
        args = cli_run_module.build_parser().parse_args(
            ["main", root, logs, "--fold", str(fold), "--max-iterations", str(CLI_ITERATIONS),
             "--num-workers", str(TRAINER_WORKERS)] + (["--tpu-fast-path"] if fast else []))
        _, wall, _, counts = cli_run({}, lambda: args.func(args))
        label = f"run.py main dmri_hippo fold {fold}" + (" --tpu-fast-path" if fast else "")
        last = cli_train_checks(card, label, logs, wall, counts, CLI_ITERATIONS)
        shutil.copy(last, os.path.join(ensemble, f"fold{fold}.ckpt"))
    return ensemble


def hippo_outputs(out, root, names, output=HIPPO_OUTPUT):
    """The hippo_inference outputs ``output`` of ``names``: int labels in {0,
    1, 2} on the scanner grid with the scanner affine, the report and the
    settings."""
    labels = []
    for name in names:
        for suffix in ("_before_processing", ""):
            data, affine = read_nifti(os.path.join(out, "subjects", name,
                                                   f"{output}{suffix}.nii.gz"))
            _, raw_affine = read_nifti(os.path.join(root, "subjects", name, "mean_dwi.nii.gz"))
            assert data.shape == (1, *ORIGINAL_GRID) and np.issubdtype(data.dtype, np.integer)
            assert set(np.unique(data)) <= {0, 1, 2} and np.allclose(affine, raw_affine)
        labels.append(data)
    with open(os.path.join(out, f"{output}.txt")) as f:
        assert f.read().count("Filled") == len(names)
    with open(os.path.join(out, "cli.json")) as f:
        settings = json.load(f)
    assert settings["output_filename"] == f"{output}.nii.gz"
    return labels


def cli_hippo_serving(card, root, ensemble, tmp):
    """hippo_inference main over the two folds' checkpoints, flip TTA
    batched, fold majority, in f32 and bf16; then evaluate.py on the f32
    predictions where pandas imports."""
    names = sorted(n for n in os.listdir(os.path.join(root, "subjects"))
                   if n.startswith("cbbrain"))[:HIPPO_SUBJECTS["validation"]]
    targets = {"load": (cli_hippo, "load_contexts"), "device": (StandardPredict, "predict")}
    labels = {}
    for dtype in (torch.float32, torch.bfloat16):
        out = os.path.join(tmp, f"cli-hippo-{DTYPE_NAMES[dtype]}")
        os.makedirs(out)
        _, wall, spent, counts = cli_run(targets, lambda: cli_hippo.main(
            ensemble, root, "cli", out_folder=out, ensemble_flips=True, ensemble_folds=True,
            batched_tta=True, cohort=CLI_HIPPO_COHORT, bf16=dtype == torch.bfloat16))
        assert counts["fwd"] == expected_launches(dtype, FOLDS, TTA_BATCH), counts["fwd"]
        labels[dtype] = hippo_outputs(out, root, names)
        print(f"cli hippo_inference {DTYPE_NAMES[dtype]} --ensemble-flips --ensemble-folds "
              f"--batched-tta: {split_per_subject(wall, spent, len(names))}; "
              f"{FOLDS * CONVS_PER_FORWARD} forward launches at N={TTA_BATCH} (one request of "
              f"{len(names)} subjects); NIfTIs on {'x'.join(map(str, ORIGINAL_GRID))}, report "
              f"and settings written [{card}]", flush=True)
    same = np.mean([np.mean(a == b) for a, b in zip(labels[torch.float32],
                                                      labels[torch.bfloat16])])
    print(f"cli hippo_inference bf16 against f32: {same:.5f} of the voxels share the label",
          flush=True)
    for dtype in DTYPES:
        out = os.path.join(tmp, f"cli-affine-{DTYPE_NAMES[dtype]}")
        os.makedirs(out)
        torch.cuda.reset_peak_memory_stats()
        _, wall, spent, counts = cli_run(targets, lambda: cli_hippo.main(
            ensemble, root, "cli", out_folder=out, ensemble_flips=True, ensemble_folds=True,
            ensemble_affines=AFFINE_MEMBERS, batched_tta=True, cohort=CLI_HIPPO_COHORT,
            bf16=dtype == torch.bfloat16))
        assert counts["fwd"] == expected_launches(dtype, FOLDS, AFFINE_BATCH), counts["fwd"]
        hippo_outputs(out, root, names)
        print(f"cli hippo_inference {DTYPE_NAMES[dtype]} --ensemble-affines {AFFINE_MEMBERS} "
              f"--ensemble-flips --ensemble-folds --batched-tta: the request (one predictor "
              f"call, {len(names)} subjects) {spent['device'] * 1e3:.3f} ms; "
              f"{split_per_subject(wall, spent, len(names))}; {FOLDS * CONVS_PER_FORWARD} "
              f"forward launches at N={AFFINE_BATCH}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} bytes [{card}]", flush=True)
    try:
        import pandas  # noqa: F401
    except ImportError as error:
        print(f"cli evaluate.py: not run, it writes its results through pandas and here "
              f"{error}", flush=True)
        return
    t0 = time.perf_counter()
    results = cli_evaluate.main(root, os.path.join(tmp, "cli-hippo-f32"), "validation")
    seg = results["cli"]["segmentation_eval/cbbrain_validation"]
    print(f"cli evaluate.py on the f32 predictions: {sorted(results['cli'])}; "
          f"{len(seg['subject_stats'])} subject rows; {time.perf_counter() - t0:.2f} s",
          flush=True)


def cli_orientations(card, root, ensemble, tmp, seed):
    """run_inference main at 48 orientations on two subjects on the card;
    the first CLI_CPU_ORIENTATIONS of one subject against the port on the
    CPU from the same checkpoint: each orientation's labels equal outside
    near-ties, the vote equal where they all agree."""
    two = os.path.join(tmp, "cli-two")
    names = sorted(n for n in os.listdir(os.path.join(root, "subjects"))
                   if n.startswith("cbbrain"))[:2]
    for name in names:
        shutil.copytree(os.path.join(root, "subjects", name), os.path.join(two, "subjects", name))
    for folder in ("atlas", "attributes"):
        shutil.copytree(os.path.join(root, folder), os.path.join(two, folder))
    checkpoint = os.path.join(ensemble, "fold0.ckpt")
    out = os.path.join(tmp, "cli-orientations")
    targets = {"load": (cli_run_inference, "load_contexts"),
               "device": (StandardPredict, "predict")}
    _, wall, spent, counts = cli_run(targets, lambda: cli_run_inference.main(
        [checkpoint, two, "tta48.nii.gz", "--out-folder", out]))
    assert counts["fwd"].total() == 2 * 48 * CONVS_PER_FORWARD and \
        {key[1] for key in counts["fwd"]} == {1}, counts["fwd"]
    for name in names:
        data, _ = read_nifti(os.path.join(out, name, "tta48.nii.gz"))
        assert data.shape == (1, *ORIGINAL_GRID) and set(np.unique(data)) <= {0, 1}
    print(f"cli run_inference 48 orientations: {split_per_subject(wall, spent, 2)}; "
          f"{48 * CONVS_PER_FORWARD} forward launches per subject at N=1 [{card}]", flush=True)

    recorded = []

    def recording(self, model, subjects, label_attributes=None, predict=StandardPredict.predict):
        subjects, batch = predict(self, model, subjects, label_attributes)
        recorded.append(torch.as_tensor(np.array(subjects[0]["y_pred"].data))[None])
        return subjects, batch

    votes = {}
    torch.set_num_threads(os.cpu_count() or 1)
    with uncounted(), patched(StandardPredict, "predict", recording):
        for device in ("cuda", "cpu"):
            context = tsp.Context(device, file_path=checkpoint,
                                  variables={"DATASET_PATH": two})
            context.keep_components(("model", "dataset"))
            context.init_components()
            subject = context.dataset[0]
            t0 = time.perf_counter()
            votes[device] = cli_run_inference.test_time_augmentation(
                subject, StandardPredict(image_names=["X"], device=device), context.model,
                CLI_CPU_ORIENTATIONS)
            cpu_s = time.perf_counter() - t0
    card_probs, cpu_probs = recorded[:CLI_CPU_ORIENTATIONS], recorded[CLI_CPU_ORIENTATIONS:]
    agree = all(torch.equal(g.argmax(1), c.argmax(1)) for g, c in zip(card_probs, cpu_probs))
    compare_cpu(f"cli run_inference first {CLI_CPU_ORIENTATIONS} orientations of {names[0]} "
                f"vs CPU port", card_probs, cpu_probs, cpu_s, card)
    if agree:
        assert np.array_equal(votes["cuda"], votes["cpu"])
    print(f"cli run_inference vote of {CLI_CPU_ORIENTATIONS} orientations, card against CPU: "
          f"every orientation's labels equal {agree}, votes equal "
          f"{np.array_equal(votes['cuda'], votes['cpu'])}", flush=True)


def cli_msseg2(card, ms_root, tmp):
    """msseg2/run.py with --tpu-fast-path, then ms_inference main on its
    checkpoint with and without --device-argmax (identical masks), then
    ms_run on one raw FLAIR pair (its mask equals ms_inference's on the
    staged folder)."""
    logs = os.path.join(tmp, "cli-msseg2")
    _, wall, _, counts = cli_run({}, lambda: cli_ms_run.main(
        [ms_root, logs, "--max-iterations", str(CLI_ITERATIONS), "--num-workers",
         str(TRAINER_WORKERS), "--tpu-fast-path"]))
    step = ms_expected_train_launches(torch.float32, CLI_ITERATIONS)
    assert counts["dx"] == step["dx"] and counts["dw"] == step["dw"], counts
    validation = counts["fwd"] - step["fwd"]
    assert counts["fwd"] - validation == step["fwd"] and validation.total() > 0 and \
        validation.total() % MS_CONVS_PER_FORWARD == 0, counts["fwd"]
    [run_dir] = [os.path.join(logs, d) for d in os.listdir(logs)]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["iteration"] for r in records] == list(range(CLI_ITERATIONS))
    _, text = split_text(plain_iterations(records, 0), CLI_ITERATIONS, wall)
    checkpoint = os.path.join(run_dir, "checkpoints", f"msseg2-iter{CLI_ITERATIONS:08}.ckpt")
    print(f"cli msseg2/run.py --tpu-fast-path: {text.replace('train() call', 'CLI call')}; "
          f"launches per iteration forward {MS_FWD_PER_STEP}, dX {MS_DX_PER_STEP}, dW "
          f"{MS_CONVS_PER_FORWARD} [{card}]", flush=True)

    targets = {"load": (cli_ms_inference, "load_contexts"), "device": (PatchPredict, "predict")}
    masks = {}
    for argmax in (False, True):
        out = os.path.join(tmp, f"cli-ms-{argmax}")
        _, wall, spent, counts = cli_run(targets, lambda: cli_ms_inference.main(
            [checkpoint, ms_root, "mask.nii.gz", "--cohort", "validation", "--out-folder", out]
            + (["--device-argmax"] if argmax else [])))
        patches = counts["fwd"].total() // MS_CONVS_PER_FORWARD
        assert counts["fwd"] == Counter({(str(torch.float32), 1, *spatial, cin, cout): n * patches
                                         for spatial, cin, cout, n in MS_CONV_CLASSES})
        [name] = os.listdir(out)
        masks[argmax], affine = read_nifti(os.path.join(out, name, "mask.nii.gz"))
        _, raw_affine = read_nifti(os.path.join(ms_root, name, "flair_time01.nii.gz"))
        assert masks[argmax].shape == (1, *MS_RAW_GRID) and np.allclose(affine, raw_affine)
        print(f"cli ms_inference{' --device-argmax' if argmax else ''}: "
              f"{split_per_subject(wall, spent, 1)}; {patches} patches of "
              f"{MS_CONVS_PER_FORWARD} forward launches at N=1; lesion voxels "
              f"{int(masks[argmax].sum())} [{card}]", flush=True)
    assert np.array_equal(masks[False], masks[True])

    ensemble = os.path.join(tmp, "cli-ms-ensemble")
    os.makedirs(ensemble)
    shutil.copy(checkpoint, ensemble)
    data = os.path.join(tmp, "cli-ms-run")
    output = os.path.join(tmp, "cli-ms-run.nii.gz")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "segmentation_pipeline_torch.research.msseg2."
                    "competition.ms_run", "-t1", os.path.join(ms_root, name, "flair_time01.nii.gz"),
                    "-t2", os.path.join(ms_root, name, "flair_time02.nii.gz"), "-o", output,
                    "-d", data, "--ensemble-path", ensemble],
                   cwd=os.path.dirname(os.path.abspath(__file__)), check=True, timeout=600)
    ms_run_s = time.perf_counter() - t0
    staged = os.path.join(data, "input", "raw_data")
    with uncounted():
        cli_ms_inference.main([checkpoint, staged, "again.nii.gz", "--out-folder",
                               os.path.join(tmp, "cli-ms-again")])
    served, _ = read_nifti(output)
    again, _ = read_nifti(os.path.join(tmp, "cli-ms-again", "01", "again.nii.gz"))
    assert served.shape == (1, *MS_RAW_GRID) and np.array_equal(served, again)
    print(f"cli ms_run (a subprocess: staging, all-ones brain mask, ms_inference): "
          f"{ms_run_s:.3f} s for one FLAIR pair; its mask equals ms_inference's on the staged "
          f"folder ({int(served.sum())} lesion voxels) [{card}]", flush=True)


# Serving determinism: the msseg2 competition request, probabilities and not
# only masks, in separate processes (each one picks its own cuDNN algorithms).
DETERMINISM_PROCESSES = 2


def serve_probabilities(seed, out):
    """In a process of its own: the competition request's probabilities
    (no argmax) on one raw msseg2 subject at random weights from ``seed``,
    twice in float32 and twice in bfloat16, saved to ``out`` (.npz)."""
    build.build(conv3x3.SOURCES)
    rng = np.random.default_rng(seed)
    raw = msseg2_subject(tsp, *msseg2_volumes(rng, MS_RAW_GRID, MS_RAW_SPACING,
                                              MS_SEMI_AXES_MM), "ms-0")
    subject = msseg2_config.build_pipelines(MS_PATCH)["default"](raw)
    model = msseg2_model(seed, "cuda")
    predictor = competition_predictor()
    arrays = {}
    for dtype in (torch.float32, torch.bfloat16):
        model.compute_dtype = None if dtype == torch.float32 else "bfloat16"
        for call in range(2):
            [served], _ = predictor.predict(model, [copy.deepcopy(subject)])
            arrays[f"{DTYPE_NAMES[dtype]}-{call}"] = np.asarray(served["y_pred"].data)
    np.savez(out, **arrays)


def serving_determinism(card, seed, tmp, processes=DETERMINISM_PROCESSES):
    """The competition request's probabilities from ``processes`` processes
    (this one and the rest started afresh, all serving at once), two calls
    per type in each, bit for bit: every call against this process's first
    call of its type. Raises where any differ."""
    files = [os.path.join(tmp, f"probabilities-{p}.npz") for p in range(processes)]
    others = [subprocess.Popen([sys.executable, "-c", "import chip_smoke; "
                                f"chip_smoke.serve_probabilities({seed}, {out!r})"],
                               cwd=os.path.dirname(os.path.abspath(__file__)))
              for out in files[1:]]
    try:
        with uncounted():
            serve_probabilities(seed, files[0])
        for other in others:
            if other.wait(timeout=600):
                raise subprocess.CalledProcessError(other.returncode, other.args)
    finally:
        for other in others:
            if other.poll() is None:
                other.kill()
                other.wait()
    reference = np.load(files[0])
    verdict = []
    for dtype in ("f32", "bf16"):
        ref = reference[f"{dtype}-0"]
        differ = [(p, call, int((np.load(f)[f"{dtype}-{call}"] != ref).sum()),
                   float(np.abs(np.load(f)[f"{dtype}-{call}"] - ref).max()))
                  for p, f in enumerate(files) for call in range(2)]
        bad = [d for d in differ if d[2]]
        verdict.append(f"{dtype} {2 * processes - len(bad)} of {2 * processes} calls bit for bit"
                       + (f", differing (process, call, voxels, max abs): {bad}" if bad else ""))
    for f in files:
        os.unlink(f)
    line = (f"serving determinism: msseg2 competition request probabilities on "
            f"{'x'.join(map(str, MS_RAW_GRID))} in {processes} processes: "
            + "; ".join(verdict) + f" [{card}]")
    print(line, flush=True)
    assert "differing" not in line, line


# Commit against commit (not run by default): ms per msseg2 competition
# request from several checkouts, each in a process of its own, in one call.
COMPARE_REQUESTS = 5


def request_times(seed, requests, card):
    """Run by source in a process whose working directory is a checkout, on
    that checkout's chip_smoke and port (names that older chip_smoke
    scripts also define): ms per competition request on one raw msseg2
    subject at random weights from ``seed``, f32 then bf16, each after one
    untimed, then one profiled request per type; the times on a ``request
    times`` JSON line."""
    import copy
    import json
    import time

    import numpy as np
    import torch

    import chip_smoke as cs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build.build(cs.conv3x3.SOURCES)
    rng = np.random.default_rng(seed + 7)
    raw = cs.msseg2_subject(cs.tsp, *cs.msseg2_volumes(rng, cs.MS_RAW_GRID, cs.MS_RAW_SPACING,
                                                       cs.MS_SEMI_AXES_MM), "ms-0")
    subject = cs.msseg2_config.build_pipelines(cs.MS_PATCH)["default"](raw)
    model = cs.msseg2_model(seed, "cuda")
    predictor = cs.competition_predictor(device_argmax=True)
    times = {}
    for name in ("f32", "bf16"):
        model.compute_dtype = None if name == "f32" else "bfloat16"
        times[name] = []
        for _ in range(requests + 1):
            one = copy.deepcopy(subject)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictor.predict(model, [one])
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
        del times[name][0]
        cs.profile_request(model, predictor, [copy.deepcopy(subject)], f"msseg2 {name}", card)
    print("request times " + json.dumps(times), flush=True)


def compare_requests(card, trees, seed, requests=COMPARE_REQUESTS):
    """``request_times`` in each checkout of ``trees`` in turn (give the
    parent and the change as parent, change, change, parent); each
    process's output, then the medians by checkout and type."""
    code = inspect.getsource(request_times) + f"\nrequest_times({seed}, {requests}, {card!r})\n"
    by_tree = {}
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", code], cwd=tree, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, timeout=900)
        print(f"== {tree}\n{proc.stdout.strip()}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"request_times failed in {tree} (rc {proc.returncode})")
        line = next(x for x in proc.stdout.splitlines() if x.startswith("request times "))
        for name, values in json.loads(line[len("request times "):]).items():
            by_tree.setdefault(tree, {}).setdefault(name, []).extend(values)
    for tree, by_type in by_tree.items():
        print(f"compare {tree}: msseg2 competition request ms, median of "
              f"{len(by_type['f32'])}: " + "; ".join(
                  f"{name} {statistics.median(v):.3f} ({min(v):.3f}-{max(v):.3f})"
                  for name, v in by_type.items()) + f" [{card}]", flush=True)


def cli_phase(card, seed, root, ms_root, tmp, drop_contours):
    """The CLIs on the card: dmri_hippo training for two folds, its TTA
    serving in f32 and bf16 and the evaluation, 48-orientation serving,
    msseg2 training, serving and the competition entry."""
    t0 = time.perf_counter()
    with cli_contexts(drop_contours):
        ensemble = cli_dmri_training(card, root, tmp)
        cli_msseg2(card, ms_root, tmp)
    cli_hippo_serving(card, root, ensemble, tmp)
    cli_orientations(card, root, ensemble, tmp, seed)
    print(f"cli phase: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


# Phase 14, qsm-dwi: qsm's configuration (research/qsm_deep_grey_matter) on
# whole volumes with gradient accumulation, and dmri_hippo's DWI augmentation
# modes with the hybrid device cache.
QSM_GRID = (256, 288, 128)
QSM_CROP = (68, 68, 72, 72, 16, 16)  # the configuration's default, 120x144x96
QSM_AFFINE = np.diag([0.6875, 0.6875, 1.25, 1.0])
QSM_TRAINING = ["Cb_Brain_001", "Cb_Brain_002", "Cb_Brain_003", "Cb_Brain_004"]
QSM_IN_CHANNELS, QSM_OUT_CHANNELS = 2, 10
# NestedResUNet(2 -> 10, filters=40) on the reference crop (68, 68, 72, 72,
# 16, 16) of 256x288x128, 120x144x96: ((W, H, D), Cin, Cout, launches per
# forward)
QSM_CONV_CLASSES = [
    ((120, 144, 96), 2, 40, 2), ((120, 144, 96), 40, 40, 4),
    ((120, 144, 96), 80, 40, 6), ((120, 144, 96), 40, 10, 1),
    ((60, 72, 48), 40, 40, 4), ((60, 72, 48), 120, 40, 2),
    ((30, 36, 24), 40, 40, 3), ((30, 36, 24), 120, 40, 1),
    ((15, 18, 12), 40, 40, 2),
]
# the reference (batch 4, f32) and the configuration's recipe (microbatch 2
# with accumulate_steps=2, tpu_fast_path, bf16): the (N, dtype) each runs
# its micro-steps at, the kernels line's rows
QSM_RUNS = ((4, torch.float32), (2, torch.bfloat16))
# the kernel timings at these sizes: each call takes up to a few tens of ms
# (the plain version up to about a second)
QSM_TIMING = (dict(trials=3, calls=2, warmup=1), dict(trials=1, calls=1, warmup=1))
QSM_REFERENCE_ITERATIONS, QSM_RECIPE_STEPS, QSM_PROFILE_START = 13, 18, 3
# the accumulation check and the card-against-CPU step: a volume cut to
# 64x64x32
QSM_CUT = (64, 64, 32)
# Two micro-steps of 2 with accumulate_steps=2 against one step of 4 (SGD,
# no BatchNorm, no dropout: the loss is a mean of per-subject terms), the
# update ||d_accumulated - d_full|| / ||d_full||: float32 sums over the
# batch in another split through 25 convs forward and backward.
QSM_ACCUMULATION_TOL = 1e-4
DWI_ITERATIONS, DEBUG_ITERATIONS = 4, 2
# the HybridHostAugment.apply call of the fast DWI run that runs under
# cProfile
PROFILED_APPLY = 3


def qsm_volumes(rng: np.random.Generator):
    """One qsm subject on QSM_GRID: MPRAGE and QSM (float32) with the 17 deep
    grey matter structures of DGM_LABEL_VALUES as blocks inside QSM_CROP
    (left structures, odd ids, in the lower half of W, the left hemisphere
    of QSM_AFFINE's positive x axis), the internal capsule (17) and the
    thalami's pulvinar (7, 8) maps."""
    W, H, D = QSM_GRID
    dgm = np.zeros((1, W, H, D), np.int16)
    lo = QSM_CROP[0::2]
    hi = (W - QSM_CROP[1], H - QSM_CROP[3], D - QSM_CROP[5])
    block = [max((b - a) // k, 1) for a, b, k in zip(lo, hi, (12, 12, 16))]
    mid = W // 2
    for v in qsm_config.DGM_LABEL_VALUES.values():
        x = int(rng.integers(lo[0], mid - block[0])) if v % 2 else \
            int(rng.integers(mid, hi[0] - block[0]))
        y, z = (int(rng.integers(a, b - n)) for a, b, n in zip(lo[1:], hi[1:], block[1:]))
        dgm[0, x:x + block[0], y:y + block[1], z:z + block[2]] = v
    fg = (dgm > 0).astype(np.float32)
    t1 = rng.gamma(4.0, 0.25, dgm.shape).astype(np.float32) + 2.0 * fg
    qsm = rng.normal(0.0, 0.05, dgm.shape).astype(np.float32) + 0.1 * fg
    ic = np.where(dgm == 17, dgm, 0).astype(np.int16)
    pulv = np.where(np.isin(dgm, (7, 8)), dgm, 0).astype(np.int16)
    return {"MPRAGE.nii": t1, "QSM.nii": qsm, "vB_PS_r.nii.gz": dgm, "IC.nii.gz": ic,
            "pulv.nii.gz": pulv}


def write_qsm_dataset(root, seed):
    """qsm's layout under ``root``: subjects/<name>/{MPRAGE, QSM, vB_PS_r, IC,
    pulv}, the two subjects of the configuration's validation cohort and
    four training subjects."""
    rng = np.random.default_rng(seed)
    for name in [*qsm_config.VAL_SUBJECTS, *QSM_TRAINING]:
        folder = os.path.join(root, "subjects", name)
        os.makedirs(folder)
        for file_name, data in qsm_volumes(rng).items():
            write_nifti(os.path.join(folder, file_name), data, QSM_AFFINE)


def qsm_expected_launches(dtype, n, steps, remat, sweeps):
    """Forward, dX and dW launches by shape: ``steps`` micro-steps at batch
    ``n`` (with remat the blocks' 24 convs run again in the backward; the
    out conv, the only one with QSM_OUT_CHANNELS, does not) and ``sweeps``
    validation forwards of the two validation subjects (N=2)."""
    fwd, dx, dw = Counter(), Counter(), Counter()
    for spatial, cin, cout, m in QSM_CONV_CLASSES:
        recomputed = m if remat and cout != QSM_OUT_CHANNELS else 0
        fwd[(str(dtype), n, *spatial, cin, cout)] += (m + recomputed) * steps
        fwd[(str(dtype), 2, *spatial, cin, cout)] += m * sweeps
        dw[(str(dtype), n, *spatial, cin, cout)] += m * steps
        if cin != QSM_IN_CHANNELS:
            dx[(str(dtype), n, *spatial, cout, cin)] += m * steps
    return {"fwd": +fwd, "dx": +dx, "dw": +dw}


def qsm_kernel_phase(device, seed, card):
    """The forward, dX and dW at the nine qsm classes at the (N, dtype) of
    each training run, each checked and timed (the kernels line's rows),
    and the forward of the reference's iteration-0 sweep (N=2, f32),
    checked."""
    rows = []
    for i, (n, dtype) in enumerate(QSM_RUNS):
        rows += (kernel_phase(device, n, seed + 2 * i, card, QSM_CONV_CLASSES, (dtype,),
                              QSM_TIMING)
                 + grad_kernel_phase(device, n, seed + 2 * i + 1, card, QSM_CONV_CLASSES,
                                     QSM_IN_CHANNELS, (dtype,), QSM_TIMING))
    kernel_phase(device, 2, seed + 2 * len(QSM_RUNS), card, QSM_CONV_CLASSES,
                 (torch.float32,), timing=None)
    return rows


@contextlib.contextmanager
def banking_watch(moves):
    """Record, for each MultiSteps micro-step, whether the inner optimizer
    stepped and, as a boolean tensor on the card, whether any parameter
    moved (one flat copy of the parameters before, one comparison after).
    Nothing here waits for the card, so the loop still runs ahead of it;
    read the tensors after the run."""
    original = tsp.MultiSteps.step

    def step(self):
        before = torch.cat([p.detach().reshape(-1) for p in self._params()])
        emitted = original(self)
        after = torch.cat([p.detach().reshape(-1) for p in self._params()])
        moves.append((emitted, (before != after).any()))
        return emitted

    with patched(tsp.MultiSteps, "step", step):
        yield


def qsm_trainer_run(card, root, logs, recipe, drop_contours):
    """qsm's configuration at full width on whole volumes: the reference
    (batch 4, f32, the default path, 4 threads) or the configuration's
    recipe (microbatch 2 with accumulate_steps=2, tpu_fast_path, bf16),
    PROFILED_ITERATIONS plain iterations profiled within the run (left out
    of its rate). Asserts the launches per micro-step by class, the
    iteration-0 sweep and, for the recipe, that the parameters move on
    every second micro-step only. Returns the launches per micro-step."""
    kwargs = dict(tpu_fast_path=True, microbatch=2, compute_dtype="bfloat16") if recipe else {}
    n, dtype = QSM_RUNS[1] if recipe else QSM_RUNS[0]
    iterations = QSM_RECIPE_STEPS if recipe else QSM_REFERENCE_ITERATIONS
    context = qsm_config.get_context(variables={"DATASET_PATH": root}, crop=QSM_CROP,
                                     filters=FILTERS, **kwargs)
    if drop_contours:
        without_contour_images(context)
    context.init_components()
    logger = ProfilingFileLogger(logs).profile(QSM_PROFILE_START)
    moves = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with banking_watch(moves) if recipe else contextlib.nullcontext():
        t0 = time.perf_counter()
        context.trainer.train(context, max_iterations=iterations, num_workers=TRAINER_WORKERS,
                              logger=logger)
        wall_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    moves = [(emitted, bool(moved)) for emitted, moved in moves]
    expected = qsm_expected_launches(dtype, n, iterations, recipe, sweeps=1)
    assert counts == expected, (counts, expected)
    per_step = {kind: sum(v for k, v in c.items() if k[1] == n and k[0] == str(dtype))
                for kind, c in qsm_expected_launches(dtype, n, 1, recipe, 0).items()}
    if recipe:
        optimizer = context.trainer._train_state.opt_state
        assert isinstance(optimizer, tsp.MultiSteps) and optimizer.every_k == 2
        assert [emitted for emitted, _ in moves] == [i % 2 == 1 for i in range(iterations)]
        assert [moved for _, moved in moves] == [i % 2 == 1 for i in range(iterations)], moves
        assert optimizer.gradient_step == iterations // 2
        assert all(p.dtype == torch.float32 for p in context.model.params.values())
    records = read_records(logger)
    assert [r["iteration"] for r in records] == list(range(iterations))
    assert {"segmentation_eval", "training_segmentation_eval", "model_score"} <= set(records[0])
    assert np.isfinite(records[0]["model_score"]) and all(np.isfinite(r["loss"]) for r in records)
    window = range(logger.start, logger.stop + 2)
    rate, text = split_text(plain_iterations([r for r in records if r["iteration"] not in window],
                                             0), iterations, wall_s)
    # qsm's pipeline is deterministic: the fast path derives no device augmentation
    label = ("qsm recipe (microbatch 2, accumulate_steps=2, tpu_fast_path, bf16): "
             f"{fast_path_text(context.trainer, augmented=False)}" if recipe
             else f"qsm reference (batch 4, f32, num_workers={TRAINER_WORKERS})")
    banking = (f"; parameters moved after micro-steps {[i for i, (_, m) in enumerate(moves) if m]}"
               f" only (gradient_step {context.trainer._train_state.opt_state.gradient_step})"
               if recipe else "")
    print(f"{label}: {text} (iterations {window.start}-{window.stop - 1} left out: "
          f"{profile_text(logger)}); seconds by timer entry over the run: "
          f"{timer_totals(records)}; launches per micro-step forward {per_step['fwd']}, dX "
          f"{per_step['dx']}, dW {per_step['dw']} at N={n} {DTYPE_NAMES[dtype]}"
          f"{' (24 recomputed by remat)' if recipe else ''}, 25 forward in the iteration-0 "
          f"sweep at N=2; iteration-0 sweep "
          f"{records[0]['timer']['model_forward_evaluation'] * 1e3:.1f} ms; max_memory_allocated "
          f"{peak} bytes; losses {records[0]['loss']:.6f} -> {records[-1]['loss']:.6f}"
          f"{banking} [{card}]", flush=True)
    del context
    torch.cuda.empty_cache()
    return {kind: Counter({k: v // iterations for k, v in c.items() if k[1] == n})
            for kind, c in counts.items()}


def qsm_batch(rng, n, spatial=QSM_CUT):
    """A channel-first batch of qsm's shapes: X (N, 2, ...) and one-hot y of
    10 classes (N, 10, ...)."""
    X = rng.normal(size=(n, QSM_IN_CHANNELS, *spatial)).astype(np.float32)
    ids = rng.integers(0, QSM_OUT_CHANNELS, size=(n, *spatial))
    return {"X": X, "y": np.moveaxis(np.eye(QSM_OUT_CHANNELS, dtype=np.float32)[ids], -1, 1)}


def qsm_accumulation_check(card, seed):
    """On the card: NestedResUNet(2 -> 10, filters=40, use_norm=False) at
    dropout 0 on a cut volume; two micro-steps of N=2 with SGD(lr=0.1,
    accumulate_steps=2) against one step of N=4 with SGD(lr=0.1) from the
    same weights: the same update within QSM_ACCUMULATION_TOL; the first
    micro-step moves nothing."""
    torch.manual_seed(seed)
    state_dict = NestedResUNet(QSM_IN_CHANNELS, QSM_OUT_CHANNELS, filters=FILTERS,
                               use_norm=False).state_dict()
    batch = qsm_batch(np.random.default_rng(seed), 4)

    def run(optimizer, batches):
        model = SegModel(NestedResUNet(QSM_IN_CHANNELS, QSM_OUT_CHANNELS, filters=FILTERS,
                                       use_norm=False))
        model.load_state_dict(state_dict)
        state = create_train_state(model, optimizer, batches[0])
        step = make_train_step(model.module, HybridLogisticDiceLoss(), optimizer)
        after = []
        for b in batches:
            state, _, _ = step(state, collate_to_device(b), None)
            after.append(torch.cat([p.detach().reshape(-1) for p in state.params.values()]))
        return after

    init = torch.cat([v.reshape(-1) for v in state_dict.values()]).cuda()
    with uncounted():
        [full] = run(SGD(lr=0.1), [batch])
        # the same step on the batch in another order: the same update summed
        # in another order, the scale of float32 rounding alone
        [permuted] = run(SGD(lr=0.1), [{k: v[[2, 3, 0, 1]] for k, v in batch.items()}])
        banked, accumulated = run(SGD(lr=0.1, accumulate_steps=2),
                                  [{k: v[:2] for k, v in batch.items()},
                                   {k: v[2:] for k, v in batch.items()}])
    torch.cuda.synchronize()
    assert torch.equal(banked, init), "parameters moved on a banked micro-step"
    d_full = full - init
    rel, floor = (((d - d_full).norm() / d_full.norm()).item()
                  for d in (accumulated - init, permuted - init))
    print(f"qsm accumulation on the card (NestedResUNet 2->10 filters {FILTERS}, no BatchNorm, "
          f"dropout 0, {'x'.join(map(str, QSM_CUT))}): 2 micro-steps of N=2 with "
          f"accumulate_steps=2 against 1 step of N=4, SGD lr 0.1: ||d_acc - d_full|| / "
          f"||d_full|| {rel:.3g} (limit {QSM_ACCUMULATION_TOL}); the N=4 step on the batch "
          f"reordered against it {floor:.3g}; the banked micro-step moved nothing [{card}]",
          flush=True)
    assert rel <= QSM_ACCUMULATION_TOL


def qsm_cpu_comparison(card, seed):
    """One f32 step of qsm's network (with BatchNorm, dropout 0) and Adam on
    one cut volume on the card and on the port on the CPU, as phase 9."""
    torch.manual_seed(seed + 1)
    state_dict = NestedResUNet(QSM_IN_CHANNELS, QSM_OUT_CHANNELS, filters=FILTERS).state_dict()
    one = qsm_batch(np.random.default_rng(seed + 1), 1)
    with uncounted():
        cpu_train_comparison(
            card, f"qsm train f32 vs CPU port ({'x'.join(map(str, QSM_CUT))}, dropout 0)",
            lambda: NestedResUNet(QSM_IN_CHANNELS, QSM_OUT_CHANNELS, filters=FILTERS),
            lambda: Adam(lr=2e-4), HybridLogisticDiceLoss(), state_dict, one)


@contextlib.contextmanager
def hybrid_watch(applies, profiles):
    """Time each HybridHostAugment.apply on the host (the regeneration and
    the enqueue of its upload; no synchronize, which would serialize the
    prefetch slot) with its upload bytes, check on the first call that the
    splice leaves every cached channel but the regenerated ones as
    gathered, and run call PROFILED_APPLY under cProfile (its pstats in
    ``profiles``; its time is not in ``applies``)."""
    original = HybridHostAugment.apply
    calls = itertools.count()

    def apply(self, X, indices):
        call = next(calls)
        before = X.clone() if call == 0 else None
        profile = cProfile.Profile() if call == PROFILED_APPLY else None
        t0 = time.perf_counter()
        if profile is not None:
            out = profile.runcall(original, self, X, indices)
            profiles.append(pstats.Stats(profile))
        else:
            out = original(self, X, indices)
            applies.append(((time.perf_counter() - t0) * 1e3, self.upload_bytes, X.shape))
        if before is not None:
            regenerated = {c for off, n in self._slots for c in range(off, off + n)}
            others = [c for c in range(X.shape[-1]) if c not in regenerated]
            assert others and torch.equal(out[..., others], before[..., others])
            assert not torch.equal(out[..., sorted(regenerated)], before[..., sorted(regenerated)])
        return out

    with patched(HybridHostAugment, "apply", apply):
        yield


def host_profile_text(stats, top=8):
    """The ``top`` functions of a cProfile run by their own time: ms, calls
    and where (file:line function, the file by its last two parts)."""
    entries = sorted(stats.stats.items(), key=lambda item: -item[1][2])[:top]
    total = sum(tt for _, _, tt, _, _ in stats.stats.values())
    return f"{total * 1e3:.2f} ms in all; " + "; ".join(
        f"{'/'.join(file.split(os.sep)[-2:])}:{line} {name} {tt * 1e3:.2f} ms ({nc} calls)"
        for (file, line, name), (_, nc, tt, _, _) in entries)


def dwi_phase(card, seed, root, tmp, drop_contours):
    """dmri_hippo's DWI augmentation modes on phase 11's dataset with a full
    DWI series per subject: run.py augmentation_experiment
    --augmentation-mode combined on the default path and with
    --tpu-fast-path (the hybrid device cache), then run.py debug."""
    t0 = time.perf_counter()
    series = write_full_dwi(root, seed + 41)
    print(f"qsm-dwi: full_dwi of {len(DWI_BVALS)} volumes ({series} bytes) and its gradient "
          f"table written for {sum(HIPPO_SUBJECTS.values())} subjects in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with cli_contexts(drop_contours):
        for fast in (False, True):
            applies, profiles = [], []
            logs = os.path.join(tmp, f"dwi-combined{'-fast' if fast else ''}")
            args = cli_run_module.build_parser().parse_args(
                ["augmentation_experiment", root, logs, "--augmentation-mode", "combined",
                 "--max-iterations", str(DWI_ITERATIONS), "--num-workers", str(TRAINER_WORKERS)]
                + (["--tpu-fast-path"] if fast else []))
            with hybrid_watch(applies, profiles):
                _, wall, _, counts = cli_run({}, lambda: args.func(args))
            label = "run.py augmentation_experiment combined" + (" --tpu-fast-path" if fast
                                                                  else "")
            cli_train_checks(card, label, logs, wall, counts, DWI_ITERATIONS)
            # one batch per iteration and the one prefetched after the last
            assert len(applies) + len(profiles) == (DWI_ITERATIONS + 1 if fast else 0)
            if fast:
                ms = [a[0] for a in applies]
                x_bytes = int(np.prod(applies[0][2])) * 4
                print(f"qsm-dwi hybrid: HybridHostAugment.apply median {statistics.median(ms):.2f}"
                      f" ms on the host ({len(ms)} calls: " + ", ".join(f"{m:.1f}" for m in ms)
                      + f"); uploaded {applies[0][1]} bytes per batch (the regenerated mean_dwi "
                      f"channel; the batch's X is {x_bytes} bytes); the other cached channels "
                      f"unchanged by the splice [{card}]", flush=True)
                print(f"qsm-dwi hybrid: call {PROFILED_APPLY} of HybridHostAugment.apply under "
                      f"cProfile, by own time: {host_profile_text(profiles[0])}", flush=True)
        logs = os.path.join(tmp, "dwi-debug")
        args = cli_run_module.build_parser().parse_args(
            ["debug", root, logs, "--max-iterations", str(DEBUG_ITERATIONS)])
        _, wall, _, counts = cli_run({}, lambda: args.func(args))
    # batch 1 (2 half-volumes) per iteration, and the validation sweep at
    # iteration 0 over the 8 validation subjects at batch 1
    validation = HIPPO_SUBJECTS["validation"] + HIPPO_SUBJECTS["ab300"]
    expected = expected_train_launches(torch.float32, DEBUG_ITERATIONS, 2)
    expected["fwd"] = expected["fwd"] + expected_launches(torch.float32, validation, 2)
    assert counts == expected, counts
    [run_dir] = [os.path.join(logs, d) for d in os.listdir(logs)]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["iteration"] for r in records] == list(range(DEBUG_ITERATIONS))
    assert all(np.isfinite(r["loss"]) for r in records)
    print(f"cli run.py debug (combined, batch 1): {DEBUG_ITERATIONS} iterations in {wall:.3f} s "
          f"({DEBUG_ITERATIONS / wall:.3f} iterations/s over the CLI call, the iteration-0 sweep "
          f"of {validation} subjects at batch 1 included); launches per iteration forward "
          f"{CONVS_PER_FORWARD}, dX {DX_PER_STEP}, dW {CONVS_PER_FORWARD} at N=2, "
          f"{CONVS_PER_FORWARD * validation} forward in the sweep [{card}]", flush=True)


def qsm_dwi_phase(card, seed, root, tmp, drop_contours, device):
    """Phase 14: the qsm kernel classes, qsm's reference and recipe trainers,
    the accumulation and card-against-CPU checks, then the DWI modes.
    Returns the kernel rows with their launches per micro-step."""
    t0 = time.perf_counter()
    rows = qsm_kernel_phase(device, seed + 51, card)
    print(f"qsm-dwi kernels: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    qsm_root = os.path.join(tmp, "qsm")
    t1 = time.perf_counter()
    write_qsm_dataset(qsm_root, seed + 52)
    print(f"qsm-dwi: qsm dataset of {2 + len(QSM_TRAINING)} subjects on "
          f"{'x'.join(map(str, QSM_GRID))} written in {time.perf_counter() - t1:.1f} s",
          flush=True)
    launches = {}
    for recipe in (False, True):
        per_step = qsm_trainer_run(card, qsm_root, os.path.join(tmp, f"qsm-logs-{recipe}"),
                                   recipe, drop_contours)
        for kind, c in per_step.items():
            launches.setdefault(kind, Counter()).update(c)
    for row in rows:
        row["launches"] = launches[row["_kind"]][row["_key"]]
        assert row["launches"] > 0, row["name"]
    qsm_accumulation_check(card, seed + 53)
    qsm_cpu_comparison(card, seed + 54)
    shutil.rmtree(qsm_root)
    dwi_phase(card, seed, root, tmp, drop_contours)
    step_totals("per qsm reference micro-step (N=4 f32)", [r for r in rows if r["_key"][1] == 4],
                lambda row: row["launches"], card)
    step_totals("per qsm recipe micro-step (N=2 bf16)", [r for r in rows if r["_key"][1] == 2],
                lambda row: row["launches"], card)
    print(f"qsm-dwi phase: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return rows


# Phase 15, cascade-cleanup: the dmri_hippo cascade (configs/cascade.py
# through run.py cascade_experiment), the fused device cleanup of msseg2's
# competition path and the trainer's device-reduced validation sweeps.
CASCADE_ITERATIONS = 6
CASCADE_OUT = 4  # C^2: the transition matrix of the two classes
# the cascade's NestedResUNet: dmri_hippo's classes, the out conv 40 -> 4
CASCADE_CONV_CLASSES = [(spatial, cin, CASCADE_OUT if cout == OUT_CHANNELS else cout, n)
                        for spatial, cin, cout, n in CONV_CLASSES]
CASCADE_TIMING = MS_TRAIN_TIMING
# msseg2 subjects in model geometry for the fused cleanup: 12 patches of 96^3
# each (2 x 3 x 2)
FUSED_GRID = (144, 192, 144)
FUSED_SEMI_AXES_MM = (60.0, 80.0, 75.0)
FUSED_SUBJECTS = 2
CLEANUP_TRIALS = 3
# the device-reduced sweeps: validation every iteration, 0 the probe
SWEEP_ITERATIONS = 4
HOST_SWEEP_ITERATIONS = 2
INSTANCE_CAPACITY = 255


def cascade_module(root, predictions, model_type):
    """The cascade configuration's network (on the CPU, its own init)."""
    context = cascade_config.get_context(
        device="cpu", variables={"DATASET_PATH": root, "PREDICTIONS_PATH": predictions},
        model_type=model_type)
    definition = context.get_component_definition("model")
    return definition["constructor"](**definition["params"])


def forward_classes(module, n, device):
    """The conv classes of one eval forward of ``module`` at batch ``n`` of
    the split crop: [((W, H, D), Cin, Cout, launches)]; the launches are
    left out of the counts."""
    module = module.to(device).eval()
    x = torch.zeros((n, CROP[0] // 2, *CROP[1:], IN_CHANNELS), device=device)
    with uncounted(), torch.no_grad():
        reset_launch_counts()
        module(x)
        counts = Counter(conv3x3_s1p1.launches_by_shape)
    return sorted(((W, H, D), cin, cout, m) for (_, _, W, H, D, cin, cout), m in counts.items())


def cascade_kernel_rows(device, seed, card, classes):
    """The forward, dX and dW at ``classes`` at the training batch: held
    against their plain versions in both types (bit for bit on integers),
    timed in float32, the type the cascade trains in (the kernels line's
    rows)."""
    batch = 2 * SUBJECTS_PER_REQUEST
    rows = (kernel_phase(device, batch, seed, card, classes, (torch.float32,), CASCADE_TIMING)
            + grad_kernel_phase(device, batch, seed + 1, card, classes, IN_CHANNELS,
                                (torch.float32,), CASCADE_TIMING))
    kernel_phase(device, batch, seed + 2, card, classes, (torch.bfloat16,), None)
    grad_kernel_phase(device, batch, seed + 3, card, classes, IN_CHANNELS, (torch.bfloat16,),
                      None)
    return rows


def cascade_cli_run(card, root, predictions, tmp, model_type, iterations, drop_contours):
    """run.py cascade_experiment on the card: its context, logs, wall
    seconds, launch counts and peak device memory."""
    logs = os.path.join(tmp, f"cascade-{model_type or 'nested'}")
    argv = ["cascade_experiment", root, predictions, logs, "--max-iterations", str(iterations),
            "--num-workers", str(TRAINER_WORKERS)]
    if model_type:
        argv += ["--model-type", model_type]
    args = cli_run_module.build_parser().parse_args(argv)
    contexts = []

    def capture(*a, original=cascade_config.get_context, **k):
        contexts.append(original(*a, **k))
        return contexts[-1]

    torch.cuda.reset_peak_memory_stats()
    with cli_contexts(drop_contours), patched(cascade_config, "get_context", capture):
        _, wall, _, counts = cli_run({}, lambda: args.func(args))
    return contexts[0], logs, wall, counts, torch.cuda.max_memory_allocated()


def cascade_batch(context, n=SUBJECTS_PER_REQUEST):
    """A channel-first training batch of the cascade context (its training
    pipeline), the prior beside X and y."""
    dataset = context.dataset.get_cohort_dataset("training")
    subjects = [dataset[i] for i in range(n)]
    return {key: np.stack([np.asarray(s[key].data) for s in subjects]).astype(np.float32)
            for key in ("X", "y", "y_prior")}


def cascade_checks(card, context, seed):
    """On the trained cascade: every transition matrix of a served batch is
    column-stochastic and the refined prediction a distribution; one refined
    f32 step on the card against the CPU port; the step's profile."""
    batch_cf = cascade_batch(context)
    with uncounted(), torch.no_grad():
        x = torch.from_numpy(batch_cf["X"]).cuda()
        matrices = context.model(split_and_flip(x))
        columns = matrices.reshape(matrices.shape[0], 2, 2, *matrices.shape[2:]).sum(1)
        refined = apply_stochastic_matrix(
            reverse_split_and_flip(matrices), torch.from_numpy(batch_cf["y_prior"]).cuda())
        torch.cuda.synchronize()
    col_err = (columns - 1).abs().max().item()
    dist_err = (refined.sum(1) - 1).abs().max().item()
    assert col_err <= 1e-5 and dist_err <= 1e-5, (col_err, dist_err)
    print(f"cascade served batch: {columns.numel()} transition-matrix columns sum to 1 within "
          f"{col_err:.3g}, refined probabilities within {dist_err:.3g} [{card}]", flush=True)
    make_module = lambda: NestedResUNet(  # noqa: E731
        IN_CHANNELS, CASCADE_OUT, filters=FILTERS, hypothesis_class=tsp.StochasticMatrix,
        hypothesis_params={"channels": OUT_CHANNELS})
    model = SegModel(make_module(), device="cpu", seed=seed)
    model.ensure_initialized()
    state_dict = {k: v.clone() for k, v in model.module.state_dict().items()}
    cpu_train_comparison(
        card, "cascade refined train f32 vs CPU port (first subject, dropout 0)", make_module,
        lambda: SGD(lr=0.01, momentum=0.95), HybridLogisticDiceLoss(), state_dict,
        {k: v[:1] for k, v in batch_cf.items()}, sagittal_split=True, refine_image="y_prior")
    with uncounted():
        model = SegModel(make_module(), device="cuda", seed=seed)
        optimizer = SGD(lr=0.01, momentum=0.95)
        state = create_train_state(model, optimizer, batch_cf)
        step = make_train_step(model.module, HybridLogisticDiceLoss(), optimizer,
                               sagittal_split=True, refine_image="y_prior")
        batch = collate_to_device(batch_cf, device="cuda")
        for _ in range(WARMUP_STEPS):
            state, _, _ = step(state, batch, None)
        profile_train_step(step, state, batch, None, "cascade f32", card)


def cascade_part(card, seed, root, tmp, drop_contours, device):
    """(a) The cascade: its new kernel classes, run.py cascade_experiment
    (NestedResUNet, then one iteration of basic_unet) with launches, rates,
    the sweep, peak memory; the checks. Returns the kernel rows."""
    predictions = os.path.join(tmp, "cascade-predictions")
    write_priors(root, predictions, seed + 61)
    known = {(spatial, cin, cout) for spatial, cin, cout, _ in CONV_CLASSES}
    nested_classes = [c for c in CASCADE_CONV_CLASSES if c[:3] not in known]
    basic_classes = forward_classes(cascade_module(root, predictions, "basic_unet"),
                                    2 * SUBJECTS_PER_REQUEST, device)
    basic_new = [c for c in basic_classes if c[:3] not in known | {x[:3] for x in nested_classes}]
    basic_convs = sum(c[3] for c in basic_classes)
    basic_dx = sum(c[3] for c in basic_classes if c[1] != IN_CHANNELS)
    print(f"cascade classes: NestedResUNet adds {nested_classes}; basic_unet ModularUNet(3 -> 4, "
          f"[40, 80, 120], depth 3) runs {basic_convs} hand convs per forward at "
          f"{len(basic_classes)} classes, {len(basic_new)} new: {basic_new}", flush=True)
    rows = cascade_kernel_rows(device, seed + 62, card, nested_classes + basic_new)

    context, logs, wall, counts, peak = cascade_cli_run(
        card, root, predictions, tmp, None, CASCADE_ITERATIONS, drop_contours)
    cli_train_checks(card, "run.py cascade_experiment", logs, wall, counts, CASCADE_ITERATIONS)
    out_key = (str(torch.float32), 2 * SUBJECTS_PER_REQUEST, CROP[0] // 2, *CROP[1:])
    assert counts["fwd"][(*out_key, FILTERS, CASCADE_OUT)] == CASCADE_ITERATIONS, counts["fwd"]
    assert counts["dx"][(*out_key, CASCADE_OUT, FILTERS)] == CASCADE_ITERATIONS, counts["dx"]
    assert counts["dw"][(*out_key, FILTERS, CASCADE_OUT)] == CASCADE_ITERATIONS, counts["dw"]
    sweeps = context.trainer.sweep_times
    print(f"cascade: the 40->4 out conv in every iteration (forward, dX and dW once each); "
          f"validation sweeps {[(i, round(t * 1e3, 3)) for i, _, t in sweeps]} ms (iteration, "
          f"ms; refined predictions of the validation cohorts); peak memory "
          f"{peak / 2 ** 30:.2f} GiB [{card}]", flush=True)
    launches = {kind: Counter(c) for kind, c in counts.items()}
    cascade_checks(card, context, seed + 63)

    basic, logs, wall, basic_counts, peak = cascade_cli_run(
        card, root, predictions, tmp, "basic_unet", 1, drop_contours)
    cli_train_checks(card, "run.py cascade_experiment --model-type basic_unet", logs, wall,
                     basic_counts, 1, convs=basic_convs, dx=basic_dx)
    assert type(basic.model.module).__name__ == "ModularUNet"
    print(f"cascade basic_unet: peak memory {peak / 2 ** 30:.2f} GiB [{card}]", flush=True)
    for kind, c in basic_counts.items():
        launches[kind].update(c)
    for row in rows:
        row["launches"] = launches[row["_kind"]][row["_key"]]
        assert row["launches"] > 0, row["name"]
    # the out conv's forward, dX and dW run once per step
    step_totals("per cascade train step (the 40->4 out conv's classes)",
                [r for r in rows if CASCADE_OUT in r["_key"][5:]], lambda row: 1, card)
    return rows


class ServingSet:
    """What ms_inference's inference() reads of a dataset: the transformed
    subjects by index, the raw ones as ``subjects``."""

    def __init__(self, raws, transform):
        self.subjects, self.transform = raws, transform

    def __len__(self):
        return len(self.subjects)

    def __getitem__(self, i):
        return self.transform(copy.deepcopy(self.subjects[i]))


def fused_serving_set(seed, folder):
    """FUSED_SUBJECTS raw msseg2 subjects in model geometry, whose tape
    (the FLAIRs concatenated into X) lets the cleanup run fused."""
    rng = np.random.default_rng(seed)
    raws = []
    for i in range(FUSED_SUBJECTS):
        volumes, affine = msseg2_volumes(rng, FUSED_GRID, MS_RAW_SPACING, FUSED_SEMI_AXES_MM)
        raw = msseg2_subject(tsp, volumes, affine, f"fused-{i}")
        raw["folder"] = os.path.join(folder, f"fused-{i}")
        raws.append(raw)
    transform = tsp.Compose([tsp.ConcatenateImages(image_names=list(MS_TIMEPOINTS),
                                                   image_channels=[1, 1], new_image_name="X")])
    return ServingSet(raws, transform)


def median_ms(fn, trials=CLEANUP_TRIALS):
    times = []
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def cleanup_on_host(ids):
    """ms_inference's CLEANUP_CHAIN on the host (the port's post_processing,
    native labeller)."""
    out = ids.astype(np.int32)
    for op, arg in cli_ms_inference.CLEANUP_CHAIN:
        out, _ = cli_ms_inference.CLEANUPS[op](out, arg)
    return out


def cleanup_timing(card, label, ids):
    """The fused cleanup of ``ids`` (W, H, D) on the card against the host
    chain on the same ids: equal voxel for voxel; ms of each (medians of
    CLEANUP_TRIALS), the CC sweeps of one device call."""
    from segmentation_pipeline_torch.ops.morphology import (apply_device_postprocess,
                                                            connected_components_device)

    chain = cli_ms_inference.CLEANUP_CHAIN
    ids_dev = torch.from_numpy(ids.astype(np.uint8)).cuda()
    before = connected_components_device.sweeps
    out = apply_device_postprocess(ids_dev, chain, 2).cpu().numpy()
    sweeps = connected_components_device.sweeps - before
    host = cleanup_on_host(ids)
    assert np.array_equal(out, host), label
    device_ms = median_ms(lambda: apply_device_postprocess(ids_dev, chain, 2))
    host_ms = median_ms(lambda: cleanup_on_host(ids))
    print(f"fused cleanup {label} ({'x'.join(map(str, ids.shape))}, {int(ids.sum())} foreground "
          f"voxels, {int((host != ids).sum())} changed): equal to the host chain; device "
          f"{device_ms:.3f} ms ({sweeps} CC sweeps per call), host {host_ms:.3f} ms [{card}]",
          flush=True)


def fused_cleanup_part(card, seed, ms_root, tmp):
    """(b) ms_inference's inference() with device_postprocess on msseg2
    subjects whose tape lets the cleanup run fused (phase 13's msseg2
    checkpoint): the fused path taken, 34 forward launches per patch, the
    masks equal to the host chain's on the same argmax voxel for voxel;
    device against host cleanup ms with the CC sweeps per call; then the CLI
    main with --device-postprocess on msseg2's dataset and the path each
    subject took."""
    [run_dir] = [os.path.join(tmp, "cli-msseg2", d) for d in os.listdir(
        os.path.join(tmp, "cli-msseg2"))]
    checkpoint = os.path.join(run_dir, "checkpoints", f"msseg2-iter{CLI_ITERATIONS:08}.ckpt")
    model = cli_ms_inference.load_contexts(checkpoint, ms_root)[0].model
    serving = fused_serving_set(seed, os.path.join(tmp, "fused"))
    assert all(cli_ms_inference._fused_cleanup_is_exact(serving[i]) for i in range(len(serving)))
    patches = len(grid_locations(FUSED_GRID, (MS_PATCH,) * 3, (MS_PATCH // 2,) * 3))
    paths = []
    _, wall, spent, counts = cli_run({"device": (PatchPredict, "predict")}, lambda: paths.extend(
        cli_ms_inference.inference(serving, model, "", "fused.nii.gz", device_postprocess=True)))
    assert [p for _, p in paths] == ["fused"] * FUSED_SUBJECTS, paths
    forwards = MS_CONVS_PER_FORWARD * patches * FUSED_SUBJECTS
    assert counts["fwd"].total() == forwards and not counts["dx"] and not counts["dw"], counts
    print(f"fused cleanup: inference(device_postprocess=True) paths {paths}; {patches} patches "
          f"of 96^3 per subject, {MS_CONVS_PER_FORWARD} forward launches each "
          f"({forwards} in all); {wall / FUSED_SUBJECTS:.3f} s per subject of "
          f"{'x'.join(map(str, FUSED_GRID))}, predictor with the fused cleanup "
          f"{spent['device'] / FUSED_SUBJECTS:.3f} s [{card}]", flush=True)
    with uncounted():
        host_paths = cli_ms_inference.inference(serving, model, "", "host.nii.gz",
                                                device_argmax=True)
        assert [p for _, p in host_paths] == ["host"] * FUSED_SUBJECTS
        for i, raw in enumerate(serving.subjects):
            fused, _ = read_nifti(os.path.join(raw["folder"], "fused.nii.gz"))
            host, _ = read_nifti(os.path.join(raw["folder"], "host.nii.gz"))
            assert fused.shape == (1, *FUSED_GRID) and np.array_equal(fused, host), raw["name"]
            [s], _ = competition_predictor(True).predict(model, [serving[i]])
            cleanup_timing(card, f"{raw['name']} (the model's argmax)",
                           np.argmax(np.asarray(s["y_pred"].data), axis=0))
            # lesions and specks: the thresholded second FLAIR
            flair = np.asarray(raw["flair_time02"].data)[0]
            cleanup_timing(card, f"{raw['name']} (thresholded FLAIR)",
                           (flair > np.quantile(flair, 0.97)).astype(np.uint8))
    print(f"fused cleanup: the masks of the fused path equal the host chain's on the same "
          f"argmax, voxel for voxel, for {FUSED_SUBJECTS} subjects [{card}]", flush=True)
    recorded = []

    def recording(*args, original=cli_ms_inference.inference, **kwargs):
        recorded.extend(original(*args, **kwargs))
        return recorded

    with patched(cli_ms_inference, "inference", recording):
        cli_ms_inference.main([checkpoint, ms_root, "mask.nii.gz", "--cohort", "validation",
                               "--out-folder", os.path.join(tmp, "cli-device-postprocess"),
                               "--device-postprocess"])
    assert recorded, "ms_inference --device-postprocess served no subject"
    print(f"cli ms_inference --device-postprocess on msseg2's dataset: paths {recorded} (its "
          f"default pipeline resamples and crops, so the host cleanup) [{card}]", flush=True)


def sweep_context(root, device_confusion):
    """dmri_hippo's configuration with a device_argmax validation predictor
    and a sweep every iteration that only needs counts: the Segmentation
    and an InstanceSegmentation evaluator on cbbrain_validation."""
    context = hippo_config.get_context(variables={"DATASET_PATH": root})
    params = context.get_component_definition("trainer")["params"]
    context.update_component(
        "trainer", training_evaluators=[], device_confusion=device_confusion,
        validation_predictor=StandardPredict(sagittal_split=True, image_names=["X"],
                                             device_argmax=True),
        validation_evaluators=[
            tsp.ScheduledEvaluation(tsp.SegmentationEvaluator("y_pred_eval", "y_eval"),
                                    "segmentation_eval", cohorts=["cbbrain_validation"]),
            tsp.ScheduledEvaluation(tsp.InstanceSegmentationEvaluator("y_pred_eval", "y_eval"),
                                    "instance_eval", cohorts=["cbbrain_validation"])],
        save_rate=10 ** 6)
    assert params["scoring_function"] is hippo_config.cbbrain_dice_score
    context.init_components()
    return context


def instance_histogram_check(card, seed):
    """overlap_histogram_device on msseg2-size lesion masks against the host
    instance chain, exactly, and a capacity it overflows."""
    from segmentation_pipeline_torch.evaluators import connected_components, overlap_histogram
    from segmentation_pipeline_torch.ops.instance import (component_count,
                                                          overlap_histogram_device)

    rng = np.random.default_rng(seed)
    volumes, _ = msseg2_volumes(rng, FUSED_GRID, MS_RAW_SPACING, FUSED_SEMI_AXES_MM)
    target = volumes["ground_truth"][0] > 0
    pred = (target & (rng.random(FUSED_GRID) < 0.8)) | (rng.random(FUSED_GRID) < 2e-5)

    def host_chain():
        tc, n = connected_components(target, 2)
        pc, m = connected_components(pred, 2)
        return overlap_histogram(tc, pc, n, m), n, m

    host, N, M = host_chain()
    t_dev, p_dev = torch.from_numpy(target).cuda(), torch.from_numpy(pred).cuda()
    for capacity in (INSTANCE_CAPACITY, 3):
        hist, t_uniq, p_uniq = overlap_histogram_device(t_dev, p_dev, capacity, 2)
        (n_t, ov_t), (n_p, ov_p) = component_count(t_uniq.cpu()), component_count(p_uniq.cpu())
        if capacity == INSTANCE_CAPACITY:
            assert not ov_t and not ov_p and (n_t, n_p) == (N, M)
            assert np.array_equal(hist.cpu().numpy()[:N + 1, :M + 1], host)
        else:
            assert ov_p and (ov_t or N <= 3), (N, M)
    device_ms = median_ms(lambda: overlap_histogram_device(t_dev, p_dev, INSTANCE_CAPACITY, 2))
    host_ms = median_ms(host_chain)
    print(f"instance histogram on {'x'.join(map(str, FUSED_GRID))} lesion masks ({N} target, "
          f"{M} predicted components): equal to the host chain entry for entry; capacity 3 "
          f"flags its overflow; device {device_ms:.3f} ms, host {host_ms:.3f} ms [{card}]",
          flush=True)


def sweep_part(card, seed, root):
    """(c) The dmri_hippo trainer with a device_argmax validation predictor:
    the manager from probe to on (the probe holds the device counts to the
    host chain's exactly), each sweep's ms by state beside a host-path run's,
    the bytes fetched per subject; the instance histogram check."""
    times = {}
    for device_confusion, iterations in ((None, SWEEP_ITERATIONS),
                                         (False, HOST_SWEEP_ITERATIONS)):
        context = sweep_context(root, device_confusion)
        context.trainer.train(context, max_iterations=iterations, num_workers=TRAINER_WORKERS,
                              validation_batch_size=VALIDATION_BATCH, logger=MemoryLogger())
        for _, state, seconds in context.trainer.sweep_times:
            times.setdefault(state, []).append(round(seconds * 1e3, 3))
        if device_confusion is None:
            mgr = context.trainer._confusion_mgr
            assert mgr.state == "on" and mgr._validated == {"confusion", ("instance", 2)}
            per_subject = mgr.bytes_fetched / mgr.subjects_delivered
    assert len(times["probe"]) == 1 and len(times["on"]) == SWEEP_ITERATIONS - 1
    print(f"device sweeps (dmri_hippo, {HIPPO_SUBJECTS['validation']} cbbrain_validation "
          f"subjects, Segmentation + InstanceSegmentation evaluators): manager probe -> on; "
          f"sweep ms probe {times['probe']}, on {times['on']}, host path {times['host']}; "
          f"{per_subject:.0f} bytes fetched per subject in the device reductions [{card}]",
          flush=True)
    instance_histogram_check(card, seed)


def cascade_cleanup_phase(card, seed, root, ms_root, tmp, drop_contours, device):
    """Phase 15: the cascade, the fused cleanup and the device sweep
    reductions. Returns the new kernel rows with their launches."""
    t0 = time.perf_counter()
    rows = cascade_part(card, seed, root, tmp, drop_contours, device)
    t1 = time.perf_counter()
    fused_cleanup_part(card, seed + 64, ms_root, tmp)
    t2 = time.perf_counter()
    sweep_part(card, seed + 65, root)
    print(f"cascade-cleanup phase: {time.perf_counter() - t0:.1f} s (cascade {t1 - t0:.1f}, "
          f"fused cleanup {t2 - t1:.1f}, sweeps {time.perf_counter() - t2:.1f}) [{card}]",
          flush=True)
    return rows


# Phase 16, mesh: the data-parallel mesh (parallel/mesh.py) on one card. NCCL
# refuses two ranks on one device, so the mesh runs at world size 2 as two
# processes on the card joined by gloo, which carries the CUDA tensors, and
# at world size 1 under NCCL in this process; each against one process
# without a mesh.
MESH_WORLD = 2
MESH_BATCH = 2 * SUBJECTS_PER_REQUEST  # the global train batch: 4 subjects a rank
MESH_STEPS = 3
MESH_TIMEOUT_S = 150
MESH_NCCL_BACKEND = "nccl"
# f32: the global batch's sums in another order; bf16: the same, rounded to
# bfloat16 after each layer (its epsilon is 2**-8)
MESH_LOSS_RTOL = {torch.float32: 1e-4, torch.bfloat16: 4e-3}
MESH_PARAM_TOL = 1e-4
# The float32 noise of the one process: the one process again with one of
# its inputs moved by one rounding (every value of the batch or of the
# weights times 1 + 2**-23 or 1 - 2**-23). Adam's first steps move each
# weight by about lr times the sign of its gradient, so weights whose
# gradient is below that noise move either way. A mesh run's f32 gradient
# and update after each step are held to MESH_PARAM_TOL or, where one of
# these nudges moves the one process farther, to the farthest nudge.
MESH_NUDGES = (("X", 1 + 2 ** -23), ("X", 1 - 2 ** -23), ("weights", 1 + 2 ** -23),
               ("weights", 1 - 2 ** -23))
MESH_PROB_TOL = 1e-5


def mesh_inputs(seed, root, tmp):
    """What every world runs on, made once here: the dmri_hippo weights and
    train batch, a checkpoint of the ported configuration at random weights,
    and one msseg2 subject in model space (a raw 256x256x144 subject
    through the default pipeline)."""
    rng = np.random.default_rng(seed + 40)
    state = {k: v.numpy() for k, v in flax_to_state_dict(flax_weights(rng)).items()}
    batch_cf = train_batch(rng, MESH_BATCH)
    ensemble = os.path.join(tmp, "mesh-fold")
    os.makedirs(ensemble)
    context = hippo_config.get_context(variables={"DATASET_PATH": root})
    context.init_components()
    context.model.load_state_dict(flax_to_state_dict(flax_weights(rng)))
    context.save(os.path.join(ensemble, "fold0.ckpt"))
    raw = msseg2_subject(tsp, *msseg2_volumes(rng, MS_RAW_GRID, MS_RAW_SPACING,
                                              MS_SEMI_AXES_MM), "ms-mesh")
    subject = msseg2_config.build_pipelines(MS_PATCH)["default"](raw)
    return dict(seed=seed, state=state, batch=batch_cf, ensemble=ensemble, root=root,
                ms_x=np.asarray(subject["X"].data), ms_affine=subject["X"].affine)


def mesh_steps(mesh, inputs, dtype, batch_cf, weights=None):
    """MESH_STEPS dmri_hippo train steps on ``mesh`` (None: one process)
    from ``weights`` (default: the inputs') and the inputs' seed on
    ``batch_cf`` (on a mesh, this rank's rows of it), with 25/23/25
    launches a step asserted: the losses, the ms a step, the launches a
    step, and after each step the gradient, the weights and the update
    (the weights less the first ones), flat (float32 on the host)."""
    n = MESH_BATCH // (1 if mesh is None else mesh.size)  # this process's subjects
    model = SegModel(NestedResUNet(IN_CHANNELS, OUT_CHANNELS, filters=FILTERS,
                                   dropout_p=0.2), device="cuda")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in (weights or inputs["state"]).items()})
    optimizer = Adam(lr=2e-4)
    state = create_train_state(model, optimizer, batch_cf)
    step = make_train_step(model.module, HybridLogisticDiceLoss(), optimizer, mesh=mesh,
                           sagittal_split=True,
                           compute_dtype=None if dtype == torch.float32 else "bfloat16")
    batch = collate_to_device(batch_cf, device="cuda", mesh=mesh)
    generator = torch.Generator(device="cuda").manual_seed(inputs["seed"])
    params = list(model.module.parameters())
    first = torch.cat([p.detach().reshape(-1) for p in params]).cpu().numpy()
    reset_launch_counts()
    times, losses, grads, weights = [], [], [], []
    for _ in range(MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss_dict, y_pred = step(state, batch, generator)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss_dict["loss"].item())
        with uncounted():
            grads.append(torch.cat([p.grad.reshape(-1) for p in params]).cpu().numpy())
            weights.append(torch.cat([p.detach().reshape(-1) for p in params]).cpu().numpy())
    counts = launch_counts()
    assert counts == expected_train_launches(dtype, MESH_STEPS, 2 * n), counts
    assert tuple(y_pred.shape) == (n, *CROP, OUT_CHANNELS)
    return dict(losses=losses, ms=times, grads=grads, weights=weights,
                updates=[w - first for w in weights], launches=[
                    counts[kind].total() // MESH_STEPS for kind in ("fwd", "dx", "dw")])


def nudged_steps(inputs, what, factor):
    """The one process's f32 steps with every value of the batch's X or of
    the weights times ``factor``."""
    if what == "X":
        batch = dict(inputs["batch"], X=inputs["batch"]["X"] * np.float32(factor))
        return mesh_steps(None, inputs, torch.float32, batch)
    weights = {k: v * v.dtype.type(factor) if v.dtype.kind == "f" else v
               for k, v in inputs["state"].items()}
    return mesh_steps(None, inputs, torch.float32, inputs["batch"], weights)


def mesh_paths(mesh, inputs, out):
    """The three paths on ``mesh`` (None: one process, no mesh), with this
    process's kernel launches asserted on each: (a) dmri_hippo's train step
    (``mesh_steps``) in f32 and bf16, (b) hippo_inference --ensemble-flips
    --batched-tta [--tta-mesh] on one fold into ``out`` (rank 0 writes),
    (c) the msseg2 competition predictor's request (probabilities) on the
    model-space subject, one untimed and one timed. Returns the steps'
    results, the probabilities, the times and each path's seconds."""
    world = 1 if mesh is None else mesh.size
    if mesh is not None:
        # the trainer's stop vote, on the host (under NCCL over a gloo group
        # of the same ranks)
        assert not any_rank(False, mesh) and any_rank(True, mesh)
    marks = [time.perf_counter()]
    result = {f"step {DTYPE_NAMES[dtype]}": mesh_steps(mesh, inputs, dtype, inputs["batch"])
              for dtype in DTYPES}
    os.makedirs(out, exist_ok=True)
    reset_launch_counts()
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    cli_hippo.main(inputs["ensemble"], inputs["root"], "cli", out_folder=out,
                   ensemble_flips=True, batched_tta=True, tta_mesh=mesh is not None,
                   cohort=CLI_HIPPO_COHORT)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    result["hippo_ms"] = (marks[-1] - marks[-2]) * 1e3
    assert launch_counts()["fwd"] == expected_launches(torch.float32, 1, TTA_BATCH // world)
    model = msseg2_model(inputs["seed"], "cuda")
    predictor = competition_predictor()
    predictor.mesh = mesh
    subject = Subject({"X": ScalarImage(tensor=inputs["ms_x"], affine=inputs["ms_affine"])})
    locations = len(grid_locations(inputs["ms_x"].shape[1:], (MS_PATCH,) * 3,
                                   (MS_PATCH // 2,) * 3))
    for call in ("untimed", "timed"):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        [served], _ = predictor.predict(model, [copy.deepcopy(subject)])
        torch.cuda.synchronize()
        result["ms_ms"] = (time.perf_counter() - t0) * 1e3
        assert conv3x3_s1p1.launches == -(-locations // world) * MS_CONVS_PER_FORWARD, \
            conv3x3_s1p1.launches
    result["ms_launches"] = conv3x3_s1p1.launches
    result["probabilities"] = np.asarray(served["y_pred"].data)
    marks.append(time.perf_counter())
    result["parts_s"] = [b - a for a, b in zip(marks, marks[1:])]
    return result


def mesh_rank(folder):
    """One rank of the gloo world (``--mesh-rank``), in a process that the
    port's launcher started and joined to the group: run the paths on the
    mesh over the group on the inputs in ``folder``, and leave the result
    (or the traceback) there."""
    stamps = [time.time()]  # joined, ready, ran the paths
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = torch.distributed.get_rank()
    try:
        build.build(conv3x3.SOURCES)
        mesh = tsp.make_mesh()
        with open(os.path.join(folder, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        stamps.append(time.time())
        result = mesh_paths(mesh, inputs, os.path.join(folder, "hippo"))
        stamps.append(time.time())
        result.update(stamps=stamps, threads=torch.get_num_threads())
        with open(os.path.join(folder, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(folder, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    return 0


def gloo_world(inputs, folder, world=MESH_WORLD):
    """``world`` ranks on the card, started by the port's launcher
    (``launch_multihost.launch_local``: spawned, joined through a
    rendezvous file, each on its LOCAL_RANK's card, the host's cores
    shared), each running this script with ``--mesh-rank``; joined before
    this returns, their results in rank order. A rank that fails or
    outlives MESH_TIMEOUT_S fails the phase. The inputs go through a file:
    spawn's arguments pass through a pipe that the child reads only after
    its imports, so large arguments would start the ranks one after the
    other."""
    os.makedirs(folder)
    with open(os.path.join(folder, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    try:
        launch_multihost.launch_local(world, "gloo", MESH_TIMEOUT_S, "chip_smoke",
                                      ["--mesh-rank", folder], join_timeout=MESH_TIMEOUT_S)
    except SystemExit as failed:
        errors = [os.path.join(folder, f"rank{r}.err") for r in range(world)]
        raise AssertionError("\n".join([str(failed)] + [open(e).read() for e in errors
                                                        if os.path.exists(e)])) from None
    results = []
    for r in range(world):
        with open(os.path.join(folder, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def nccl_world(inputs, folder):
    """World size 1 under NCCL in this process (NCCL refuses a second rank
    on the same card)."""
    torch.distributed.init_process_group(
        MESH_NCCL_BACKEND, init_method=f"file://{os.path.join(folder, 'rendezvous')}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        return mesh_paths(tsp.make_mesh(), inputs, os.path.join(folder, "hippo"))
    finally:
        torch.distributed.destroy_process_group()


def flat_gaps(runs, ref, key):
    """After each step, the largest |run - ref| / |ref| over ``runs`` of the
    flat vectors under ``key`` (the gradient, the weights or the update)."""
    return [max(float(np.linalg.norm(run[key][k].astype(np.float64) - want)
                      / np.linalg.norm(want.astype(np.float64))) for run in runs)
            for k, want in enumerate(ref[key])]


def gap_text(gaps):
    return "/".join(f"{g:.3e}" for g in gaps)


def mesh_checks(card, label, runs, one, floor):
    """Each rank's run of a world against the one process: the losses, the
    f32 gradient and update after each step (beside ``floor``, the farthest
    that a nudge moves the one process from itself), the msseg2
    probabilities and mask; printed, then asserted."""
    loss_gaps = {}
    for dtype in DTYPES:
        key = f"step {DTYPE_NAMES[dtype]}"
        want = np.array(one[key]["losses"])
        loss_gaps[dtype] = max(float(np.max(np.abs(np.array(run[key]["losses"]) - want) / want))
                               for run in runs)
    f32 = [run["step f32"] for run in runs]
    gaps = {key: flat_gaps(f32, one["step f32"], key) for key in ("grads", "updates", "weights")}
    ranks_equal = all(np.array_equal(run["weights"][-1], f32[0]["weights"][-1]) for run in f32)
    prob_gap = max(float(np.abs(run["probabilities"] - one["probabilities"]).max())
                   for run in runs)
    mask_ref = np.argmax(one["probabilities"], 0)
    mask_diff = max(int((np.argmax(run["probabilities"], 0) != mask_ref).sum()) for run in runs)
    print(f"mesh {label}: f32 losses " + ", ".join(
        f"{v:.7f}" for v in runs[0]["step f32"]["losses"]) + " against one process "
        + ", ".join(f"{v:.7f}" for v in one["step f32"]["losses"]) + "; bf16 "
        + ", ".join(f"{v:.6f}" for v in runs[0]["step bf16"]["losses"]) + " against "
        + ", ".join(f"{v:.6f}" for v in one["step bf16"]["losses"])
        + f"; largest relative loss gap f32 {loss_gaps[torch.float32]:.3e}, bf16 "
        f"{loss_gaps[torch.bfloat16]:.3e}; f32 |mesh - one| / |one| after steps 1/2/3: "
        f"gradient {gap_text(gaps['grads'])} (farthest nudge {gap_text(floor['grads'])}), "
        f"update {gap_text(gaps['updates'])} (farthest nudge {gap_text(floor['updates'])}), "
        f"weights {gap_text(gaps['weights'])}; the ranks' weights equal: {ranks_equal}; "
        f"msseg2 probabilities max |mesh - one| {prob_gap:.3e}, mask voxels that differ "
        f"{mask_diff} of {mask_ref.size} [{card}]", flush=True)
    for dtype in DTYPES:
        assert loss_gaps[dtype] <= MESH_LOSS_RTOL[dtype], (label, dtype, loss_gaps[dtype])
        key = f"step {DTYPE_NAMES[dtype]}"
        assert all(run[key]["launches"] == [CONVS_PER_FORWARD, DX_PER_STEP, CONVS_PER_FORWARD]
                   for run in runs), label
    for key in ("grads", "updates"):
        assert all(gap <= max(MESH_PARAM_TOL, low) for gap, low in zip(gaps[key], floor[key])), \
            (label, key, gaps[key], floor[key])
    assert ranks_equal, label
    assert prob_gap <= MESH_PROB_TOL and mask_diff == 0, (label, prob_gap, mask_diff)


def mesh_phase(card, seed, root, tmp):
    """The data-parallel paths at world size 2 (gloo, two processes on the
    card) and 1 (NCCL, this process) against one process without a mesh."""
    t0 = time.perf_counter()
    inputs = mesh_inputs(seed, root, tmp)
    print(f"mesh: inputs made in {time.perf_counter() - t0:.1f} s", flush=True)
    one = mesh_paths(None, inputs, os.path.join(tmp, "mesh-one", "hippo"))
    # how far the one process moves from itself when one input moves by
    # one rounding
    t0 = time.perf_counter()
    nudged = {nudge: nudged_steps(inputs, *nudge) for nudge in MESH_NUDGES}
    floors = {nudge: {key: flat_gaps([run], one["step f32"], key)
                      for key in ("grads", "updates")} for nudge, run in nudged.items()}
    floor = {key: [max(f[key][k] for f in floors.values()) for k in range(MESH_STEPS)]
             for key in ("grads", "updates")}
    nudged_s = time.perf_counter() - t0
    print("mesh: the one process against itself, f32 |nudged - one| / |one| after steps "
          "1/2/3: " + "; ".join(
              f"{what} x (1 {'+' if factor > 1 else '-'} 2**-23): gradient "
              f"{gap_text(f['grads'])}, update {gap_text(f['updates'])}"
              for (what, factor), f in floors.items()) + f" [{card}]", flush=True)
    t0, spawned = time.perf_counter(), time.time()
    gloo = gloo_world(inputs, os.path.join(tmp, "mesh-gloo"))
    gloo_s = time.perf_counter() - t0
    os.makedirs(os.path.join(tmp, "mesh-nccl"))
    nccl = nccl_world(inputs, os.path.join(tmp, "mesh-nccl"))
    mesh_checks(card, f"gloo world {MESH_WORLD}", gloo, one, floor)
    mesh_checks(card, "nccl world 1", [nccl], one, floor)
    names = sorted(n for n in os.listdir(os.path.join(root, "subjects"))
                   if n.startswith("cbbrain"))[:HIPPO_SUBJECTS["validation"]]
    labels = {side: hippo_outputs(os.path.join(tmp, f"mesh-{side}", "hippo"), root, names,
                                  "dmri-hippo") for side in ("one", "gloo", "nccl")}
    for side in ("gloo", "nccl"):
        differ = sum(int((a != b).sum()) for a, b in zip(labels[side], labels["one"]))
        print(f"mesh (b) hippo_inference --tta-mesh {side}: {differ} voxels of "
              f"{len(names)} subjects' labels differ from the one process's [{card}]",
              flush=True)
        assert differ == 0, side
    med = statistics.median
    for dtype in DTYPES:
        key = f"step {DTYPE_NAMES[dtype]}"
        print(f"mesh (a) train step {DTYPE_NAMES[dtype]}, global batch {MESH_BATCH}: one "
              f"process {med(one[key]['ms']):.3f} ms a step; gloo world {MESH_WORLD} "
              + ", ".join(f"rank {r} {med(run[key]['ms']):.3f}" for r, run in enumerate(gloo))
              + f" ms ({MESH_BATCH // MESH_WORLD} subjects a rank, "
              f"{'/'.join(map(str, gloo[0][key]['launches']))} launches a step on each rank); "
              f"nccl world 1 {med(nccl[key]['ms']):.3f} ms (medians of {MESH_STEPS}) "
              f"[{card}]", flush=True)
    print(f"mesh (b) hippo_inference --ensemble-flips --batched-tta, one fold, "
          f"{len(names)} subjects: one process {one['hippo_ms']:.1f} ms; --tta-mesh gloo world "
          f"{MESH_WORLD} " + ", ".join(f"rank {r} {run['hippo_ms']:.1f}"
                                       for r, run in enumerate(gloo))
          + f" ms (one forward of {CONVS_PER_FORWARD} launches at N="
          f"{TTA_BATCH // MESH_WORLD} on each rank); nccl world 1 {nccl['hippo_ms']:.1f} ms "
          f"[{card}]", flush=True)
    print(f"mesh (c) msseg2 PatchPredict request on {'x'.join(map(str, MS_RAW_GRID))} "
          f"({'x'.join(map(str, inputs['ms_x'].shape[1:]))} in model space), f32: one process "
          f"{one['ms_ms']:.1f} ms; gloo world {MESH_WORLD} "
          + ", ".join(f"rank {r} {run['ms_ms']:.1f} ms ({run['ms_launches']} launches)"
                      for r, run in enumerate(gloo))
          + f"; nccl world 1 {nccl['ms_ms']:.1f} ms [{card}]", flush=True)
    parts = " / ".join(f"{v:.1f}" for v in one["parts_s"])
    print(f"mesh: seconds of (a) / (b) / (c): one process {parts}; gloo " + "; ".join(
        f"rank {r} " + " / ".join(f"{v:.1f}" for v in run["parts_s"]) for r, run in
        enumerate(gloo)) + f"; nccl " + " / ".join(f"{v:.1f}" for v in nccl["parts_s"])
        + f"; the nudged f32 steps {nudged_s:.1f}; the gloo world {gloo_s:.1f} from the "
        f"launch to the join (" + "; ".join(
            f"rank {r} joined at {run['stamps'][0] - spawned:.1f}, ready at "
            f"{run['stamps'][1] - spawned:.1f}, done at {run['stamps'][2] - spawned:.1f}, "
            f"{run['threads']} CPU threads" for r, run in enumerate(gloo))
        + f"); both ranks share the one card, so no speed-up is expected [{card}]",
        flush=True)


def descendants(pid=None) -> list:
    """The live processes below ``pid`` (this process by default), read
    from /proc; a zombie has ended and is left out."""
    children = {}
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if state != "Z":
            children.setdefault(int(ppid), []).append(int(entry))
    found, todo = [], [os.getpid() if pid is None else pid]
    while todo:
        below = children.get(todo.pop(), [])
        found += below
        todo += below
    return found


def command_line(pid) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip()[:160]
    except OSError:
        return "?"


def kill_and_wait(pids, timeout_s=30.0):
    """SIGKILL each of ``pids`` and wait until none runs; a child of this
    process is reaped."""
    for pid in pids:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + timeout_s
    while set(pids) & set(descendants()) and time.monotonic() < deadline:
        time.sleep(0.05)
    for pid in pids:
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, os.WNOHANG)


def stop_child_processes() -> list:
    """Stops every process this script started that still runs, and
    returns the leaks among them. Process workers (the loaders'
    use_processes) leave multiprocessing's forkserver and resource tracker
    behind: they stop on their own only after this process has ended, when
    they read that their pipes closed, so they are stopped here and waited
    for. Any other live process below this one is a leak (a pool that was
    not closed, a child that was not waited for): it is killed, and
    returned with its command line."""
    from multiprocessing import forkserver, resource_tracker

    gc.collect()
    server, tracker = forkserver._forkserver, resource_tracker._resource_tracker
    helpers = {getattr(server, "_forkserver_pid", None), getattr(tracker, "_pid", None)}
    leaks = [(pid, command_line(pid)) for pid in descendants() if pid not in helpers]
    kill_and_wait([pid for pid, _ in leaks])
    for helper, pid in ((server, getattr(server, "_forkserver_pid", None)),
                        (tracker, getattr(tracker, "_pid", None))):
        if pid is None:
            continue
        # _stop closes the helper's pipe and waits for it to end
        stopper = threading.Thread(target=getattr(helper, "_stop", lambda: None), daemon=True)
        stopper.start()
        stopper.join(30.0)
        if pid in descendants():
            kill_and_wait([pid])
    rest = descendants()
    leaks += [(pid, command_line(pid)) for pid in rest]
    kill_and_wait(rest)
    return leaks


def run_phases(args, card):
    """Every phase on the card; returns the kernels line's rows."""
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
    t0 = time.perf_counter()
    native.library()
    native.nifti_library()
    for source in (native.SOURCE, native.NIFTI_SOURCE):
        print(f"build: g++ {source} "
              f"{build.build_logs.get(source, '(library was already built)').strip()}",
              flush=True)
    print(f"build: g++ {time.perf_counter() - t0:.1f} s", flush=True)

    device, half_batch = torch.device("cuda"), 2 * SUBJECTS_PER_REQUEST
    started = time.perf_counter()

    def phase(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s (script "
              f"{time.perf_counter() - started:.1f} s)", flush=True)
        return out

    rows = phase("kernels N=8", kernel_phase, device, half_batch, args.seed, card)
    tta_rows = phase("kernels N=32", kernel_phase, device, TTA_BATCH, args.seed + 4, card)
    # the affine TTA request's batch (affine_part, cli_hippo_serving): checked there too
    phase("kernels N=128", check_classes, device, args.seed + 5, card, AFFINE_BATCH,
          CONV_CLASSES)
    phase("orientation grids", check_orientation_grids, device, args.seed, card)
    grad_rows = phase("gradient kernels", grad_kernel_phase, device, half_batch, args.seed, card)
    # the mesh phase's step at N=16 (one process and NCCL's world 1: a
    # global batch of MESH_BATCH subjects, split) and its TTA forward at
    # N=16 on each of its 2 ranks
    phase("kernels N=16", lambda: (
        check_classes(device, args.seed + 16, card, 2 * MESH_BATCH, CONV_CLASSES),
        grad_kernel_phase(device, 2 * MESH_BATCH, args.seed + 16, card, timing=None)))
    ms_rows = phase("msseg2 kernels", kernel_phase, device, 1, args.seed + 6, card,
                    MS_CONV_CLASSES)
    phase("msseg2 large class", check_classes, device, args.seed + 8, card, MS_LARGE_BATCH,
          MS_LARGE_CLASSES)
    ms_train_rows = phase(
        "msseg2 train kernels",
        lambda: kernel_phase(device, MS_TRAIN_BATCH, args.seed + 13, card, MS_CONV_CLASSES,
                             timing=MS_TRAIN_TIMING)
        + grad_kernel_phase(device, MS_TRAIN_BATCH, args.seed + 14, card, MS_CONV_CLASSES,
                            MS_IN_CHANNELS, timing=MS_TRAIN_TIMING))
    phase("slice", slice_phase, card, args.seed, rows)
    phase("tta", tta_phase, card, args.seed, tta_rows)
    phase("msseg2", msseg2_phase, card, args.seed, ms_rows)
    with tempfile.TemporaryDirectory() as tmp:
        phase("serving determinism", serving_determinism, card, args.seed, tmp)
    state_dict, batch_cf = phase("train", train_phase, card, args.seed, grad_rows)
    ms_root = tempfile.mkdtemp(prefix="msseg2-")
    write_msseg2_dataset(ms_root, args.seed + 11)
    phase("msseg2-train", ms_train_phase, card, args.seed, ms_train_rows, ms_root)
    # the N=8 forward rows count the serving slice's launches: per step, a
    # forward's; the other rows count launches per step
    per_forward = {(*spatial, cin, cout): n for spatial, cin, cout, n in CONV_CLASSES}
    step_totals("per train step", rows + grad_rows,
                lambda row: per_forward[row["_key"][2:]] if row["_kind"] == "fwd"
                else row["launches"], card)
    tta_totals(tta_rows, card)
    ms_totals(ms_rows, card)
    step_totals(f"per msseg2 train step (N={MS_TRAIN_BATCH})", ms_train_rows,
                lambda row: row["launches"], card)
    phase("card against CPU", cpu_train_comparison,
          card, "train f32 vs CPU port (first subject, dropout 0)",
          lambda: NestedResUNet(IN_CHANNELS, OUT_CHANNELS, filters=FILTERS),
          lambda: Adam(lr=2e-4), HybridLogisticDiceLoss(), state_dict, {k: v[:1] for k, v in batch_cf.items()},
          sagittal_split=True)
    try:
        drop_contours = missing_render_packages()
        if drop_contours is not None:
            print(f"trainer: ContourImageEvaluator renders with matplotlib and PIL, and here "
                  f"{drop_contours}; the contour-image schedules are dropped from the "
                  f"dmri_hippo and msseg2 contexts, which train without them [{card}]",
                  flush=True)
        drop = drop_contours is not None
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "dmri_hippo")
            t0 = time.perf_counter()
            write_hippo_dataset(root, args.seed + 21)
            print(f"trainer: dmri_hippo dataset of {sum(HIPPO_SUBJECTS.values())} subjects on "
                  f"{'x'.join(map(str, ORIGINAL_GRID))} written in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            phase("trainer", trainer_phase, card, root, ms_root, tmp, drop)
            phase("fast-path", fast_path_phase, card, args.seed, root, ms_root, tmp, drop)
            phase("cli", cli_phase, card, args.seed, root, ms_root, tmp, drop)
            qsm_rows = phase("qsm-dwi", qsm_dwi_phase, card, args.seed, root, tmp, drop, device)
            cascade_rows = phase("cascade-cleanup", cascade_cleanup_phase, card, args.seed, root,
                                 ms_root, tmp, drop, device)
            phase("mesh", mesh_phase, card, args.seed, root, tmp)
    finally:
        shutil.rmtree(ms_root)

    return [{key: value for key, value in row.items() if not key.startswith("_")}
            for row in rows + tta_rows + grad_rows + ms_rows + ms_train_rows + qsm_rows
            + cascade_rows]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--compare", nargs="+", metavar="CHECKOUT",
                        help="only time msseg2 competition requests in each checkout given "
                             "(compare_requests), e.g. parent . . parent")
    parser.add_argument("--mesh-rank", metavar="FOLDER",
                        help="run one rank of the mesh phase's gloo world on the inputs in "
                             "FOLDER (the phase starts its ranks so, through launch_multihost)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if args.mesh_rank:
        return mesh_rank(args.mesh_rank)

    card = card_line()
    print(card, flush=True)
    try:
        if args.compare:
            compare_requests(card, args.compare, args.seed)
        else:
            rows = run_phases(args, card)
    finally:
        leaks = stop_child_processes()
        print(f"processes: forkserver and resource tracker stopped; {len(leaks)} other "
              "processes left running at the end" + "".join(
                  f"; killed {pid}: {line}" for pid, line in leaks), flush=True)
    if leaks:
        raise RuntimeError(f"{len(leaks)} processes were left running")
    if args.compare:
        return 0
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
