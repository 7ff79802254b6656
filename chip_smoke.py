#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rot_mvgaze_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the repository root. It drives the port only and imports nothing
of JAX or of the JAX package. Phases, in order; any failure raises, so the
script exits non-zero and prints no result line:

1. card: requires CUDA; prints the card's name and power limit.
2. build: compiles every csrc/*.cu for sm_90a and prints each -Xptxas -v
   report (registers, shared memory, spills).
3. kernels: the fusion kernel against its plain PyTorch version on the
   card, at the serving shapes, B in {1, 2, 8, 32, 50, 128, 200} (8 and
   32: the trainer phase's ragged f32 eval batch and grad_accum
   micro-batch; 128 bf16, 8 bf16 and 2 f32: phase 16's steps and forwards,
   its requests and entry()'s forward, a shard of its dry run's evaluation),
   H = 1000, R18's widths and an unaligned shape (B = 20: the command line
   phase's ragged f32 eval batch): bf16 at the model's shapes must take the wgmma
   variant, f32 and the unaligned shape the generic one, and each case is
   called twice, bit for bit. float32 runs with TF32 off (cuBLAS and cuDNN)
   throughout the script, so float32 means float32.
4. serving: FeatRotationSymm(backbone_depth=50, num_iter=3) at full width,
   seeded random weights (BN running statistics estimated from one batch,
   so activations have a trained net's scale), saved as a reference-format
   .pth.tar and loaded by GazePredictor (bf16, micro-batch 64, 224x224).
   The HTTP server answers concurrent requests of N in {1, 17, 64, 100}
   through BatchingPredictor; kernel launch counts are reset just before and
   read just after, and must be 6 per micro-batch (2 views x 3 iterations),
   all of the fusion kernel's wgmma variant.
   Replies must match direct predicts, and the kernel path must agree with
   the plain path on the card (bf16: mean angular delta <= 0.1 deg; f32:
   atol 2e-4 / rtol 1e-3 on pred_gaze).
5. timings: each kernel, its plain version and one PyTorch library call for
   the same function (CUDA events, four weight copies in rotation so that W1
   comes from HBM as on the serving path), the bound from bytes and
   operations, serving throughput and p50 latency, peak device memory, and
   the serving path's device time by kernel class (torch.profiler). One
   JSON line per number, tagged with the card's name and power limit.
6. BatchNorm kernels: the four train-mode BN kernels (csrc/batchnorm.cu)
   against their plain versions run in float64, forward and backward, in
   bf16 and f32, at the step's stem, a layer-1 tail, the layer-4 downsample,
   a ragged shape, every distinct BN shape of the step at 50 pairs (the
   command line phase's batch) and of one backbone call on 256 images
   (phase 16's bb_train probe), with bn_stats and bn_bwd_reduce called twice, bit
   for bit, and bn_stats in bf16 bit for bit its plain version on the card;
   the fusion Function's gradients against autograd through its plain
   version at B=64.
6c. conv kernel: conv3x3_bn_stats against its plain version at the
   probe's shape (256 x 14 x 14 x 256, bf16), at R50's four stride-1 3x3
   shapes at 64 images (56x56x64, 28x28x128, 14x14x256, 7x7x512), at one
   image, at M not a multiple of 128, with Cout != C, and at shapes the
   wgmma variant does not take (ragged C and Cout, scalar loads, float32 x,
   a misaligned bf16 x): out within atol 3e-2 of the plain version's
   float32 accumulator, stats within rtol 5e-3 / atol 1.0, two calls bit
   for bit equal, and each case on its variant (bf16 with C and Cout
   multiples of 64 and aligned pointers: wgmma, csrc/conv_bn_wgmma.cu;
   the rest: generic, csrc/conv_bn.cu).
6d. probe: python -m rot_mvgaze_tpu_torch.probe_conv_bn_epilogue's
   run_probe at its defaults, the conv kernel's main path (counts reset
   just before, read just after; every launch must be of the wgmma
   variant; it launches on no other path, as in JAX), then at R50's four
   shapes, each on the wgmma variant too; each record printed.
7. training: FeatRotationSymm(50, 3) through make_train_step, bf16 autocast,
   64 pairs of 224x224 uint8 images, augmentation on, seeded weights: 2
   warm-up steps, then 10 timed steps, the counts reset before each step
   and read after it (exactly 106 launches of each BN kernel and 6 fusion
   launches per step, all of the wgmma variant); every loss finite. Kernel
   path against plain path
   from one saved state: f32 (TF32 off) loss rtol 1e-4 and every gradient
   atol 5e-3 / rtol 5e-2 where f32 can reach that bar of an f64 step (see
   check_training_paths); bf16 loss within 1% and mean angular delta of
   pred_gaze <= 0.1 deg; each at 64 pairs with grad_accum 1 and 2, and at
   50 pairs (the command line phase's batch). Timings of the BN kernels over all 106 BN calls of
   a step (kernel, plain, each kernel's own library counterpart and the
   library's forward and backward pairs: device time, the kernels' by CUDA
   events behind a device sleep, the others' by the profiler; bound from
   bytes), bn_stats and bn_bwd_dx by distinct shape of the step (ms,
   bytes, share of the bound; measured twice, for the spread), step ms,
   images/s, peak memory and the step's device time by kernel class.
8. trainer: the port's Trainer, BatchLoader and prefetch at R50 x 3, bf16,
   64 pairs per step, on an in-memory corpus with GazeDataset's sample
   contract (synthetic_rows, learnable, 224x224; 2 subjects x 6 frames x 18
   cameras = 216 pairs, 3 updates an epoch; a test subject of 72 pairs,
   batches of 64 and 8). The main path trains 2 epochs (evaluation before
   and after each, a save each epoch, a print each step): counts set to 0
   just before and read just after, each update 106 launches of each BN
   kernel and 6 of the fuser's wgmma variant, each float32 evaluation batch
   6 of its generic variant; finite losses, previews (8, 224, 224, 3). The
   epoch-2 checkpoint loads strictly into GazePredictor (float32), whose
   predictions on the test subject agree with Trainer.test's within 0.1 deg.
   A run stopped after update 4 (the preemption save, mid-epoch) and resumed
   by a new Trainer gives updates 5-6 losses within 1% and a final error
   within 0.1 deg of the uninterrupted run's. From the epoch-1 checkpoint,
   one epoch each with grad_accum=2 (212 BN launches each and 12 fuser
   launches per update), ema_decay=0.99 and freeze_bn (no BN kernel; every
   BN buffer bit for bit as loaded). Images/s through train_one_epoch beside
   phase 7's bare step, the device's idle share over an epoch of 3 steps,
   peak memory.
9. cli: python -m rot_mvgaze_tpu_torch's main(argv), in process, at the
   reference's defaults otherwise (R50 x 3, bf16, --batch_size 50
   --test_batch_size 50, --native_loader true, --pairing reference), over
   packs written by the port's write_pack from synthetic_rows (learnable,
   224x224) for every subject of configs/subject/xgaze.yaml (80 x 18 = 1,440
   pairs, 28 drop-last updates) and mpiinv.yaml (270 pairs, 5 evaluation
   batches of 50 and one of 20), each source archive an empty file dated
   before its pack (no h5py, no archive opened). The main path, --exp_name
   xgaze2mpiinv_known --mode train --epochs 1 --save_epoch 1: both loaders
   NativeBatchLoader over the C++ pool; counts set to 0 just before and read
   just after, each update 106 launches of each BN kernel and 6 of the
   fuser's wgmma variant, each float32 evaluation batch 6 of its generic
   variant; finite losses; test_results.txt and a checkpoint. Then --mode
   test from that checkpoint with --test_breakdown true and --export_torch:
   the mean error within 1e-3 deg of the train run's last evaluation, and the
   export loads strictly into GazePredictor (f32; within 0.1 deg of test
   mode on the first batch). Images/s over the train run's updates (a smoke
   reading, beside phase 7a's bare step), the share of that span between
   updates (waiting for the loader, staging the batch), peak memory and the
   phase's seconds. --num_views 3 --grad_accum 2 and --spatial_partition 2 exit
   non-zero before any data is read.
10. model family: R50 x 3 at full width. (a) The main path: one bf16
   update of 64 pairs (or frames) of each configuration beyond the default
   one, counts set to 0 just before and read just after: --fuse_views 53
   launches of each BN kernel and 6 of the fuser's wgmma variant;
   --ignore_rotmat, --encode_rotmat and --share_feature 106 and 0 (their
   fusers are F.linear MLPs, as in JAX); --share_weights 106 and 6; the
   V-view model at V=3 (FeatRotationMultiView, 192 images in one backbone
   batch) 53 and 0; every loss finite; then 5 bare updates each of
   fuse_views and V=3 on the host clock. (b) For fuse_views and V=3, one
   update through the kernels against one through the plain versions from
   one saved state, at phase 7b's bars (f32 against an f64 update too).
   (c) The four BN kernels against float64 (phase 6a's check) at every
   distinct BN shape of both. (d) The V-view Trainer from phase 8's
   epoch-1 stereo checkpoint (a strict load, weights only): one epoch of 3
   updates over an in-memory V=3 corpus (InMemoryMultiViewGazeDataset, 216
   samples; 72 test samples), evaluation before and after, 53 BN launches
   per update and none in evaluation, finite predictions; at V=2 the V-view
   model's eval predictions on one batch of 64 within 1e-3 deg (float64
   angle) of the stereo model's, with both in float64 and with both in
   float32 (the stereo model on its fuser kernel), and in float32 within
   phase 4's f32 bar on pred_gaze. (e) The BN kernels' device ms over
   each fused-batch update's 53 calls and their share of the byte bound,
   beside phase 7c's 106 calls of the default update; images/s, peak
   memory, the phase's seconds.
11. serving surface: R50 x 3 from phase 8's epoch-1 checkpoint, micro-batch
   64, counts set to 0 just before each counted path and read just after.
   (a) One bf16 predictor per ablation (share_weights, ignore_rotmat,
   encode_rotmat, share_feature; the epoch-1 weights where the key and shape
   match) serves 100 pairs: 6 wgmma fuser launches per micro-batch under
   share_weights, 0 under the others; bf16 against the same predictor in
   f32 mean delta <= 0.1 deg. (b) MultiViewGazePredictor at V=3 serves 100
   samples (no fuser launch); at V=2 within 1e-3 deg of the stereo
   predictor in f32. (c) A 448x448 request through the f32 predictor
   against the same images resized on the CPU: mean delta <= 0.01 deg.
   (d) int8: every one of R50's 53 conv shapes at 128 images (full-range
   int8 operands) through im2col + torch._int_mm bit for bit the plain
   float64 convolution; the dynamic int8 predictor serving 100 pairs
   launches 53 int8 GEMMs and 6 wgmma fusers per micro-batch; backbone
   features int8 against f32 on the test subject: mean relative error
   <= 0.05, cosine >= 0.999; static int8 calibrated on phase 8's test
   subject, saved, loaded into a fresh predictor, bit for bit; the metric
   shift of both int8 modes against bf16 (tripwire 3.0 deg). (f) images/s
   and p50 of bf16, int8 dynamic and int8 static on the same requests, and
   each one's device time by kernel class (torch.profiler).
   (e) The bf16 and dynamic int8 stereo models and the V=3 bf16 model
   exported, saved, loaded by AotGazePredictor with the checkpoint and
   served: the stereo programs launch the fuser's wgmma kernel 6 times per
   micro-batch, every program predicts what its live predictor predicts
   (bit for bit, or within 1e-6 deg). Artifact sizes, peak memory, the
   phase's seconds.
12. the last training options and data parallelism, R50 x 3, bf16, full
   width, counts set to 0 just before each update and read just after.
   (a) --bn_stat_subsample 2 at 64 pairs: 106 launches per BN kernel and 6
   fuser; one update through the kernels against the same update through
   the plain versions, at phase 7b's bars in bf16 and f32; bn_stats on the
   prefix, bn_bwd_reduce with the prefix's count and bn_bwd_dx with the
   statistics terms on the prefix rows against float64 at every distinct
   BN shape of the step (half the rows the prefix), bf16 and f32, with the
   data-parallel finish kernels over two halves of the rows (and on all
   rows bit for bit the one-launch path); the device ms of those paths over
   the step's 106 calls beside the k = 1 path, in turns. (b) --remat
   against the same update without it from one saved state (cuDNN
   deterministic): loss and pred_gaze at phase 7b's bf16 bars, every
   gradient within atol 5e-3 / rtol 5e-2, BN buffers within 1e-4, each
   num_batches_tracked moved once per view; launches 210 / 210 / 106 / 106
   and 6; torch.cuda.max_memory_allocated of both updates. (c)
   --profile_steps 2 through the Trainer over an epoch of 3 updates:
   exactly one trace file, 2 optimizer steps in it (the first update
   outside), and two updates' BN kernel and fuser records. (d) two
   processes on the one card (gloo over CUDA tensors), 32 pairs each,
   against one process on the concatenated 64 from one state: the ranks'
   states the same bits; bf16: loss within 1%, the updated model's eval
   predictions within 0.1 deg; f32: loss rtol 1e-4, gradients at phase 7b's
   f32 bars (against a float64 step), eval predictions atol 2e-4 / rtol
   1e-3, BN buffers within 1e-4; launches per rank 106 per BN kernel, 6
   fuser, 106 of each finish kernel. A world of one over nccl: the group
   path bit for bit the no-group path, bf16 and f32. NCCL across cards is
   not measured (one card).
13. mesh serving and spatial partitioning, R50 x 3, full width, 224x224,
   on a logical mesh of cuda:0 (each device of a mesh is that card), counts
   set to 0 just before each micro-batch and update and read just after.
   (a) GazePredictor(mesh=) at (data 2), (data 1, spatial 2), (data 2,
   spatial 2) and (data 1, spatial 4), bf16 and f32, 100 pairs against the
   single-card predictor at the replicas' rows per call: f32 at phase 4's
   bar (atol 2e-4 / rtol 1e-3); bf16 mean delta <= 0.1 deg where the
   replicas run the card's shapes (data parallel), and on strips (other
   conv heights, so other cuDNN kernels) within 0.1 deg or 1.5x the card's
   own bf16 spread between micro-batches 32 and 64, whichever is larger;
   each beside the single-card predictor at micro-batch 64: micro-batch 63 rounded to a multiple of the data
   axis, 6 fuser launches (wgmma in bf16) per data replica per
   micro-batch, no train-mode BN or conv kernel; images/s and p50 of the
   bf16 predictor beside the single-card one; serve.py's --dp
   --spatial_partition 2 (build_predictor over a 4-device list) over HTTP on
   127.0.0.1, replies equal direct predicts. (b) One f32 update of 64
   pairs under (data 1, spatial 2) and (data 1, spatial 4) against the
   unsharded one from one state and seed (loss rtol 1e-4, gradients at
   phase 7b's f32 bars against a float64 step, BN buffers within 1e-4);
   one bf16 update under each against the unsharded bf16 update (phase
   7b's bf16 bars; where the train forward's pred_gaze moves past 0.1 deg,
   its pred_gaze no farther from the f32 unsharded update's than 1.5x the
   unsharded bf16 update's; the gradients are held in f32); every update
   with the launches predicted in PERF.md (PER_SPATIAL_UPDATE, finish
   kernels included); each bf16 update's host ms beside the unsharded one;
   the BN kernels against float64 at every distinct strip shape of the (1,
   2) update. (c) --spatial_partition 2 with one visible card is refused in
   JAX's words. (d) The V-view model (V=3, 64 frames, 192 images) on
   (data 2) and (data 4) from the same checkpoint: one f32 update on each
   against the unsharded update (loss rtol 1e-4, every gradient atol 5e-3 /
   rtol 5e-2, phase 7b's float64 rule recorded where one misses it, BN
   buffers within 1e-4), one bf16 update on each at phase 7b's bars (past
   0.1 deg, (b)'s rule), each with the launches PERF.md predicted
   (PER_MV_MESH_UPDATE: every BN kernel once per block, each finish kernel
   once per BN call, no fuser) and its host ms beside the unsharded
   update's; the BN kernels against float64 at every distinct block shape
   of the (data 2) and (data 4) updates (96 and 48 images); the V-view eval step on 67 frames
   (padded by samples) on each mesh against one device at phase 4's f32
   bar, no kernel launched. Where the process sees more than one card, (a),
   (b) and (d) again over the real cards, and two updates through the
   command line's build_experiment over two of them, with each card's peak
   memory. The phase's seconds.
14. int8 serving under a mesh, R50 x 3, full width, 224x224, micro-batch
   64, on phase 13's logical meshes of cuda:0, counts set to 0 just before
   each predict and read just after: GazePredictor(mesh=, int8=True |
   "static") at (data 2), (1, 2), (2, 2) and (1, 4), bf16 and f32, 100
   pairs against the one-card int8 predictor on the same micro-batches
   (f32 at phase 4's bar, bf16 mean delta <= 0.1 deg); static ranges
   calibrated on the same 64 pairs against the one card's (f32 bit for
   bit, bf16's largest relative difference recorded, tripwire 5%); per
   micro-batch 6 fuser launches per data replica (wgmma in bf16), the int8
   GEMMs predicted in PERF.md (53 per replica on whole maps, one per strip
   for each conv on strips), no train-mode BN or conv kernel; images/s and
   p50 of each bf16 int8 predictor beside one card's int8 and the same
   mesh's bf16; serve.py --dp --spatial_partition 2 --int8_static over HTTP
   on 127.0.0.1 (the first request calibrates and saves the ranges, the
   later replies equal direct predicts). The phase's seconds.
15. the protocol commands. (a) reference_parity's four-protocol table at
   R50 x 3, 224x224, batch 50, float32, from phase 8's epoch-1 checkpoint
   saved as a reference .pth.tar, over two synthetic corpora written as
   packs (2 subjects x 3 frames x 18 cameras each) through the C++ pool:
   counts set to 0 just before each protocol and read just after, 6 generic
   fuser launches per eval batch (48 over the table, PERF.md's prediction)
   and nothing else; each protocol within 1e-3 deg of the same table
   through the plain versions. (b) pairing_sensitivity at its defaults cut
   to --epochs 1 --seeds 2 (R18, 64x64) and (c) probe_ema_benefit cut to
   --epochs 2 (R18 x 1, 32x32), each with its launches predicted (40 of
   each BN kernel per float32 update; 6 or 2 generic fuser launches per
   update and per eval batch), its evaluations through the plain versions
   within 1e-3 deg. The table, the errors, the counts and each command's
   seconds on a {"reference_parity": ...} line.
16. the benchmark commands, each through its run function, counts set to
   0 just before each and read just after. (a) The main path: bench at its
   defaults (R50 x 3, 224x224, 128 pairs, bf16; 3 warm-up and 20 timed
   steps, FLOPs counted over the first): 106 launches of each BN kernel
   and 6 of the fuser's wgmma variant per step; its host-clock images/s
   within 5% of CUDA events' around the same 20 steps; and bench with
   BENCH_NUM_VIEWS=3 BENCH_BATCH=32 on cuda:0,cuda:0 (a logical (data 2)
   mesh, 192 images per step): per step phase 13d's (data 2) launches, host
   within 5% of CUDA events, n_chips 2. (b) bench_eval in
   bf16, BENCH_INT8=1 and BENCH_INT8=static at 5 timed calls and 10
   requests: 6 wgmma fuser launches per forward, 53 int8 GEMMs per forward
   under int8. (c) bench_sweep's five
   variants at 3 timed calls (full and noaug 106 / 6 per step, fwdonly 6
   per forward), bench_probes' four probes at 5 (bb_train 53 of each BN
   kernel per call), probe_int8 at 10 chained iterations x 2 timed calls
   (one int8 GEMM per chained iteration; its int8 chain on the card bit
   for bit the CPU's integer chain), probe_int8_static at 5 (53 int8 GEMMs
   and 6 wgmma per forward), bench_loader_scaling at 8 threads and
   bench_cold_path at small sample counts. Phases 3 and 6 hold the kernels
   against their plain versions at these paths' shapes. (d) dryrun.entry()'s bf16 forward through the kernels
   against plain_kernels() (mean delta <= 0.1 deg, 6 wgmma launches), and
   dryrun_multichip(4, "reduced") on ["cuda:0"] * 4 (and on 4 real cards
   where the process sees them): 6 generic fuser launches per update and
   for the evaluation; and dryrun_multichip(4, "multiview") (R18/64², V=3,
   f32) on the same meshes: 80 launches of each BN kernel and 20 of each
   finish kernel per update, no fuser, the evaluation of 6 frames padded to
   8, with the BN kernels against float64 at its 3-image block shapes. (e)
   check_command_budgets' three commands on the
   card, each a fresh process under its budget, started side by side and
   beside (d) and (f), which time nothing. (f)
   Determinism: probe_ema_benefit --epochs 2 twice (its 24 float32
   updates seeded through set_seed): histories, weights and average bit
   for bit the same, and the record phase 15's; once more with the
   cudnn.deterministic flag undone after set_seed (a control, recorded);
   and once in a child process, beside (e), under
   torch.use_deterministic_algorithms(True) (CUBLAS_WORKSPACE_CONFIG=:4096:8),
   which must run to its end. Every record and each part's seconds on a
   {"drivers": ...} line.
17. the {"phase_seconds": ...} line (each phase's seconds and the whole
   run's), the card line, the kernels line, and as the last line
   {"ok": true, "device": {...}}.

    python3 chip_smoke.py --old DIR

runs phase 1 and then, instead of phases 2-17, times an earlier checkout's
kernels against this tree's in turns on the same card: DIR holds a checkout
of an earlier commit (for example ``git archive <commit>`` unpacked into a
directory that .gitignore lists). Four child processes run in the order
old, new, new, old (``--pairs P``: P pairs, the order alternating); each
builds its own tree's kernels and times the fuser at the serving shape
(time_fusion's inputs and timing), bn_bwd_dx, bn_bwd_reduce, bn_stats and
bn_apply over the 106 BN calls of one training step
(time_bn's inputs and timing), at shapes taken once from this tree's R50
backbone, the conv kernel at the probe's shape (run_probe's inputs and
timing), and its own bf16 GazePredictor (phase 4's checkpoint, micro-batch
64, time_serving). One JSON line per turn, and a last line with every turn and the
card. With ``--what steps`` each turn instead times phase 7's bare step and
phase 8's Trainer, each seeded through its own tree's set_seed (the cost of
cuDNN's deterministic algorithms against a tree without them).
"""

from __future__ import annotations

import contextlib
import http.client
import io
import itertools
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

FUSION = {
    "name": "rotate_concat_matmul_relu",
    "route": "cuda",
    "source": "rot_mvgaze_tpu_torch/csrc/fusion_wgmma.cu",
    "generic_source": "rot_mvgaze_tpu_torch/csrc/fusion.cu",
    "replaces": "rot_mvgaze_tpu/ops/fusion.py:44",
}
# serving shapes of the fuser's layer 1 at R50: B, D, V, H
B, D, V, H = 64, 2048, 512, 3584
BN_SOURCE = "rot_mvgaze_tpu_torch/csrc/batchnorm.cu"
BN_KERNELS = {  # wrapper name -> the Pallas kernel it replaces
    "bn_stats": "rot_mvgaze_tpu/ops/batchnorm.py:63",
    "bn_apply": "rot_mvgaze_tpu/ops/batchnorm.py:106",  # and :113, the residual variant
    "bn_bwd_reduce": "rot_mvgaze_tpu/ops/batchnorm.py:155",
    "bn_bwd_dx": "rot_mvgaze_tpu/ops/batchnorm.py:210",
}
CONV = {
    "name": "conv3x3_bn_stats",
    "route": "cuda",
    "source": "rot_mvgaze_tpu_torch/csrc/conv_bn_wgmma.cu",
    "generic_source": "rot_mvgaze_tpu_torch/csrc/conv_bn.cu",
    "replaces": "rot_mvgaze_tpu/ops/conv_bn.py:53",
}
PAIRS = 64  # stereo pairs per training step (128 images)
CLI_BATCH = 50  # the reference's --batch_size and --test_batch_size
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def fusion_inputs(b, d, v, h, dtype, seed, copies=1):
    """Seeded inputs on the card; ``copies`` independent (w1, b1) pairs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def randn(*shape, scale, dt=dtype):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    from rot_mvgaze_tpu_torch.geometry import rotation_matrix_2d

    poses = torch.rand(b, 2, generator=g, device=dev) * 1.6 - 0.8
    acts = (randn(b, d, scale=0.5), randn(b, 3, v, scale=0.5),
            rotation_matrix_2d(poses).contiguous())
    weights = [(randn(h, d + 3 * v, scale=0.02), randn(h, scale=0.01, dt=torch.float32))
               for _ in range(copies)]
    return acts, weights


def check_kernels(fusion) -> float:
    """Phase 3: the fusion kernel against its plain version; returns the
    max |err| at the serving shape in bf16. bf16 at the model's shapes must
    take the wgmma variant, f32 and the unaligned bf16 shape the generic
    one; every case is called twice and must agree bit for bit. b32 is a
    grad_accum=2 micro-batch of the trainer phase, b8 its float32 eval's
    ragged last batch, b20 the command line phase's; of phase 16, b128 is
    the batch of bench's step, bench_eval's and probe_int8_static's forward
    and bench_sweep's, b8 bf16 bench_eval's requests and entry()'s forward,
    b2 a shard of the dry run's evaluation."""
    cases = [
        ("serving", B, D, V, H, torch.bfloat16), ("serving", B, D, V, H, torch.float32),
        ("b1", 1, D, V, H, torch.bfloat16), ("b1", 1, D, V, H, torch.float32),
        ("b2", 2, D, V, H, torch.float32),
        ("b8", 8, D, V, H, torch.bfloat16), ("b8", 8, D, V, H, torch.float32),
        ("b20", 20, D, V, H, torch.float32),
        ("b32", 32, D, V, H, torch.bfloat16), ("b32", 32, D, V, H, torch.float32),
        ("b50", 50, D, V, H, torch.bfloat16), ("b50", 50, D, V, H, torch.float32),
        ("b128", 128, D, V, H, torch.bfloat16),
        ("b200", 200, D, V, H, torch.bfloat16),
        ("h1000", B, D, V, 1000, torch.bfloat16), ("h1000", B, D, V, 1000, torch.float32),
        ("r18", B, 512, V, 2048, torch.bfloat16),
        ("unaligned", 7, 200, 40, 96, torch.bfloat16),
    ]
    serving_err = None
    for name, b, d, v, h, dtype in cases:
        (img, feat, rot), [(w1, b1)] = fusion_inputs(b, d, v, h, dtype, seed=b + h)
        want_variant = "wgmma" if dtype == torch.bfloat16 and name != "unaligned" else "generic"
        before = dict(fusion.rotate_concat_matmul_relu.launches_by_variant)
        got = fusion.rotate_concat_matmul_relu(img, feat, rot, w1, b1)
        again = fusion.rotate_concat_matmul_relu(img, feat, rot, w1, b1)
        torch.cuda.synchronize()
        after = fusion.rotate_concat_matmul_relu.launches_by_variant
        if after[want_variant] - before[want_variant] != 2:
            raise RuntimeError(f"fusion {name} {dtype}: expected the {want_variant} variant, "
                               f"launches went {before} -> {after}")
        if not torch.equal(got, again):
            raise RuntimeError(f"fusion {name} {dtype}: two calls on the same inputs differ")
        want = fusion.rotate_concat_matmul_relu_reference(img, feat, rot, w1, b1)
        # f32: TF32 off on both sides. bf16 compared in f32: one bf16 ulp is
        # 2^-8 and K is 3584
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        log(f"fusion kernel {name} B={b} D={d} V={v} H={h} {str(dtype)[6:]} ({want_variant}): "
            f"max|err| {err:.3e} (tol {tol}); bit for bit on a second call")
        if name == "serving" and dtype == torch.bfloat16:
            serving_err = err
    return serving_err


def make_checkpoint(path: str) -> None:
    """Seeded random R50 weights; BN running statistics estimated from one
    batch of noise images, so activations have a trained net's scale."""
    from torch import nn

    from rot_mvgaze_tpu_torch.augment import eval_preprocess
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm

    torch.manual_seed(0)
    model = FeatRotationSymm(backbone_depth=50, num_iter=3)
    backbone = model._feat_extractor.cuda()
    bns = [m for m in backbone.modules() if isinstance(m, nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None  # cumulative average over the calibration pass
    g = torch.Generator(device="cuda").manual_seed(1)
    imgs = torch.randint(0, 256, (64, 224, 224, 3), dtype=torch.uint8, device="cuda", generator=g)
    with torch.no_grad():
        backbone.train()(eval_preprocess(imgs, 224))
    for bn in bns:
        bn.momentum = 0.1
        bn.num_batches_tracked.zero_()
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)


def requests(sizes, seed):
    rng = np.random.default_rng(seed)
    return [
        (
            rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8),
            rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8),
            rng.uniform(-0.6, 0.6, (n, 2)).astype(np.float32),
            rng.uniform(-0.6, 0.6, (n, 2)).astype(np.float32),
        )
        for n in sizes
    ]


def post_predict(port: int, fields, req):
    buf = io.BytesIO()
    np.savez(buf, **dict(zip(fields, req)))
    body = buf.getvalue()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/predict", body=body,
                     headers={"Content-Length": str(len(body))})
        r = conn.getresponse()
        payload = r.read()
    finally:
        conn.close()
    if r.status != 200:
        raise RuntimeError(f"HTTP {r.status}: {payload[:500]!r}")
    return np.load(io.BytesIO(payload))["pred_gaze"]


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper through its plain PyTorch version (on the
    card), for the kernel-vs-plain checks of whole paths."""
    from rot_mvgaze_tpu_torch.ops import batchnorm, fusion

    swaps = [(fusion, "rotate_concat_matmul_relu")] + [(batchnorm, n) for n in BN_KERNELS]
    kernels = [getattr(m, n) for m, n in swaps]
    for m, n in swaps:
        setattr(m, n, getattr(m, f"{n}_reference"))
    try:
        yield
    finally:
        for (m, n), k in zip(swaps, kernels):
            setattr(m, n, k)


def run_serving(fusion, ckpt: str) -> dict:
    """Phase 4; returns launch count, timing inputs and the predictor."""
    from rot_mvgaze_tpu_torch.geometry import angular_error_numpy
    from rot_mvgaze_tpu_torch.serve import build_handler
    from rot_mvgaze_tpu_torch.serving import BatchingPredictor, GazePredictor

    pred = GazePredictor(ckpt, backbone_depth=50, num_iter=3, micro_batch=64,
                         image_size=224, dtype=torch.bfloat16, device="cuda")
    pred.warmup()
    torch.cuda.synchronize()
    reqs = requests([1, 17, 64, 100], seed=2)

    batching = BatchingPredictor(pred, max_delay_ms=5.0)
    stats = {"requests": 0, "samples": 0, "time": 0.0}
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), build_handler(batching, stats))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    replies = [None] * len(reqs)
    errors = []

    def client(i):
        try:
            replies[i] = post_predict(httpd.server_address[1], pred.request_fields, reqs[i])
        except Exception as e:  # reported below, after every client joined
            errors.append(repr(e))

    clients = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
    from rot_mvgaze_tpu_torch.ops import batchnorm

    try:
        # --- main path: counts reset just before, read just after
        reset_counts(fusion, batchnorm)
        mb_before = pred.micro_batches_run
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        counts = launch_counts(fusion, batchnorm)
        launches = counts["fusion"]
        by_variant = dict(fusion.rotate_concat_matmul_relu.launches_by_variant)
        micro_batches = pred.micro_batches_run - mb_before
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
        batching.close()
    if errors or any(c.is_alive() for c in clients):
        raise RuntimeError(f"HTTP clients failed: {errors}")
    log(f"HTTP: {stats['requests']} requests, {stats['samples']} samples, "
        f"{micro_batches} micro-batches, {launches} fusion launches")
    if micro_batches == 0 or launches != 6 * micro_batches:
        raise RuntimeError(
            f"fusion launches {launches} != 6 x {micro_batches} micro-batches"
        )
    if by_variant["wgmma"] != launches:
        raise RuntimeError(f"serving fusion launches by variant {by_variant}: not all wgmma")
    if any(counts[k] for k in BN_KERNELS) or counts["conv3x3_bn_stats"]:
        raise RuntimeError(f"eval serving launched train-mode BN or conv kernels: {counts}")

    worst = 0.0
    for req, reply in zip(reqs, replies):
        n = req[0].shape[0]
        if reply.shape != (n, 2) or not np.all(np.isfinite(reply)):
            raise RuntimeError(f"bad reply for N={n}: shape {reply.shape}")
        direct = pred.predict(*req)
        worst = max(worst, float(np.abs(reply - direct).max()))
        np.testing.assert_allclose(reply, direct, atol=1e-3, rtol=0)
    log(f"replies equal direct predicts: max |diff| {worst:.3e} rad (bar 1e-3)")

    # kernel path vs plain path on the card, whole model
    check = reqs[3]
    kernel_bf16 = pred.predict(*check)
    with plain_kernels():
        plain_bf16 = pred.predict(*check)
    delta = float(angular_error_numpy(kernel_bf16, plain_bf16).mean())
    log(f"bf16 kernel vs plain path: mean angular delta {delta:.4e} deg (bar 0.1)")
    if not delta <= 0.1:
        raise RuntimeError(f"bf16 kernel path deviates from plain path by {delta} deg")
    pred32 = GazePredictor(ckpt, backbone_depth=50, num_iter=3, micro_batch=64,
                           image_size=224, dtype=torch.float32, device="cuda")
    kernel_f32 = pred32.predict(*check)
    with plain_kernels():
        plain_f32 = pred32.predict(*check)
    err32 = float(np.abs(kernel_f32 - plain_f32).max())
    np.testing.assert_allclose(kernel_f32, plain_f32, atol=2e-4, rtol=1e-3)
    log(f"f32 kernel vs plain path: max |diff| {err32:.3e} (atol 2e-4, rtol 1e-3)")
    del pred32
    return {"launches": launches, "by_variant": by_variant, "predictor": pred,
            "request": requests([64], seed=3)[0]}


def time_cuda(fn, n_iter=100, n_warm=10) -> float:
    """Mean device ms per call from CUDA events around ``n_iter`` calls of
    fn(i). A device-side sleep queued first lets the host enqueue every call
    before the first one starts, so the host's per-call cost does not show
    in the device time; a host loop longer than the sleep is reported."""
    for i in range(n_warm):
        fn(i)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sleep_a, sleep_b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    sleep_a.record()
    torch.cuda._sleep(100_000_000)
    sleep_b.record()
    start.record()
    t0 = time.perf_counter()
    for i in range(n_iter):
        fn(i)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    if host_ms > sleep_a.elapsed_time(sleep_b):
        log(f"host enqueue ({host_ms:.2f} ms) outlasted the device sleep: "
            f"the device time below includes host gaps")
    return start.elapsed_time(end) / n_iter


def fusion_bound_ms(b, d, v, h, itemsize) -> tuple:
    """(bound ms, 'bytes' | 'operations') for one layer-1 call: each input
    read once, the output written once; 2*B*K*H product ops + 6*B*3V rotation
    ops at the bf16 tensor-core peak."""
    k = d + 3 * v
    nbytes = itemsize * (b * d + b * 3 * v + h * k + b * h) + 4 * (b * 9 + h)
    ops = 2 * b * k * h + 6 * b * 3 * v
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    log(f"bound: {nbytes} bytes -> {t_bytes * 1e3:.5f} ms; {ops} ops -> {t_ops * 1e3:.5f} ms")
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def fusion_serving_case(fusion):
    """(inputs, weights, kernel): the serving shape in bf16 with four (W1,
    b1) copies in rotation (103 MB, over the 50 MB L2), so that each call
    of kernel(i) reads W1 from HBM."""
    (img, feat, rot), weights = fusion_inputs(B, D, V, H, torch.bfloat16, seed=7, copies=4)

    def kernel(i):
        w1, b1 = weights[i % 4]
        fusion.rotate_concat_matmul_relu(img, feat, rot, w1, b1)

    return (img, feat, rot), weights, kernel


def time_fusion(fusion) -> dict:
    """Kernel, plain version and library call at the serving shape in bf16,
    W1 from HBM (fusion_serving_case)."""
    (img, feat, rot), weights, kernel = fusion_serving_case(fusion)
    x_cat = torch.cat(
        [img, torch.einsum("bij,bjv->biv", rot, feat.float()).to(img.dtype).flatten(1)], 1
    )
    lib_bias = [b1.to(torch.bfloat16) for _, b1 in weights]

    def plain(i):
        w1, b1 = weights[i % 4]
        fusion.rotate_concat_matmul_relu_reference(img, feat, rot, w1, b1)

    def library(i):
        torch.addmm(lib_bias[i % 4], x_cat, weights[i % 4][0].T).relu_()

    # plain, kernel, kernel, plain: compare within one call, in turns
    plain_a, kernel_a = time_cuda(plain), time_cuda(kernel)
    kernel_b, plain_b = time_cuda(kernel), time_cuda(plain)
    library_ms = time_cuda(library)
    bound_ms, bound_by = fusion_bound_ms(B, D, V, H, 2)
    log(f"fusion ms: kernel {kernel_a:.5f}/{kernel_b:.5f}, plain {plain_a:.5f}/{plain_b:.5f}, "
        f"library {library_ms:.5f}, bound {bound_ms:.5f} ({bound_by})")
    return {"ms": min(kernel_a, kernel_b), "plain_ms": min(plain_a, plain_b),
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def time_serving(pred, req, n_iter=20) -> dict:
    for _ in range(3):
        pred.predict(*req)
    lat = []
    t_all = time.perf_counter()
    for _ in range(n_iter):
        t0 = time.perf_counter()
        pred.predict(*req)  # returns host numpy: the device work is done
        lat.append((time.perf_counter() - t0) * 1e3)
    total = time.perf_counter() - t_all
    n = req[0].shape[0]
    return {"serve_imgs_per_s": 2 * n * n_iter / total,
            "serve_p50_ms": float(np.percentile(lat, 50))}


PROFILE_CLASSES = (  # first match wins, on the lower-cased kernel name
    ("fusion kernel", ("rotate_concat_matmul_relu", "fusion_wgmma")),
    ("bn_stats kernel", ("bn_stats_kernel",)),
    ("bn_apply kernel", ("bn_apply_kernel",)),
    ("bn_bwd_reduce kernel", ("bn_bwd_reduce_kernel",)),
    ("bn_bwd_dx kernel", ("bn_bwd_dx_kernel",)),
    ("optimizer (Adam, foreach)", ("multi_tensor", "foreach")),
    ("convolution", ("conv", "fprop", "implicit", "dgrad", "wgrad", "xmma", "winograd")),
    ("batchnorm", ("batch_norm", "bn_")),
    ("gemm (linear)", ("gemm", "nvjet", "cutlass", "cublas")),
    ("memcpy", ("memcpy",)),
    ("pooling", ("pool",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy", "fill", "cat")),
)


def profile_serving(pred, req, n_iter=3) -> dict:
    """Device time by kernel class over ``n_iter`` predicts of ``req``, and
    the device's idle share of the host wall time (torch.profiler, CUPTI)."""
    out = profile_device(lambda: pred.predict(*req), n_iter)
    out["window_ms_per_request"] = out.pop("window_ms_per_call")
    out["device_busy_ms_per_request"] = out.pop("device_busy_ms_per_call")
    out["device_ms_per_request_by_class"] = out.pop("device_ms_per_call_by_class")
    return out


def profile_device(fn, n_iter=3) -> dict:
    """Device time by kernel class over ``n_iter`` calls of ``fn`` (which
    ends in a synchronize), the device's idle share of the host wall time,
    and the count of kernel records (torch.profiler, CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_iter):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_class: dict = {}
    kernels = 0
    for e in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats the
        # time of the kernels it launched
        us = e.self_device_time_total
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue
        key = e.key.lower()
        cls = next((c for c, pats in PROFILE_CLASSES if any(p in key for p in pats)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us
        kernels += e.count
    busy = sum(by_class.values())
    return {
        "window_ms_per_call": wall_us / n_iter / 1e3,
        "device_busy_ms_per_call": busy / n_iter / 1e3,
        "device_idle_share": (1 - busy / wall_us) if busy else None,
        "kernels": kernels,
        "device_ms_per_call_by_class": {
            c: us / n_iter / 1e3 for c, us in sorted(by_class.items(), key=lambda kv: -kv[1])
        },
    }


# ---------------------------------------------------------------------------
# BatchNorm kernels and the fusion gradients (phase 6)
# ---------------------------------------------------------------------------

BN_CASES = [  # name, rows, C, relu, residual: shapes of the R50 step at 64 pairs
    ("stem", 802_816, 64, True, False),
    ("layer1 tail", 200_704, 256, True, True),
    ("layer4 downsample", 3_136, 2_048, False, False),
    ("ragged", 2_450, 72, True, True),
]
# Bars against the float64 plain versions. Per-channel results (mean, var,
# dscale, dbias) hold to the JAX suite's bars in both dtypes (forward 1e-5,
# gradients atol 5e-4 / rtol 1e-3, tests/test_pallas_bn.py): the kernels read
# the same values and sum in f32 and f64. Per-element outputs (y, dx) hold to
# the same bars in f32; in bf16 each is rounded once to bf16 (half an ulp is
# 2^-9 of the value), so atol / rtol 1e-2. dres is g masked by y > 0: exact.
BN_FWD_TOL, BN_GRAD_TOL, BN_BF16_TOL = (1e-5, 1e-5), (5e-4, 1e-3), (1e-2, 1e-2)


CONV_CASES = [  # name, B, H, W, C, Cout, x dtype, variant
    ("probe", 256, 14, 14, 256, 256, torch.bfloat16, "wgmma"),
    ("r50 layer1", 64, 56, 56, 64, 64, torch.bfloat16, "wgmma"),
    ("r50 layer2", 64, 28, 28, 128, 128, torch.bfloat16, "wgmma"),
    ("r50 layer3", 64, 14, 14, 256, 256, torch.bfloat16, "wgmma"),
    ("r50 layer4", 64, 7, 7, 512, 512, torch.bfloat16, "wgmma"),
    ("b1", 1, 14, 14, 256, 256, torch.bfloat16, "wgmma"),
    ("m ragged", 3, 13, 11, 128, 192, torch.bfloat16, "wgmma"),
    ("cout != c", 16, 14, 14, 256, 128, torch.bfloat16, "wgmma"),
    ("ragged", 3, 5, 7, 72, 40, torch.bfloat16, "generic"),
    ("misaligned", 4, 14, 14, 128, 128, torch.bfloat16, "generic"),
    ("scalar loads", 2, 9, 11, 13, 20, torch.float32, "generic"),
    ("f32 x", 8, 14, 14, 128, 128, torch.float32, "generic"),
]
R50_CONV_SHAPES = [(64, 56, 64), (64, 28, 128), (64, 14, 256), (64, 7, 512)]  # B, H=W, C=Cout


def check_conv_kernel(conv_bn) -> float:
    """Phase 6c: the conv kernel against its plain version on the card, each
    case on its variant (a "misaligned" x starts 2 bytes past a 16-byte
    boundary); returns the max |out err| at the probe's shape. The plain
    version runs on x in float32, which gives its float32 accumulator
    unrounded (the inputs are rounded to bf16 either way): a bf16 output is
    then off by its one rounding, under 2^-6 for |out| < 4 (x standard
    normal, w scaled by 1/sqrt(9C), so |out| is near 1). Bars: out atol
    3e-2, stats rtol 5e-3 / atol 1.0 (tests/test_conv_bn.py)."""
    probe_err = None
    for name, b, h, w, c, cout, dtype, variant in CONV_CASES:
        g = torch.Generator(device="cuda").manual_seed(b * h + c + cout)
        x = torch.randn(b, h, w, c, device="cuda", generator=g).to(dtype)
        if name == "misaligned":
            x = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:].view_as(x).copy_(x)
        wt = (torch.randn(3, 3, c, cout, device="cuda", generator=g) / (9 * c) ** 0.5).to(dtype)
        before = dict(conv_bn.conv3x3_bn_stats.launches_by_variant)
        out, stats = conv_bn.conv3x3_bn_stats(x, wt)
        again = conv_bn.conv3x3_bn_stats(x, wt)
        torch.cuda.synchronize()
        after = conv_bn.conv3x3_bn_stats.launches_by_variant
        if after[variant] - before[variant] != 2:
            raise RuntimeError(f"conv {name}: expected the {variant} variant, launches went "
                               f"{before} -> {after}")
        acc, want_stats = conv_bn.conv3x3_bn_stats_plain(x.float(), wt)
        err = (out.float() - acc).abs().max().item()
        serr = (stats - want_stats).abs().max().item()
        torch.testing.assert_close(out.float(), acc, atol=3e-2, rtol=0, msg=lambda m: f"conv {name} out: {m}")
        torch.testing.assert_close(stats, want_stats, atol=1.0, rtol=5e-3, msg=lambda m: f"conv {name} stats: {m}")
        if not (torch.equal(out, again[0]) and torch.equal(stats, again[1])):
            raise RuntimeError(f"conv {name}: two calls on the same inputs differ")
        log(f"conv kernel {name} {b}x{h}x{w}x{c}->{cout} {str(dtype)[6:]} ({variant}): out max|err| {err:.3e} "
            f"(atol 3e-2), stats max|err| {serr:.3e} (of max |stat| {want_stats.abs().max().item():.4g}); "
            f"deterministic")
        if name == "probe":
            probe_err = err
    return probe_err


def conv_probe_case(conv_bn):
    """fn(i) running the conv kernel at the probe's shape (256 x 14 x 14 x
    256 -> 256, bf16) on the probe's inputs: x standard normal (numpy seed
    0), w scaled by 1/sqrt(9C), x rotating through copies over twice the
    L2 cache."""
    rng = np.random.default_rng(0)
    b, hw, c = 256, 14, 256
    x = torch.from_numpy(rng.standard_normal((b, hw, hw, c), dtype=np.float32)).to("cuda", torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((3, 3, c, c), dtype=np.float32) / np.sqrt(9 * c))
    w = w.to("cuda", torch.bfloat16)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    copies = max(2, math.ceil(2 * l2 / (x.numel() * x.element_size())) + 1)
    xs = [x] + [x.clone() for _ in range(copies - 1)]
    return lambda i: conv_bn.conv3x3_bn_stats(xs[i % copies], w)


def run_conv_probe(conv_bn, tag) -> dict:
    """Phase 6d: the probe at its defaults, the conv kernel's main path,
    counts reset just before and read just after; then at R50's four
    shapes (20 steps each). Prints each record."""
    from rot_mvgaze_tpu_torch.probe_conv_bn_epilogue import run_probe

    reset_conv_counts(conv_bn)
    record = run_probe()
    launches = conv_bn.conv3x3_bn_stats.launches
    by_variant = dict(conv_bn.conv3x3_bn_stats.launches_by_variant)
    print(json.dumps({"conv_probe": record, "launches": launches, "launches_by_variant": by_variant,
                      **tag}), flush=True)
    if launches == 0:
        raise RuntimeError("the probe never launched the conv kernel")
    if by_variant["wgmma"] != launches:
        raise RuntimeError(f"probe conv launches by variant {by_variant}: not all wgmma")
    log(f"probe: kernel {record['kernel_ms']:.5f} ms, library conv {record['library_conv_ms']:.5f}, "
        f"conv + stats {record['library_conv_plus_stats_ms']:.5f}, plain {record['plain_ms']:.4f}, "
        f"bound {record['bound_ms']:.5f} ({record['bound_by']}): {record['verdict']}; "
        f"{launches} kernel launches")
    r50 = []
    for b, hw, c in R50_CONV_SHAPES:
        reset_conv_counts(conv_bn)
        rec = run_probe(batch=b, hw=hw, c=c, steps=20)
        shape_variants = conv_bn.conv3x3_bn_stats.launches_by_variant
        if shape_variants["wgmma"] != conv_bn.conv3x3_bn_stats.launches:
            raise RuntimeError(f"conv {b}x{hw}x{hw}x{c} launches by variant {shape_variants}: not all wgmma")
        rec["launches_by_variant"] = dict(shape_variants)
        r50.append(rec)
        print(json.dumps({"conv_probe_r50": rec, **tag}), flush=True)
        log(f"conv {b}x{hw}x{hw}x{c}: kernel {rec['kernel_ms']:.5f} ms, conv + stats "
            f"{rec['library_conv_plus_stats_ms']:.5f}, conv {rec['library_conv_ms']:.5f}, bound "
            f"{rec['bound_ms']:.5f} ({rec['bound_by']}): {rec['verdict']}")
    return {"record": record, "launches": launches, "by_variant": by_variant, "r50": r50}


def check_bn_kernels(batchnorm, cases) -> dict:
    """Phase 6a: every BN kernel against its plain version in float64 on
    the same inputs at each of ``cases`` (name, rows, C, relu, residual),
    and the two reductions called twice, bit for bit; returns each kernel's
    max |err| over the bf16 cases."""
    worst = {name: 0.0 for name in BN_KERNELS}
    for case, rows, c, relu, with_res in cases:
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(rows + c)
            x = (torch.randn(rows, c, device="cuda", generator=g) * 2 + 0.5).to(dtype)
            res = torch.randn(rows, c, device="cuda", generator=g).to(dtype) if with_res else None
            gy = torch.randn(rows, c, device="cuda", generator=g).to(dtype)
            scale = torch.rand(c, device="cuda", generator=g) + 0.5
            bias = torch.randn(c, device="cuda", generator=g) * 0.1
            gmean, gvar = torch.randn(c, device="cuda", generator=g), torch.randn(c, device="cuda", generator=g)
            want_dres = relu and with_res
            mean, var, rstd, a, b = batchnorm.bn_stats(x, scale, bias, 1e-5)
            y = batchnorm.bn_apply(x, a, b, res, relu)
            dscale, dbias, k, mg, mgx = batchnorm.bn_bwd_reduce(gy, y, x, mean, rstd, scale, relu)
            dx, dres = batchnorm.bn_bwd_dx(gy, y, x, mean, rstd, k, mg, mgx, gmean, gvar, relu, want_dres)
            # bf16: bn_stats and its plain version on the card agree bit for bit
            if dtype == torch.bfloat16:
                want = batchnorm.bn_stats_reference(x, scale, bias, 1e-5)
                if not all(map(torch.equal, (mean, var, rstd, a, b), want)):
                    raise RuntimeError(f"bn_stats {case} bf16: not bit for bit its plain version")
            # the reductions are deterministic: a second call agrees bit for bit
            again = (*batchnorm.bn_stats(x, scale, bias, 1e-5),
                     *batchnorm.bn_bwd_reduce(gy, y, x, mean, rstd, scale, relu))
            torch.cuda.synchronize()
            for got_t, again_t in zip((mean, var, rstd, a, b, dscale, dbias, k, mg, mgx), again):
                if not torch.equal(got_t, again_t):
                    raise RuntimeError(f"bn {case} {dtype}: two reduction calls differ")

            def d(t):
                return None if t is None else t.double()

            pm, pv, pr, pa, pb = batchnorm.bn_stats_reference(d(x), d(scale), d(bias), 1e-5)
            py = batchnorm.bn_apply_reference(d(x), pa, pb, d(res), relu)
            # the plain backward takes the kernel's y: one ReLU mask for both
            pds, pdb, pk, pmg, pmgx = batchnorm.bn_bwd_reduce_reference(
                d(gy), d(y), d(x), pm, pr, d(scale), relu)
            pdx, pdres = batchnorm.bn_bwd_dx_reference(
                d(gy), d(y), d(x), pm, pr, pk, pmg, pmgx, d(gmean), d(gvar), relu, want_dres)
            f32 = dtype == torch.float32
            checks = [
                ("bn_stats", mean, pm, BN_FWD_TOL), ("bn_stats", var, pv, BN_FWD_TOL),
                ("bn_apply", y, py, BN_FWD_TOL if f32 else BN_BF16_TOL),
                ("bn_bwd_reduce", dscale, pds, BN_GRAD_TOL), ("bn_bwd_reduce", dbias, pdb, BN_GRAD_TOL),
                ("bn_bwd_dx", dx, pdx, BN_GRAD_TOL if f32 else BN_BF16_TOL),
            ]
            if want_dres:
                checks.append(("bn_bwd_dx", dres, pdres, (0.0, 0.0)))
            errs = {}
            for name, got, want, (atol, rtol) in checks:
                err = (got.double() - want).abs().max().item()
                errs[name] = max(errs.get(name, 0.0), err)
                torch.testing.assert_close(got.double(), want, atol=atol, rtol=rtol,
                                           msg=lambda m: f"{name} {case} {dtype}: {m}")
                if not f32:
                    worst[name] = max(worst[name], err)
            log(f"bn kernels {case} {rows}x{c} relu={relu} res={with_res} {str(dtype)[6:]}: "
                + ", ".join(f"{n} max|err| {e:.3e}" for n, e in errs.items()))
    return worst


def check_fusion_grads(fusion) -> None:
    """Phase 6b: the fusion Function (kernel forward, plain-product backward)
    against autograd through its plain version at B=64. f32: atol 5e-4 /
    rtol 1e-3 (the JAX suite's gradient bar); bf16: norm-relative 2e-2,
    since h is rounded to bf16 on both sides and an h within rounding of 0
    may take the ReLU mask either way."""
    for dtype in (torch.float32, torch.bfloat16):
        (img, feat, rot), [(w1, b1)] = fusion_inputs(B, D, V, H, dtype, seed=11)
        gout = torch.randn(B, H, device="cuda", generator=torch.Generator(device="cuda").manual_seed(5)).to(dtype)

        def grads(fn):
            leaves = [t.detach().clone().requires_grad_(True) for t in (img, feat, rot, w1, b1)]
            fn(*leaves).backward(gout)
            return [t.grad.float() for t in leaves]

        got = grads(fusion.RotateConcatMatmulRelu.apply)
        want = grads(fusion.rotate_concat_matmul_relu_reference)
        rel = []
        for name, a, b in zip(("img", "feat", "rot", "w1", "b1"), got, want):
            r = float((a - b).norm() / b.norm())
            rel.append(f"{name} {r:.2e}")
            if dtype == torch.float32:
                torch.testing.assert_close(a, b, atol=5e-4, rtol=1e-3, msg=lambda m: f"d{name}: {m}")
            elif not r < 2e-2:
                raise RuntimeError(f"bf16 fusion gradient d{name} off by {r:.3e} (norm-relative)")
        log(f"fusion gradients {str(dtype)[6:]} B={B}: norm-relative error " + ", ".join(rel))


# ---------------------------------------------------------------------------
# training (phase 7)
# ---------------------------------------------------------------------------


def training_batch(seed: int, pairs: int = PAIRS, views: int = 2) -> dict:
    """Seeded uint8 views and float labels of ``pairs`` stereo pairs, or
    with ``views > 2`` of that many frames of V views ({imgs, head_poses,
    gt_gazes})."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def poses(*shape):
        return torch.rand(*shape, 2, generator=g, device="cuda") * 1.2 - 0.6

    if views > 2:
        return {"imgs": torch.randint(0, 256, (pairs, views, 224, 224, 3), dtype=torch.uint8, device="cuda",
                                      generator=g),
                "head_poses": poses(pairs, views), "gt_gazes": poses(pairs, views)}
    return {
        "img_0": torch.randint(0, 256, (pairs, 224, 224, 3), dtype=torch.uint8, device="cuda", generator=g),
        "img_1": torch.randint(0, 256, (pairs, 224, 224, 3), dtype=torch.uint8, device="cuda", generator=g),
        "head_pose_0": poses(pairs), "head_pose_1": poses(pairs), "gt_gaze": poses(pairs),
        "gt_gaze_1": poses(pairs),
    }


def family_views(flags) -> int:
    return flags.get("num_views", 2)


def family_model(flags):
    """R50 x 3 of a configuration: FeatRotationSymm with its model flags, or
    FeatRotationMultiView for num_views > 2 (phase 10; {} is the default
    model of phases 7-9)."""
    from rot_mvgaze_tpu_torch.models import FeatRotationMultiView, FeatRotationSymm

    cls = FeatRotationMultiView if family_views(flags) > 2 else FeatRotationSymm
    return cls(backbone_depth=50, num_iter=3, **{k: v for k, v in flags.items() if k != "num_views"})


def family_metrics(flags):
    from rot_mvgaze_tpu_torch.losses import IterationLoss, MultiViewL1Loss, StereoL1Loss

    loss = MultiViewL1Loss if family_views(flags) > 2 else StereoL1Loss
    return IterationLoss(loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)


def make_trainer(state, dtype, grad_accum=1, flags=None, group=None):
    """(model, train_step) from a saved state dict: R50 x 3 iterations of
    the configuration ``flags`` (family_model); ``group``: data-parallel
    over that process group (the BNs' statistics and the step's)."""
    from rot_mvgaze_tpu_torch import parallel
    from rot_mvgaze_tpu_torch.train import (
        cyclic_triangular2,
        make_multiview_train_step,
        make_optimizer,
        make_train_step,
    )

    flags = flags or {}
    model = family_model(flags)
    model.load_state_dict(state, strict=True)
    model = model.to(device="cuda", memory_format=torch.channels_last)
    parallel.set_batchnorm_group(model, group)
    options = dict(image_size=224, schedule=cyclic_triangular2(1e-6, 1e-3, step_size_up=50, step_size_down=50),
                   compute_dtype=dtype, group=group)
    if family_views(flags) > 2:
        return model, make_multiview_train_step(model, family_metrics(flags),
                                                make_optimizer(model.parameters()), **options)
    return model, make_train_step(model, family_metrics(flags), make_optimizer(model.parameters()),
                                  grad_accum=grad_accum, **options)


def launch_counts(fusion, batchnorm) -> dict:
    from rot_mvgaze_tpu_torch.ops import conv_bn

    counts = {name: getattr(batchnorm, name).launches for name in BN_KERNELS}
    counts["fusion"] = fusion.rotate_concat_matmul_relu.launches
    counts["conv3x3_bn_stats"] = conv_bn.conv3x3_bn_stats.launches
    return counts


def reset_conv_counts(conv_bn) -> None:
    conv_bn.conv3x3_bn_stats.launches = 0
    conv_bn.conv3x3_bn_stats.launches_by_variant = dict.fromkeys(conv_bn.VARIANTS, 0)


def reset_counts(fusion, batchnorm) -> None:
    from rot_mvgaze_tpu_torch.ops import conv_bn

    for name in BN_KERNELS:
        getattr(batchnorm, name).launches = 0
    fusion.rotate_concat_matmul_relu.launches = 0
    fusion.rotate_concat_matmul_relu.launches_by_variant = dict.fromkeys(fusion.VARIANTS, 0)
    reset_conv_counts(conv_bn)


# the conv kernel has no launch on the step, as in JAX (its only caller is the probe)
PER_STEP = {"bn_stats": 106, "bn_apply": 106, "bn_bwd_reduce": 106, "bn_bwd_dx": 106, "fusion": 6,
            "conv3x3_bn_stats": 0}


def record_bn_shapes(model, shapes: list) -> list:
    """Forward pre-hooks that append ((N, C, H, W), relu, residual) of each
    BatchNormAct call in ``model`` to ``shapes``; returns the hooks."""
    from rot_mvgaze_tpu_torch.models.norm import BatchNormAct

    return [m.register_forward_pre_hook(
        lambda mod, args: shapes.append((tuple(args[0].shape), mod.relu, len(args) > 1 and args[1] is not None)))
        for m in model.modules() if isinstance(m, BatchNormAct)]


def run_training(fusion, batchnorm, n_warm=2, n_timed=10) -> dict:
    """Phase 7a, the main path: bf16 steps with launch counts per step."""
    torch.manual_seed(0)
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm

    state = FeatRotationSymm(backbone_depth=50, num_iter=3).state_dict()
    model, step = make_trainer(state, torch.bfloat16)
    batch = training_batch(seed=21)
    gen = torch.Generator(device="cuda").manual_seed(22)

    # record the shapes of the step's 106 BN calls (for the timings)
    shapes = []
    hooks = record_bn_shapes(model, shapes)
    updates = itertools.count()  # the schedule's count
    losses = [step(batch, gen, step=next(updates))["loss_gaze"]]
    for h in hooks:
        h.remove()
    for _ in range(n_warm - 1):
        losses.append(step(batch, gen, step=next(updates))["loss_gaze"])
    torch.cuda.synchronize()

    # --- main path: counts reset just before each step, read just after
    torch.cuda.reset_peak_memory_stats()
    batchnorm.fused_batchnorm_act.grad_copies = 0
    totals = {k: 0 for k in PER_STEP}
    by_variant = dict.fromkeys(fusion.VARIANTS, 0)
    t0 = time.perf_counter()
    for _ in range(n_timed):
        reset_counts(fusion, batchnorm)
        losses.append(step(batch, gen, step=next(updates))["loss_gaze"])
        counts = launch_counts(fusion, batchnorm)
        if counts != PER_STEP:
            raise RuntimeError(f"launches per step {counts} != {PER_STEP}")
        step_variants = fusion.rotate_concat_matmul_relu.launches_by_variant
        if step_variants["wgmma"] != PER_STEP["fusion"]:
            raise RuntimeError(f"fusion launches by variant in a step {step_variants}: not all wgmma")
        for k, n in counts.items():
            totals[k] += n
        for k, n in step_variants.items():
            by_variant[k] += n
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    loss_values = torch.stack(losses).float().cpu().numpy()
    if not np.all(np.isfinite(loss_values)):
        raise RuntimeError(f"non-finite training loss: {loss_values}")
    log(f"training: {n_warm} warm-up + {n_timed} timed steps, losses {np.round(loss_values, 5).tolist()}")
    log(f"training launches over the timed steps: {totals} ({n_timed} x {PER_STEP}); "
        f"grad layout copies {batchnorm.fused_batchnorm_act.grad_copies}")
    if len(shapes) != 106:
        raise RuntimeError(f"{len(shapes)} BN calls in a step, expected 106")

    copies = {"grad_copies": batchnorm.fused_batchnorm_act.grad_copies}

    def profile_step():
        step(batch, gen, step=next(updates))
        torch.cuda.synchronize()

    breakdown = profile_device(profile_step, n_iter=3)
    ms = wall / n_timed * 1e3
    return {
        "launches": totals, "fusion_by_variant": by_variant, "step_ms": ms, "imgs_per_s": 2 * PAIRS * n_timed / wall,
        "peak_mib": peak_mib, "profile": breakdown, "bn_shapes": shapes, **copies,
    }


def reference_step_f64(state, batch, seed, grad_accum=1, flags=None):
    """(loss, grads) of one step's forward and backward in float64 through
    the plain versions, on the step's own augmented views (micro-batch a of
    ``grad_accum`` takes rows a::grad_accum, gradients summed, then divided,
    as the train step does): the yardstick for how closely any float32 step
    can reach the true gradient. ``flags``: the configuration (family_model)."""
    from rot_mvgaze_tpu_torch.augment.ops import train_preprocess
    from rot_mvgaze_tpu_torch.train.multiview_steps import prepare_multiview_rotations
    from rot_mvgaze_tpu_torch.train.steps import augment_views, prepare_rotations

    flags = flags or {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = family_model(flags)
    model.load_state_dict(state, strict=True)
    model = model.to(device="cuda", dtype=torch.float64, memory_format=torch.channels_last).train()
    metrics = family_metrics(flags)
    total = 0.0
    for a in range(grad_accum):
        mb = {k: v[a::grad_accum] for k, v in batch.items()}
        if family_views(flags) > 2:
            imgs = mb["imgs"]
            flat = train_preprocess(imgs.reshape((-1,) + tuple(imgs.shape[2:])), gen, 224, torch.float32)
            data = {"imgs": flat.reshape(imgs.shape[:2] + flat.shape[1:]).double(),
                    **prepare_multiview_rotations(mb)}
        else:
            data = {**augment_views(gen, mb, 224, torch.float32), **prepare_rotations(mb)}
            data = {k: (v.double() if k.startswith("img") else v) for k, v in data.items()}
        with plain_kernels():
            loss = metrics(model(data))
            loss.backward()
        total += float(loss.detach())
    grads = {n: p.grad.detach() / grad_accum for n, p in model.named_parameters() if p.grad is not None}
    return total / grad_accum, grads


def check_training_paths(fusion, batchnorm) -> dict:
    """Phase 7b: from one saved state, one step through the kernels and one
    through the plain versions, in f32 (TF32 off) and in bf16: at 64 pairs
    with grad_accum 1 and 2 (the trainer phase's micro-batches of 32 pairs,
    whose BN calls have half the rows), and at 50 pairs with grad_accum 1
    (the command line phase's batch, whose row counts set other BN plans).
    The bars are compare_paths'."""
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm

    torch.manual_seed(1)
    state = FeatRotationSymm(backbone_depth=50, num_iter=3).state_dict()
    out = {}
    for (pairs, accum), dtype in itertools.product(((PAIRS, 1), (PAIRS, 2), (CLI_BATCH, 1)),
                                                   (torch.float32, torch.bfloat16)):
        name = (str(dtype)[6:] + ("" if accum == 1 else f"_accum{accum}")
                + ("" if pairs == PAIRS else f"_b{pairs}"))
        out.update(compare_paths(fusion, batchnorm, f"train step {name}", name, state,
                                 training_batch(seed=31, pairs=pairs), dtype,
                                 {k: accum * n for k, n in PER_STEP.items()}, grad_accum=accum))
    return out


def compare_paths(fusion, batchnorm, label, name, state, batch, dtype, per_step, grad_accum=1, flags=None,
                  seed=32) -> dict:
    """One update through the kernels and one through the plain versions,
    each from ``state`` with a generator seeded ``seed``; the kernel update
    launches ``per_step``, the plain one nothing. Returns the readings,
    keyed ``name_*``.

    f32 bars: loss rtol 1e-4, and every gradient within atol 5e-3 / rtol
    5e-2 of the plain path's (the JAX bar for Pallas BN against XLA through
    a ResNet, tests/test_pallas_bn.py:160-161) wherever a float32 step can
    meet that bar at all, i.e. where the plain f32 gradient is within it of
    a float64 step's. Through the random-init R50 at 64 pairs the backward
    amplifies rounding: the stem convolution's f32 gradient, kernel or
    plain, lies about 2% (norm-relative) from the f64 one. There the kernel
    path must be no farther from f64 than the plain path (norm-relative
    error at most 1.5x the plain path's). bf16 bars: loss within 1% and
    mean angular delta of pred_gaze <= 0.1 deg."""
    from rot_mvgaze_tpu_torch.geometry import angular_error_numpy

    runs = []
    for plain in (False, True):
        model, step = make_trainer(state, dtype, grad_accum=grad_accum, flags=flags)
        reset_counts(fusion, batchnorm)
        with plain_kernels() if plain else contextlib.nullcontext():
            stats = step(batch, torch.Generator(device="cuda").manual_seed(seed), step=0)
        counts = launch_counts(fusion, batchnorm)
        if counts != ({k: 0 for k in PER_STEP} if plain else per_step):
            raise RuntimeError(f"{'plain' if plain else 'kernel'} update ({name}) launched {counts}")
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
        runs.append((float(stats["loss_gaze"]), stats["pred_gaze"].float().cpu().numpy(), grads))
        del model, step
        torch.cuda.empty_cache()
    (lk, pk, gk), (lp, pp, gp) = runs
    if set(gk) != set(gp):
        raise RuntimeError(f"kernel and plain updates ({name}) reached different parameters")
    out = {}
    if dtype == torch.float32:
        np.testing.assert_allclose(lk, lp, rtol=1e-4)
        l64, g64 = reference_step_f64(state, batch, seed=seed, grad_accum=grad_accum, flags=flags)
        worst, ill = hold_f32_grads(name, gk, gp, g64)
        del g64
        log(f"{label}, kernel vs plain: loss {lk:.8f} vs {lp:.8f} (f64 {l64:.8f}); "
            f"{len(gk) - len(ill)} of {len(gk)} gradients within atol 5e-3 / rtol 5e-2, max "
            f"|diff| {worst:.3e}; beyond f32's reach (plain f32 outside that bar of f64), "
            f"norm-relative error against f64: {ill}")
        out[f"{name}_max_grad_diff"], out[f"{name}_ill_conditioned"] = worst, ill
    else:
        rel = abs(lk - lp) / abs(lp)
        delta = float(angular_error_numpy(pk, pp).mean())
        log(f"{label}, kernel vs plain: loss {lk:.6f} vs {lp:.6f} (rel {rel:.2e}, bar 1e-2); "
            f"pred_gaze mean angular delta {delta:.4e} deg (bar 0.1)")
        if not (rel <= 1e-2 and delta <= 0.1):
            raise RuntimeError(f"{name} kernel path deviates: loss rel {rel}, {delta} deg")
        out[f"{name}_loss_rel"], out[f"{name}_delta_deg"] = rel, delta
    out[f"{name}_loss_kernel"], out[f"{name}_loss_plain"] = lk, lp
    del gk, gp
    torch.cuda.empty_cache()
    return out


def hold_f32_grads(name, gk, gp, g64) -> tuple:
    """compare_paths' f32 gradient bars: ``gk`` (the path under test) within
    atol 5e-3 / rtol 5e-2 of ``gp`` (its yardstick) wherever ``gp`` is within
    that bar of the float64 step ``g64``; elsewhere no farther from f64
    (norm-relative) than 1.5x ``gp``. Returns (max |diff| under the bar,
    {name: errors} of the others)."""
    worst, ill = 0.0, {}
    for n in gk:
        ref = g64[n]
        if torch.allclose(gp[n].double(), ref, atol=5e-3, rtol=5e-2):
            worst = max(worst, (gk[n] - gp[n]).abs().max().item())
            torch.testing.assert_close(gk[n], gp[n], atol=5e-3, rtol=5e-2,
                                       msg=lambda m: f"grad {n} ({name}): {m}")
            continue
        ek = float((gk[n].double() - ref).norm() / ref.norm())
        ep = float((gp[n].double() - ref).norm() / ref.norm())
        ill[n] = {"kernel_vs_f64": ek, "plain_vs_f64": ep}
        if not ek <= 1.5 * ep:
            raise RuntimeError(f"grad {n} ({name}): {ek:.3e} from f64, its yardstick {ep:.3e}")
    return worst, ill


def bn_bytes(kind, rows, c, itemsize, relu, res) -> int:
    """Bytes a BN pass must move: each (rows, C) input read once, each output
    written once, plus its per-channel f32 vectors."""
    t = rows * c * itemsize
    if kind == "bn_stats":
        return t + 4 * 7 * c  # x; scale, bias in; mean, var, rstd, a, b out
    if kind == "bn_apply":
        return t * (3 if res else 2) + 4 * 2 * c
    if kind == "bn_bwd_reduce":
        return t * (3 if relu else 2) + 4 * 8 * c
    return t * ((3 if relu else 2) + 1 + (1 if relu and res else 0)) + 4 * 5 * c  # bn_bwd_dx


BN_OPS_PER_ELEMENT = {"bn_stats": 3, "bn_apply": 4, "bn_bwd_reduce": 6, "bn_bwd_dx": 8}
F32_FLOPS = 67e12  # H100 SXM, outside the tensor cores


def bn_calls(batchnorm, shapes, seed=41) -> list:
    """Seeded bf16 inputs of every BN call in ``shapes`` (((N, C, H, W),
    relu, residual) as run_training records them), and each call's forward
    outputs and backward sums from the kernels, as views (rows, C) and NCHW."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    calls = []
    for (n, c, h, w), relu, res in shapes:
        rows = n * h * w
        x = torch.randn(rows, c, device="cuda", generator=g).to(torch.bfloat16)
        r = torch.randn(rows, c, device="cuda", generator=g).to(torch.bfloat16) if res else None
        gy = torch.randn(rows, c, device="cuda", generator=g).to(torch.bfloat16)
        scale = torch.rand(c, device="cuda", generator=g) + 0.5
        bias = torch.randn(c, device="cuda", generator=g) * 0.1
        mean, var, rstd, a, b = batchnorm.bn_stats(x, scale, bias, 1e-5)
        y = batchnorm.bn_apply(x, a, b, r, relu)
        _, _, k, mg, mgx = batchnorm.bn_bwd_reduce(gy, y, x, mean, rstd, scale, relu)
        x4 = x.view(n, h, w, c).permute(0, 3, 1, 2)
        calls.append(dict(rows=rows, c=c, relu=relu, res=res, x=x, r=r, gy=gy, y=y, scale=scale,
                          bias=bias, mean=mean, rstd=rstd, a=a, b=b, k=k, mg=mg, mgx=mgx, x4=x4,
                          r4=None if r is None else r.view(n, h, w, c).permute(0, 3, 1, 2),
                          g4=gy.view(n, h, w, c).permute(0, 3, 1, 2),
                          y4=y.view(n, h, w, c).permute(0, 3, 1, 2)))
    torch.cuda.synchronize()
    return calls


def bn_runner(batchnorm, calls, kind, plain=False):
    """fn(i) that runs one BN kernel (or its plain version) over ``calls``."""
    fn = getattr(batchnorm, f"{kind}_reference" if plain else kind)

    def run(_):
        for q in calls:
            if kind == "bn_stats":
                fn(q["x"], q["scale"], q["bias"], 1e-5)
            elif kind == "bn_apply":
                fn(q["x"], q["a"], q["b"], q["r"], q["relu"])
            elif kind == "bn_bwd_reduce":
                fn(q["gy"], q["y"], q["x"], q["mean"], q["rstd"], q["scale"], q["relu"])
            else:
                fn(q["gy"], q["y"], q["x"], q["mean"], q["rstd"], q["k"], q["mg"], q["mgx"],
                   None, None, q["relu"], q["relu"] and q["res"])
    return run


def profiled_ms(fn) -> float:
    """Device ms per call of fn(0) by the profiler (kernel durations summed,
    3 calls), for the plain and library BN calls: they allocate and launch
    enough on the host that events around them would also count host gaps,
    and more launches than the device queue holds ahead. A kernel record
    the profiler drops makes this read low (seen on the card late in long
    runs), which can only favour these baselines."""
    return profile_device(lambda: (fn(0), torch.cuda.synchronize()), n_iter=3)[
        "device_busy_ms_per_call"]


def device_ms(fn, n_iter=3) -> float:
    """Device ms per call of fn(0), for the port's kernels: CUDA events
    around ``n_iter`` calls, queued behind a device-side sleep and one
    untimed call, so that the timed calls follow kernels of their own kind
    rather than the sleep. The host must have enqueued every launch while the sleep still
    runs (the start event is still pending when it is done; else the sleep
    grows fourfold, to at most about 2 s, and then this fails), so the span
    holds the kernels and the device's own gaps between them, and no host
    gap. Unlike the profiler, events drop nothing."""
    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    while True:
        torch.cuda._sleep(cycles)
        fn(0)
        start.record()
        for _ in range(n_iter):
            fn(0)
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / n_iter
        if cycles >= 4_000_000_000:
            raise RuntimeError("device_ms: the host's enqueue outlasted a 4e9-cycle device sleep")
        cycles *= 4


def bn_by_shape(batchnorm, calls, kind) -> list:
    """One BN kernel by distinct shape of the step's calls: the shape's
    calls, device ms summed over them (device_ms of the shape's calls
    alone), bytes, bound and the bound's share of the time. A shape is
    (rows, C), and for every kernel but bn_stats, which reads x alone, also
    whether the call has ReLU and a residual."""
    groups: dict = {}
    for q in calls:
        extra = () if kind == "bn_stats" else (q["relu"], q["res"])
        groups.setdefault((q["rows"], q["c"]) + extra, []).append(q)
    out = []
    for key, qs in groups.items():
        nbytes = sum(bn_bytes(kind, q["rows"], q["c"], 2, q["relu"], q["res"]) for q in qs)
        ms = device_ms(bn_runner(batchnorm, qs, kind))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rec = {"rows": key[0], "c": key[1]}
        if kind != "bn_stats":
            rec.update(relu=key[2], res=key[3])
        out.append({**rec, "calls": len(qs), "ms": ms, "bytes": nbytes, "bound_ms": bound,
                    "share_of_bound": bound / ms})
    return sorted(out, key=lambda g: -g["ms"])


def log_by_shape(kind, tables) -> None:
    for run, table in enumerate(tables):
        log(f"{kind} by shape, run {run + 1}: total {sum(g['ms'] for g in table):.4f} ms; "
            + "; ".join(f"{g['rows']}x{g['c']}{' relu' if g.get('relu') else ''}"
                        f"{' res' if g.get('res') else ''} x{g['calls']}: {g['ms']:.4f} ms, "
                        f"{g['share_of_bound']:.1%} of bound" for g in table))


def time_bn(batchnorm, shapes) -> dict:
    """Phase 7c: each BN kernel over the step's 106 BN calls (one call of the
    timed function = all 106, at their shapes, bf16), its plain version, the
    library calls for the same functions, and the bounds. Times are device
    time over 3 passes: the kernels' by CUDA events behind a device sleep
    (device_ms), the plain and library calls' by the profiler (profiled_ms),
    so host gaps count in neither."""
    import torch.nn.functional as F

    calls = bn_calls(batchnorm, shapes)

    def library_forward(_):
        for q in calls:
            out = F.batch_norm(q["x4"], None, None, q["scale"], q["bias"], True, 0.0, 1e-5)
            if q["r4"] is not None:
                out = out + q["r4"]
            if q["relu"]:
                out = out.relu_()

    saved = [torch.ops.aten.native_batch_norm(q["x4"], q["scale"], q["bias"], None, None, True, 0.0, 1e-5)
             for q in calls]

    def library_backward(_):
        for q, (_, smean, sinv) in zip(calls, saved):
            gg = torch.ops.aten.threshold_backward(q["g4"], q["y4"], 0) if q["relu"] else q["g4"]
            torch.ops.aten.native_batch_norm_backward(
                gg, q["x4"], q["scale"], None, None, smean, sinv, True, 1e-5, [True, True, True])

    # one library call per kernel, on the same inputs (the counterparts
    # of the four kernels' functions; none is called by the port)
    aten = torch.ops.aten
    lib_stats = [aten.batch_norm_stats(q["x4"], 1e-5) for q in calls]
    lib_sums = [aten.batch_norm_backward_reduce(q["g4"], q["x4"], m, inv, q["scale"], True, True, True)
                for q, (m, inv) in zip(calls, lib_stats)]
    counts = [torch.tensor([q["rows"]], dtype=torch.int32, device="cuda") for q in calls]

    def library_stats(_):
        for q in calls:
            aten.batch_norm_stats(q["x4"], 1e-5)

    def library_apply(_):
        for q, (m, inv) in zip(calls, lib_stats):
            out = aten.batch_norm_elemt(q["x4"], q["scale"], q["bias"], m, inv, 1e-5)
            if q["r4"] is not None:
                out.add_(q["r4"])
            if q["relu"]:
                out.relu_()

    def library_bwd_reduce(_):
        for q, (m, inv) in zip(calls, lib_stats):
            gg = aten.threshold_backward(q["g4"], q["y4"], 0) if q["relu"] else q["g4"]
            aten.batch_norm_backward_reduce(gg, q["x4"], m, inv, q["scale"], True, True, True)

    def library_bwd_dx(_):
        for q, (m, inv), sums, n in zip(calls, lib_stats, lib_sums, counts):
            gg = aten.threshold_backward(q["g4"], q["y4"], 0) if q["relu"] else q["g4"]
            aten.batch_norm_backward_elemt(gg, q["x4"], m, inv, q["scale"], sums[0], sums[1], n)

    library = {
        "bn_stats": (library_stats, "torch.batch_norm_stats"),
        "bn_apply": (library_apply, "torch.batch_norm_elemt, then add_ and relu_ where the call has them"),
        "bn_bwd_reduce": (library_bwd_reduce,
                          "threshold_backward under ReLU + torch.batch_norm_backward_reduce"),
        "bn_bwd_dx": (library_bwd_dx, "threshold_backward under ReLU + torch.batch_norm_backward_elemt"),
    }

    out = {}
    for kind in BN_KERNELS:
        kernel, plain = bn_runner(batchnorm, calls, kind), bn_runner(batchnorm, calls, kind, True)
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1, k1 = profiled_ms(plain), device_ms(kernel)
        k2, p2 = device_ms(kernel), profiled_ms(plain)
        nbytes = sum(bn_bytes(kind, q["rows"], q["c"], 2, q["relu"], q["res"]) for q in calls)
        ops = sum(BN_OPS_PER_ELEMENT[kind] * q["rows"] * q["c"] for q in calls)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        lib_fn, covers = library[kind]
        lib_ms = profiled_ms(lib_fn)
        out[kind] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes,
                     "library_ms": lib_ms, "library_covers": covers}
        log(f"{kind} over the step's {len(calls)} calls (device ms): kernel {k1:.4f}/{k2:.4f}, "
            f"plain {p1:.4f}/{p2:.4f}, library {lib_ms:.4f} ({covers}), bound "
            f"{max(t_bytes, t_ops):.4f} ({nbytes} bytes; {ops} ops)")
    # bn_stats and bn_bwd_dx by shape, twice: where the gap to the bound
    # lies, and the spread
    for kind in ("bn_stats", "bn_bwd_dx"):
        out[kind]["by_shape"] = [bn_by_shape(batchnorm, calls, kind) for _ in range(2)]
        log_by_shape(kind, out[kind]["by_shape"])
    lib_fwd = profiled_ms(library_forward)
    lib_bwd = profiled_ms(library_backward)
    log(f"library pairs per step (device ms): F.batch_norm(training) + add + relu {lib_fwd:.4f} vs "
        f"bn_stats + bn_apply {out['bn_stats']['ms'] + out['bn_apply']['ms']:.4f}; "
        f"threshold_backward + native_batch_norm_backward {lib_bwd:.4f} vs bn_bwd_reduce + "
        f"bn_bwd_dx {out['bn_bwd_reduce']['ms'] + out['bn_bwd_dx']['ms']:.4f}")
    for kind in ("bn_stats", "bn_apply"):
        out[kind]["library_pair_ms"] = lib_fwd
        out[kind]["library_pair_covers"] = "F.batch_norm(training) + add + relu: bn_stats and bn_apply"
    for kind in ("bn_bwd_reduce", "bn_bwd_dx"):
        out[kind]["library_pair_ms"] = lib_bwd
        out[kind]["library_pair_covers"] = ("threshold_backward + native_batch_norm_backward: "
                                            "bn_bwd_reduce and bn_bwd_dx")
    return out


# ---------------------------------------------------------------------------
# the trainer (phase 8)
# ---------------------------------------------------------------------------


def port_trainer(out_dir, train_ds, test_ds, **overrides):
    """A Trainer on the card: R50 x 3 from seeded weights, bf16, 64 pairs per
    step (drop_last), eval batches of 64, 2 epochs, a save and a print every
    epoch and step."""
    from types import SimpleNamespace

    from rot_mvgaze_tpu_torch.data import BatchLoader
    from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm
    from rot_mvgaze_tpu_torch.train import Trainer

    cfg = dict(output_dir=out_dir, epochs=2, save_epoch=1, print_freq=1, seed=0, image_size=224,
               bf16=True, scheduler_step="epoch", base_lr=1e-6, max_lr=1e-3)
    cfg.update(overrides)
    torch.manual_seed(0)
    return Trainer(SimpleNamespace(**cfg), FeatRotationSymm(backbone_depth=50, num_iter=3),
                   IterationLoss(StereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5),
                   BatchLoader(train_ds, PAIRS, shuffle=True, drop_last=True),
                   BatchLoader(test_ds, PAIRS), device="cuda")


def record_steps(trainer, fusion, batchnorm) -> list:
    """Wrap the trainer's step: each update appends its launch counts (the
    counters' change over the step), wgmma fuser launches, loss and preview
    shape to the returned list."""
    steps, step_fn = [], trainer._train_step

    def recorded(batch, generator=None, *, step):
        before = launch_counts(fusion, batchnorm)
        wgmma = fusion.rotate_concat_matmul_relu.launches_by_variant["wgmma"]
        stats = step_fn(batch, generator, step=step)
        after = launch_counts(fusion, batchnorm)
        steps.append({"step": step, "loss": float(stats["loss_gaze"]),
                      "counts": {k: after[k] - before[k] for k in after},
                      "wgmma": fusion.rotate_concat_matmul_relu.launches_by_variant["wgmma"] - wgmma,
                      "preview": tuple(stats["img_0"].shape)})
        return stats

    trainer._train_step = recorded
    return steps


def check_steps(name, steps, per_step, n_steps) -> None:
    """Every recorded update launched ``per_step`` (each fuser launch of the
    wgmma variant), gave a finite loss and (8, 224, 224, 3) previews."""
    if len(steps) != n_steps:
        raise RuntimeError(f"trainer {name}: {len(steps)} updates, expected {n_steps}")
    for s in steps:
        if s["counts"] != per_step or s["wgmma"] != per_step["fusion"]:
            raise RuntimeError(f"trainer {name}, update {s['step']}: launches {s['counts']} "
                               f"({s['wgmma']} wgmma) != {per_step}")
        if not math.isfinite(s["loss"]) or s["preview"] != (8, 224, 224, 3):
            raise RuntimeError(f"trainer {name}, update {s['step']}: loss {s['loss']}, "
                               f"preview {s['preview']}")
    log(f"trainer {name}: {n_steps} updates, each {per_step} launches, losses "
        f"{[round(s['loss'], 5) for s in steps]}")


def run_trainer_phase(fusion, batchnorm, bare_imgs_per_s, keep_dir) -> dict:
    """Phase 8: the port's Trainer on the card through its own BatchLoader
    and prefetch. Returns the main path's launch counts, the numbers and a
    copy of the epoch-1 checkpoint in ``keep_dir`` (phase 10 loads it: the
    model after one epoch, before max_lr's second epoch throws it off)."""
    from rot_mvgaze_tpu_torch.compat import read_checkpoint
    from rot_mvgaze_tpu_torch.data import InMemoryGazeDataset
    from rot_mvgaze_tpu_torch.evaluate import EVAL_KEYS
    from rot_mvgaze_tpu_torch.geometry import angular_error_numpy
    from rot_mvgaze_tpu_torch.models.norm import BatchNormAct
    from rot_mvgaze_tpu_torch.serving import GazePredictor

    t_phase = time.perf_counter()
    # GazeDataset's samples with no h5py: learnable synthetic subjects, 224x224;
    # 216 training pairs (3 updates per epoch), 72 test pairs (batches of 64 + 8)
    train_ds = InMemoryGazeDataset(2, n_frames=6, image_size=224, seed=0, learnable=True)
    test_ds = InMemoryGazeDataset(1, n_frames=4, image_size=224, seed=100, learnable=True)
    torch.cuda.reset_peak_memory_stats()
    no_bn = dict.fromkeys(BN_KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        # --- main path: 2 epochs; counts set to 0 just before, read just after
        full = port_trainer(os.path.join(tmp, "full"), train_ds, test_ds)
        bare_step = full._train_step
        steps = record_steps(full, fusion, batchnorm)
        reset_counts(fusion, batchnorm)
        error = full.train()
        launches = launch_counts(fusion, batchnorm)
        by_variant = dict(fusion.rotate_concat_matmul_relu.launches_by_variant)
        check_steps("main path", steps, PER_STEP, 6)
        evals = 3 * 2 * 6  # 3 evaluations of 2 batches, 6 float32 fuser launches each
        want = {**{k: 6 * n for k, n in PER_STEP.items()}, "fusion": 6 * 6 + evals}
        if launches != want or by_variant != {"wgmma": 36, "generic": evals}:
            raise RuntimeError(f"trainer main path launched {launches} {by_variant}, expected {want}")
        ckpts = sorted(os.listdir(full.ckpt_dir))
        if len(ckpts) != 2 or not math.isfinite(error):
            raise RuntimeError(f"trainer main path: error {error}, checkpoints {ckpts}")
        epoch_1, epoch_2 = (os.path.join(full.ckpt_dir, c) for c in ckpts)
        kept = shutil.copy(epoch_1, os.path.join(keep_dir, "stereo_epoch_1.pth.tar"))

        # the checkpoint's state dict strictly in GazePredictor, float32,
        # against the Trainer's last evaluation
        pred = GazePredictor(epoch_2, backbone_depth=50, num_iter=3, micro_batch=PAIRS,
                             image_size=224, dtype=torch.float32, device="cuda")
        samples = [test_ds[i] for i in range(len(test_ds))]
        batch = {k: np.stack([s[k] for s in samples]) for k in EVAL_KEYS}
        served = pred.predict(*(batch[k] if k.startswith("img") else batch[k].astype(np.float32)
                                for k in EVAL_KEYS))
        predictor_delta = float(angular_error_numpy(served, full.last_eval["pred"]).max())
        log(f"GazePredictor (strict load of {ckpts[1]}, f32) vs Trainer.test: max angular delta "
            f"{predictor_delta:.3e} deg over {len(served)} pairs (bar 0.1)")
        if not predictor_delta <= 0.1:
            raise RuntimeError(f"GazePredictor and Trainer.test differ by {predictor_delta} deg")
        del pred

        # --- images/s through train_one_epoch, and the idle share of 3 steps
        full._train_step = bare_step
        full.print_freq = 10**9
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for epoch in (2, 3):
            full.train_one_epoch(epoch)
        torch.cuda.synchronize()
        imgs_per_s = 2 * PAIRS * 6 / (time.perf_counter() - t0)
        epochs = itertools.count(4)
        profile = profile_device(lambda: (full.train_one_epoch(next(epochs)), torch.cuda.synchronize()),
                                 n_iter=1)
        del full
        torch.cuda.empty_cache()

        # --- mid-epoch save after update 4, and a resume from it
        first = port_trainer(os.path.join(tmp, "first"), train_ds, test_ds)
        first._preempt_requested = lambda: first.step >= 4
        if not math.isnan(first.train()):
            raise RuntimeError("the preempted run did not stop")
        path = os.path.join(first.ckpt_dir, "preempt_epoch_01.pth.tar")
        meta = read_checkpoint(path)["epoch_meta"]
        del first
        resumed = port_trainer(os.path.join(tmp, "resumed"), train_ds, test_ds, ckpt_resume=path)
        resumed_steps = record_steps(resumed, fusion, batchnorm)
        resumed_error = resumed.train()
        del resumed
        torch.cuda.empty_cache()
        check_steps("resumed", resumed_steps, PER_STEP, 2)
        loss_rel = max(abs(r["loss"] - f["loss"]) / abs(f["loss"]) for r, f in zip(resumed_steps, steps[4:]))
        error_delta = abs(resumed_error - error)
        log(f"resume from {meta}: updates 5-6 losses {[r['loss'] for r in resumed_steps]} vs "
            f"{[f['loss'] for f in steps[4:]]} (max rel {loss_rel:.3e}, bar 1e-2); final error "
            f"{resumed_error:.6f} vs {error:.6f} deg (delta {error_delta:.3e}, bar 0.1)")
        if meta != {"epochs_done": 1, "epoch_step": 1, "steps_per_epoch": 3} or not (
                loss_rel <= 1e-2 and error_delta <= 0.1):
            raise RuntimeError("the resumed run does not continue the uninterrupted one")

        # --- one epoch under each option, from the epoch-1 checkpoint
        options = {}
        for name, option, per_step in (
            ("grad_accum", {"grad_accum": 2}, {**{k: 2 * n for k, n in PER_STEP.items()}}),
            ("ema", {"ema_decay": 0.99}, PER_STEP),
            ("freeze_bn", {"freeze_bn": True}, {**PER_STEP, **no_bn}),
        ):
            trainer = port_trainer(os.path.join(tmp, name), train_ds, test_ds, ckpt_resume=epoch_1, **option)
            buffers = {n: b.clone() for n, b in trainer.model.named_buffers()}
            opt_steps = record_steps(trainer, fusion, batchnorm)
            opt_error = trainer.train()
            check_steps(name, opt_steps, per_step, 3)
            if name == "freeze_bn":
                moved = [n for n, b in trainer.model.named_buffers() if not torch.equal(b, buffers[n])]
                if moved or not any(isinstance(m, BatchNormAct) for m in trainer.model.modules()):
                    raise RuntimeError(f"freeze_bn moved BN buffers: {moved[:5]}")
            if name == "ema":
                params = dict(trainer.model.named_parameters())
                if all(torch.equal(trainer.ema[n], params[n]) for n in params):
                    raise RuntimeError("the EMA did not move away from the parameters")
            options[name] = {"error": opt_error, "losses": [s["loss"] for s in opt_steps]}
            log(f"trainer {name}: final error {opt_error:.4f} deg")
            del trainer
            torch.cuda.empty_cache()
    out = {
        "train_imgs_per_s_trainer": imgs_per_s,
        "train_imgs_per_s_bare_step": bare_imgs_per_s,
        "device_idle_share_3_trainer_steps": profile["device_idle_share"],
        "trainer_profile": profile,
        "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20,
        "final_error_deg": error, "resumed_error_deg": resumed_error, "resume_loss_max_rel": loss_rel,
        "predictor_max_delta_deg": predictor_delta, "options": options,
        "seconds": time.perf_counter() - t_phase,
    }
    log(f"trainer phase: {imgs_per_s:.1f} images/s through train_one_epoch (bare step "
        f"{bare_imgs_per_s:.1f}), device idle {profile['device_idle_share']:.1%} over 3 steps, "
        f"peak {out['max_memory_allocated_mb']:.0f} MiB, {out['seconds']:.1f} s")
    return {"launches": launches, "by_variant": by_variant, "numbers": out, "checkpoint": kept}


# ---------------------------------------------------------------------------
# the command line (phase 9)
# ---------------------------------------------------------------------------

def write_cli_corpus(root: str) -> dict:
    """Packs for every subject of configs/subject/{xgaze,mpiinv}.yaml, written
    by the port's write_pack from synthetic_rows (learnable, 224x224, one frame
    of 18 cameras each), under <root>/<dataset>/_rmgpack/<dataset>, where the
    command line looks; each source archive an empty file dated before its
    pack, so pack_dataset finds every pack current and opens no archive.
    Returns data_path.yaml's path and the row counts."""
    from rot_mvgaze_tpu_torch.data.packed import write_pack
    from rot_mvgaze_tpu_torch.data.synthetic import synthetic_rows
    from rot_mvgaze_tpu_torch.utils.config import load_yaml

    rows = {}
    past = time.time() - 3600
    for offset, name in ((0, "xgaze"), (1000, "mpiinv")):
        subjects = load_yaml(os.path.join(REPO, "configs", "subject", f"{name}.yaml"))["subject"]
        cache = os.path.join(root, name, "_rmgpack", name)
        os.makedirs(cache)
        for i, subject in enumerate(subjects):
            archive = os.path.join(root, name, subject)
            open(archive, "wb").close()
            os.utime(archive, (past, past))
            imgs, gaze, pose = synthetic_rows(1, 18, 224, seed=offset + i, learnable=True)
            write_pack(os.path.join(cache, subject + ".rmgpack"), *imgs.shape, [imgs], gaze, pose)
        rows[name] = 18 * len(subjects)
    data_path = os.path.join(root, "data_path.yaml")
    with open(data_path, "w") as f:
        f.write(f"# written by chip_smoke.py\nxgaze: '{root}/xgaze'\nmpiinv: '{root}/mpiinv'\n")
    return {"data_path": data_path, "rows": rows}


def drive_cli(argv, fusion, batchnorm) -> dict:
    """cli.main.main(argv) in process, the Trainer it builds instrumented:
    each update's launch counts (record_steps: the counters' change over the
    update), each evaluation batch's, and the host clock at each update's
    start and end."""
    import rot_mvgaze_tpu_torch.cli.main as cli

    run = {"trainer": None, "steps": [], "evals": [], "clock": []}
    build = cli.build_experiment

    def instrumented(config):
        trainer = build(config)
        run["trainer"] = trainer
        run["steps"] = record_steps(trainer, fusion, batchnorm)
        step_fn, eval_fn = trainer._train_step, trainer._eval_step

        def timed(batch, generator=None, *, step):
            t0 = time.perf_counter()
            stats = step_fn(batch, generator, step=step)
            run["clock"].append((t0, time.perf_counter()))  # record_steps synchronised (the loss)
            return stats

        def counted(batch, params=None):
            before = launch_counts(fusion, batchnorm)
            generic = fusion.rotate_concat_matmul_relu.launches_by_variant["generic"]
            out = eval_fn(batch, params)
            after = launch_counts(fusion, batchnorm)
            run["evals"].append({
                "counts": {k: after[k] - before[k] for k in after},
                "generic": fusion.rotate_concat_matmul_relu.launches_by_variant["generic"] - generic,
                "rows": int(batch["img_0"].shape[0])})
            return out

        trainer._train_step, trainer._eval_step = timed, counted
        return trainer

    cli.build_experiment = instrumented
    try:
        rc = cli.main(argv)
    finally:
        cli.build_experiment = build
    if rc != 0:
        raise RuntimeError(f"cli.main({argv}) returned {rc}")
    return run


def check_native_loaders(trainer, name) -> None:
    from rot_mvgaze_tpu_torch.data.native import NativeBatchLoader

    for loader in (trainer.train_loader, trainer.test_loader):
        if not isinstance(loader, NativeBatchLoader) or loader.dataset.pool is None:
            raise RuntimeError(f"cli {name}: {type(loader).__name__} served, not the C++ pool")


def check_evals(name, evals, n_batches) -> None:
    """Every float32 evaluation batch: 6 launches of the fuser's generic
    variant, no other kernel."""
    per_batch = {**dict.fromkeys(PER_STEP, 0), "fusion": 6}
    if len(evals) != n_batches:
        raise RuntimeError(f"cli {name}: {len(evals)} evaluation batches, expected {n_batches}")
    for e in evals:
        if e["counts"] != per_batch or e["generic"] != 6:
            raise RuntimeError(f"cli {name}: evaluation batch of {e['rows']} launched {e['counts']} "
                               f"({e['generic']} generic) != {per_batch}")


def run_cli_phase(fusion, batchnorm, bare_imgs_per_s) -> dict:
    """Phase 9: python -m rot_mvgaze_tpu_torch's main(argv) on the card, at
    the reference's defaults (R50 x 3, bf16, batches of 50, the native
    loader, the reference pairing), train then test, over packs of every
    configured subject. Returns the main path's launch counts and the
    numbers."""
    from rot_mvgaze_tpu_torch.serving import GazePredictor

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        corpus = write_cli_corpus(tmp)
        train_pairs, test_pairs = corpus["rows"]["xgaze"], corpus["rows"]["mpiinv"]
        n_updates = train_pairs // CLI_BATCH
        test_batches = -(-test_pairs // CLI_BATCH)
        common = ["--exp_name", "xgaze2mpiinv_known", "--data_path", corpus["data_path"],
                  "-out", os.path.join(tmp, "logs"), "--batch_size", str(CLI_BATCH),
                  "--test_batch_size", str(CLI_BATCH), "--native_loader", "true",
                  "--pairing", "reference"]

        # refused options exit before any data is read: a data_path that does
        # not exist would raise FileNotFoundError, not SystemExit
        for refused in (["--num_views", "3", "--grad_accum", "2"], ["--spatial_partition", "2"]):
            argv = ["--exp_name", "xgaze2mpiinv_known", "--data_path", os.path.join(tmp, "absent.yaml"),
                    *refused]
            try:
                drive_cli(argv, fusion, batchnorm)
            except SystemExit as e:
                if e.code in (0, None):
                    raise RuntimeError(f"cli {refused}: exit code {e.code!r}")
                log(f"cli {' '.join(refused)}: refused before reading data ({e.code})")
            else:
                raise RuntimeError(f"cli {refused} was not refused")

        # --- main path: train, counts set to 0 just before, read just after
        reset_counts(fusion, batchnorm)
        train = drive_cli([*common, "--mode", "train", "--epochs", "1", "--save_epoch", "1"],
                          fusion, batchnorm)
        launches = launch_counts(fusion, batchnorm)
        by_variant = dict(fusion.rotate_concat_matmul_relu.launches_by_variant)
        trainer = train["trainer"]
        check_native_loaders(trainer, "train")
        check_steps("cli train", train["steps"], PER_STEP, n_updates)
        check_evals("train", train["evals"], 2 * test_batches)
        evals = 6 * 2 * test_batches
        want = {**{k: n_updates * n for k, n in PER_STEP.items()}, "fusion": 6 * n_updates + evals}
        if launches != want or by_variant != {"wgmma": 6 * n_updates, "generic": evals}:
            raise RuntimeError(f"cli train launched {launches} {by_variant}, expected {want}")
        with open(os.path.join(trainer.output_dir, "test_results.txt")) as f:
            results = f.read()
        ckpts = sorted(os.listdir(trainer.ckpt_dir))
        train_error = float(np.mean(trainer.last_eval["errors"]))
        if len(ckpts) != 1 or results.count("error:") != 2 or not math.isfinite(train_error):
            raise RuntimeError(f"cli train: checkpoints {ckpts}, test_results.txt {results!r}")
        clock = train["clock"]
        span = clock[-1][1] - clock[0][0]
        waits = sum(b[0] - a[1] for a, b in zip(clock, clock[1:]))
        imgs_per_s = 2 * CLI_BATCH * n_updates / span
        ckpt = os.path.join(trainer.ckpt_dir, ckpts[0])
        del trainer, train
        torch.cuda.empty_cache()

        # --- test mode from that checkpoint, with the breakdown and an export
        export = os.path.join(tmp, "exported.pth.tar")
        reset_counts(fusion, batchnorm)
        test = drive_cli([*common, "--mode", "test", "--ckpt_resume", ckpt, "--test_breakdown", "true",
                          "--export_torch", export], fusion, batchnorm)
        test_launches = launch_counts(fusion, batchnorm)
        tester = test["trainer"]
        check_native_loaders(tester, "test")
        check_evals("test", test["evals"], test_batches)
        test_error = float(np.mean(tester.last_eval["errors"]))
        delta = abs(test_error - train_error)
        with open(os.path.join(tester.output_dir, "test_results.txt")) as f:
            report = f.read()
        log(f"cli test from {ckpts[0]}: {test_error:.6f} deg against the train run's last evaluation "
            f"{train_error:.6f} (delta {delta:.3e}, bar 1e-3); breakdown "
            f"{report.count('deg (n=')} groups")
        if not delta <= 1e-3 or "per_camera:" not in report or "per_subject:" not in report:
            raise RuntimeError(f"cli test: error {test_error} vs {train_error}, report {report!r}")

        # the export strictly into GazePredictor (its constructor loads with
        # strict=True), against test mode's predictions on the first batch
        pred = GazePredictor(export, backbone_depth=50, num_iter=3, micro_batch=CLI_BATCH,
                             image_size=224, dtype=torch.float32, device="cuda")
        ds = tester.test_loader.dataset
        samples = [ds[i] for i in range(CLI_BATCH)]
        served = pred.predict(*(np.stack([s[k] for s in samples]).astype(np.float32)
                                if k.startswith("head") else np.stack([s[k] for s in samples])
                                for k in pred.request_fields))
        from rot_mvgaze_tpu_torch.geometry import angular_error_numpy

        export_delta = float(angular_error_numpy(served, tester.last_eval["pred"][:CLI_BATCH]).max())
        log(f"exported {os.path.basename(export)} loads strictly into GazePredictor (f32): max "
            f"angular delta {export_delta:.3e} deg from test mode over {CLI_BATCH} pairs (bar 0.1)")
        if not export_delta <= 0.1:
            raise RuntimeError(f"the exported checkpoint predicts {export_delta} deg from test mode")
        del pred, tester, test
        torch.cuda.empty_cache()
    out = {
        "train_pairs": train_pairs, "test_pairs": test_pairs, "updates": n_updates,
        "imgs_per_s_over_updates": imgs_per_s, "bare_step_imgs_per_s": bare_imgs_per_s,
        "loader_wait_share": waits / span,
        "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20,
        "train_error_deg": train_error, "test_error_deg": test_error, "test_delta_deg": delta,
        "export_max_delta_deg": export_delta, "test_launches": test_launches,
        "seconds": time.perf_counter() - t_phase,
    }
    log(f"cli phase: {imgs_per_s:.1f} images/s over {n_updates} updates (bare step "
        f"{bare_imgs_per_s:.1f}), {out['loader_wait_share']:.1%} of it between updates, peak "
        f"{out['max_memory_allocated_mb']:.0f} MiB, {out['seconds']:.1f} s")
    return {"launches": launches, "by_variant": by_variant, "numbers": out}


# ---------------------------------------------------------------------------
# the model family (phase 10)
# ---------------------------------------------------------------------------

# name -> (model flags, launches per BN kernel per update, fuser launches per update)
FAMILY = {
    "fuse_views": ({"fuse_views": True}, 53, 6),
    "ignore_rotmat": ({"ignore_rotmat": True}, 106, 0),
    "encode_rotmat": ({"encode_rotmat": True}, 106, 0),
    "share_feature": ({"share_feature": True}, 106, 0),
    "share_weights": ({"share_weights": True}, 106, 6),
    "v3": ({"num_views": 3}, 53, 0),
}
FAMILY_TIMED = ("fuse_views", "v3")  # the fused-batch shapes: timed and checked against plain


def family_per_step(name) -> dict:
    _, n_bn, n_fuser = FAMILY[name]
    return {**dict.fromkeys(BN_KERNELS, n_bn), "fusion": n_fuser, "conv3x3_bn_stats": 0}


def run_family_updates(fusion, batchnorm, n_timed=5) -> dict:
    """Phase 10a, the main path: one bf16 update of each configuration at 64
    pairs or frames, counts set to 0 just before it and read just after;
    then, for the fused-batch configurations, n_timed bare updates on the
    host clock (a smoke reading)."""
    totals = {k: 0 for k in PER_STEP}
    by_variant = dict.fromkeys(fusion.VARIANTS, 0)
    out = {"configs": {}}
    for name, (flags, n_bn, _) in FAMILY.items():
        torch.manual_seed(0)
        model, step = make_trainer(family_model(flags).state_dict(), torch.bfloat16, flags=flags)
        batch = training_batch(seed=51, views=family_views(flags))
        gen = torch.Generator(device="cuda").manual_seed(52)
        shapes = []
        hooks = record_bn_shapes(model, shapes)
        step(batch, gen, step=0)  # the first update builds cuDNN's plans; it records the BN shapes
        for h in hooks:
            h.remove()
        torch.cuda.synchronize()
        reset_counts(fusion, batchnorm)
        loss = float(step(batch, gen, step=1)["loss_gaze"])
        counts = launch_counts(fusion, batchnorm)
        variants = dict(fusion.rotate_concat_matmul_relu.launches_by_variant)
        want = family_per_step(name)
        if counts != want or variants["wgmma"] != want["fusion"] or not math.isfinite(loss):
            raise RuntimeError(f"model family {name}: launches {counts} {variants}, loss {loss}; "
                               f"expected {want}, all wgmma")
        if len(shapes) != n_bn:
            raise RuntimeError(f"model family {name}: {len(shapes)} BN calls per update, expected {n_bn}")
        for k, n in counts.items():
            totals[k] += n
        for k, n in variants.items():
            by_variant[k] += n
        rec = {"loss": loss, "launches": counts, "bn_shapes": shapes}
        if name in FAMILY_TIMED:
            images = PAIRS * family_views(flags)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n_timed):
                step(batch, gen, step=2 + i)
            torch.cuda.synchronize()
            rec["imgs_per_s"] = images * n_timed / (time.perf_counter() - t0)
        out["configs"][name] = rec
        log(f"model family {name}: one update launched {counts} ({variants['wgmma']} wgmma), loss "
            f"{loss:.5f}" + (f"; {rec['imgs_per_s']:.1f} images/s over {n_timed} bare updates"
                             if "imgs_per_s" in rec else ""))
        del model, step, batch
        torch.cuda.empty_cache()
    out["launches"], out["fusion_by_variant"] = totals, by_variant
    return out


def check_family_paths(fusion, batchnorm) -> dict:
    """Phase 10b: for fuse_views and V=3, one update through the kernels and
    one through the plain versions from one saved state, at phase 7b's bars
    (compare_paths; f32 against an f64 update too)."""
    out = {}
    for name in FAMILY_TIMED:
        flags = FAMILY[name][0]
        torch.manual_seed(1)
        state = family_model(flags).state_dict()
        batch = training_batch(seed=61, views=family_views(flags))
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{name}_{str(dtype)[6:]}"
            out.update(compare_paths(fusion, batchnorm, f"model family {tag}", tag, state, batch, dtype,
                                     family_per_step(name), flags=flags, seed=62))
    return out


def family_bn_cases(updates) -> list:
    """Every distinct BN shape of the fused-batch updates, as BN_CASES
    entries (name, rows, C, relu, residual)."""
    cases = {}
    for name in FAMILY_TIMED:
        for (n, c, h, w), relu, res in updates["configs"][name]["bn_shapes"]:
            cases.setdefault((n * h * w, c, relu, res), name)
    return [(f"{name} update", rows, c, relu, res) for (rows, c, relu, res), name in cases.items()]


def time_family_bn(batchnorm, updates, default_bn) -> dict:
    """Phase 10e: each BN kernel over the 53 calls of one fused-batch update
    (device_ms), its byte bound and the bound's share, beside the default
    update's 106 calls at 64 pairs from phase 7c: the same 128 images per
    view pair in one call instead of two."""
    out = {}
    for name in FAMILY_TIMED:
        calls = bn_calls(batchnorm, updates["configs"][name]["bn_shapes"])
        rec = {}
        for kind in BN_KERNELS:
            ms = device_ms(bn_runner(batchnorm, calls, kind))
            nbytes = sum(bn_bytes(kind, q["rows"], q["c"], 2, q["relu"], q["res"]) for q in calls)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            rec[kind] = {"ms": ms, "bound_ms": bound, "share_of_bound": bound / ms, "calls": len(calls)}
        out[name] = rec
        del calls
        torch.cuda.empty_cache()
        log(f"BN kernels over one {name} update's 53 calls (device ms, share of the byte bound): "
            + "; ".join(f"{k} {r['ms']:.4f} ({r['share_of_bound']:.1%})" for k, r in rec.items())
            + "; the default update's 106 calls: "
            + "; ".join(f"{k} {default_bn[k]['ms']:.4f}" for k in BN_KERNELS))
    return out


def run_family_trainer(fusion, batchnorm, stereo_ckpt) -> dict:
    """Phase 10d: the V-view Trainer at V=3 (R50 x 3, bf16, 64 frames per
    update) from phase 8's epoch-1 stereo checkpoint (a strict load, weights
    only),
    one epoch over an in-memory corpus of 216 samples (3 updates) with
    evaluation before and after (72 samples, batches of 64 and 8): 53
    launches of each BN kernel per update, none of the fuser, none in
    evaluation; finite predictions. Then, from the same checkpoint, the
    V-view model's eval predictions at V=2 against the stereo model's,
    angles in float64: both models in float64 (plain versions) within 1e-3
    deg, the reduction itself; in float32, against the stereo model with
    its fuser kernel, within 1e-3 deg as well, and pred_gaze within phase
    4's f32 bar (atol 2e-4 / rtol 1e-3). In float32 the two models run
    their GEMMs at other shapes (the V-view fuser and heads take all B·V
    rows in one call, the stereo ones B rows per view), so their rounding
    differs; the angles are logged, with both models' errors on the batch."""
    from types import SimpleNamespace

    from rot_mvgaze_tpu_torch.compat import read_checkpoint
    from rot_mvgaze_tpu_torch.compat.convert import checkpoint_state_dict
    from rot_mvgaze_tpu_torch.data import BatchLoader, InMemoryMultiViewGazeDataset, collate
    from rot_mvgaze_tpu_torch.geometry import angular_error_numpy
    from rot_mvgaze_tpu_torch.models import FeatRotationMultiView, FeatRotationSymm
    from rot_mvgaze_tpu_torch.train import Trainer, make_eval_step, make_multiview_eval_step

    flags = FAMILY["v3"][0]
    train_ds = InMemoryMultiViewGazeDataset(2, n_views=3, n_frames=6, image_size=224, seed=0, learnable=True)
    test_ds = InMemoryMultiViewGazeDataset(1, n_views=3, n_frames=4, image_size=224, seed=100, learnable=True)
    per_step = family_per_step("v3")
    no_launch = dict.fromkeys(PER_STEP, 0)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = SimpleNamespace(output_dir=tmp, epochs=1, save_epoch=1, print_freq=1, seed=0, image_size=224,
                              bf16=True, scheduler_step="epoch", base_lr=1e-6, max_lr=1e-3, num_views=3,
                              ckpt_resume=stereo_ckpt, weights_only=True)
        torch.manual_seed(0)
        trainer = Trainer(cfg, family_model(flags), family_metrics(flags),
                          BatchLoader(train_ds, PAIRS, shuffle=True, drop_last=True), BatchLoader(test_ds, PAIRS),
                          device="cuda")
        steps = record_steps(trainer, fusion, batchnorm)
        reset_counts(fusion, batchnorm)
        before = trainer.test(-1)
        first_pred = trainer.last_eval["pred"]
        eval_counts = launch_counts(fusion, batchnorm)
        error = trainer.train()
        launches = launch_counts(fusion, batchnorm)
    check_steps("V=3", steps, per_step, 3)
    want = {k: 3 * n for k, n in per_step.items()}
    if eval_counts != no_launch or launches != want:
        raise RuntimeError(f"V=3 trainer launched {launches} (evaluation {eval_counts}), expected {want}")
    if not (np.all(np.isfinite(first_pred)) and math.isfinite(before) and math.isfinite(error)):
        raise RuntimeError(f"V=3 trainer: errors {before}, {error}")
    log(f"V=3 Trainer from the stereo checkpoint (strict): error {before:.4f} deg before, {error:.4f} after "
        f"one epoch of 3 updates; launches {launches}")
    del trainer
    torch.cuda.empty_cache()

    # V=2: the V-view model against the stereo one, float32, one batch of 64
    state = checkpoint_state_dict(read_checkpoint(stereo_ckpt))
    stereo, multi = FeatRotationSymm(backbone_depth=50, num_iter=3), FeatRotationMultiView(backbone_depth=50, num_iter=3)
    for m in (stereo, multi):
        m.load_state_dict(state, strict=True)
    ds = InMemoryMultiViewGazeDataset(1, n_views=2, n_frames=4, image_size=224, seed=100, learnable=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in collate([ds[i] for i in range(PAIRS)]).items()}
    pair = {"img_0": batch["imgs"][:, 0], "img_1": batch["imgs"][:, 1],
            "head_pose_0": batch["head_poses"][:, 0], "head_pose_1": batch["head_poses"][:, 1]}
    def predictions(dtype, plain):
        with plain_kernels() if plain else contextlib.nullcontext():
            st = make_eval_step(stereo.to(device="cuda", dtype=dtype), 224)(pair)["pred_gaze"]
            mv = make_multiview_eval_step(multi.to(device="cuda", dtype=dtype), 224)(batch)["pred_gaze"]
        return mv.cpu().numpy().astype(np.float64), st.cpu().numpy().astype(np.float64)

    got, kernel_pred = predictions(torch.float32, plain=False)
    _, plain_pred = predictions(torch.float32, plain=True)
    got64, want64 = predictions(torch.float64, plain=True)
    f32_delta = angular_error_numpy(got, kernel_pred)
    v2_delta = float(angular_error_numpy(got64, want64).max())
    gt = batch["gt_gazes"][:, 0].cpu().numpy().astype(np.float64)
    errors = {"multiview": float(angular_error_numpy(got, gt).mean()),
              "stereo": float(angular_error_numpy(kernel_pred, gt).mean())}
    log(f"V=2, the V-view model against the stereo model over {PAIRS} samples (angles in float64; "
        f"errors on the batch {errors['multiview']:.4f} and {errors['stereo']:.4f} deg): in float64 max "
        f"{v2_delta:.3e} deg (bar 1e-3); in float32 with the stereo fuser's kernel max "
        f"{f32_delta.max():.3e} (bar 1e-3), mean {f32_delta.mean():.3e} deg, pred_gaze max |diff| "
        f"{np.abs(got - kernel_pred).max():.3e} (phase 4's f32 bar atol 2e-4 / rtol 1e-3); with its plain "
        f"products max {angular_error_numpy(got, plain_pred).max():.3e} deg")
    if not (v2_delta <= 1e-3 and f32_delta.max() <= 1e-3):
        raise RuntimeError(f"V=2 V-view model is {v2_delta} deg (float64), {f32_delta.max()} deg (float32) "
                           f"from the stereo model")
    np.testing.assert_allclose(got, kernel_pred, atol=2e-4, rtol=1e-3)
    del stereo, multi
    torch.cuda.empty_cache()
    return {"launches": launches, "error_before_deg": before, "error_deg": error,
            "v2_max_delta_deg_f64": v2_delta, "v2_max_delta_deg_f32": float(f32_delta.max()),
            "v2_mean_delta_deg_f32": float(f32_delta.mean()), "v2_batch_error_deg": errors,
            "v2_max_pred_diff_f32": float(np.abs(got - kernel_pred).max()), "losses": [s["loss"] for s in steps]}


def run_family_phase(fusion, batchnorm, default_bn, stereo_ckpt) -> dict:
    """Phase 10: the model family at R50 x 3. Returns the main path's launch
    counts and the numbers."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    updates = run_family_updates(fusion, batchnorm)
    peak_updates = torch.cuda.max_memory_allocated() / 2**20
    paths = check_family_paths(fusion, batchnorm)
    cases = family_bn_cases(updates)
    bn_err = check_bn_kernels(batchnorm, cases)
    torch.cuda.empty_cache()
    bn_time = time_family_bn(batchnorm, updates, default_bn)
    trainer = run_family_trainer(fusion, batchnorm, stereo_ckpt)
    out = {
        "losses": {n: c["loss"] for n, c in updates["configs"].items()},
        "launches_per_update": {n: c["launches"] for n, c in updates["configs"].items()},
        "imgs_per_s_bare_update": {n: updates["configs"][n]["imgs_per_s"] for n in FAMILY_TIMED},
        "kernel_vs_plain": paths, "bn_cases_vs_f64": len(cases), "bn_max_abs_err_bf16": bn_err,
        "bn_ms_per_update": bn_time,
        "bn_ms_default_update": {k: default_bn[k]["ms"] for k in BN_KERNELS},
        "v3_trainer": trainer,
        "max_memory_allocated_mb_updates": peak_updates,
        "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20,
        "seconds": time.perf_counter() - t_phase,
    }
    launches = {k: updates["launches"][k] + trainer["launches"][k] for k in PER_STEP}
    log(f"model family phase: {len(cases)} fused-batch BN shapes held to float64; images/s "
        f"{out['imgs_per_s_bare_update']}; peak {out['max_memory_allocated_mb']:.0f} MiB "
        f"(updates {peak_updates:.0f}); {out['seconds']:.1f} s")
    return {"launches": launches, "by_variant": updates["fusion_by_variant"], "numbers": out}


# ---------------------------------------------------------------------------
# the serving surface (phase 11)
# ---------------------------------------------------------------------------

# ablation -> wgmma fuser launches per micro-batch (the ablations' fusers are
# F.linear MLPs, as in JAX; share_weights keeps the default fuser)
SURFACE_ABLATIONS = {"share_weights": 6, "ignore_rotmat": 0, "encode_rotmat": 0, "share_feature": 0}
R50_CONVS = 53


def ablation_checkpoint(stereo_ckpt: str, flags: dict, path: str) -> None:
    """A checkpoint of the ablation's R50 x 3 model: phase 8's epoch-1
    weights wherever the key and shape match (backbone, lifter, heads), the
    seeded initialisation elsewhere."""
    from rot_mvgaze_tpu_torch.compat import read_checkpoint
    from rot_mvgaze_tpu_torch.compat.convert import checkpoint_state_dict
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm

    torch.manual_seed(0)
    with torch.device("cuda"):
        model = FeatRotationSymm(backbone_depth=50, num_iter=3, **flags)
    own = model.state_dict()
    trained = checkpoint_state_dict(read_checkpoint(stereo_ckpt))
    model.load_state_dict({k: v for k, v in trained.items() if k in own and own[k].shape == v.shape},
                          strict=False)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)


def surface_predictor(ckpt: str, dtype, **kw):
    from rot_mvgaze_tpu_torch.serving import GazePredictor

    return GazePredictor(ckpt, backbone_depth=50, num_iter=3, micro_batch=PAIRS, image_size=224, dtype=dtype,
                         device="cuda", **kw)


def counted(fusion, batchnorm, fn) -> tuple:
    """(fn's result, launch counts, fuser launches by variant, int8 GEMM
    launches): the counts set to 0 just before fn and read just after."""
    from rot_mvgaze_tpu_torch.ops import quant

    reset_counts(fusion, batchnorm)
    quant.int8_matmul.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return (out, launch_counts(fusion, batchnorm), dict(fusion.rotate_concat_matmul_relu.launches_by_variant),
            quant.int8_matmul.launches)


def check_served(name, counts, by_variant, fuser_per_mb, micro_batches, int8_launches=0, int8_per_mb=0):
    want = {**dict.fromkeys(PER_STEP, 0), "fusion": fuser_per_mb * micro_batches}
    if counts != want or by_variant["wgmma"] != want["fusion"] or int8_launches != int8_per_mb * micro_batches:
        raise RuntimeError(f"{name}: launches {counts} {by_variant}, int8 GEMM {int8_launches}; expected {want}, "
                           f"all wgmma, int8 GEMM {int8_per_mb} x {micro_batches}")


def check_int8_conv_shapes(model) -> dict:
    """Every R50 conv's shape at micro-batch 64 (two views: 128 images), from
    hooks on one int8 forward: full-range int8 operands of that shape
    through the tensor-core product (im2col + torch._int_mm) and through the
    plain float64 convolution, int32 sums bit for bit."""
    from rot_mvgaze_tpu_torch.models.resnet import QuantConv2d
    from rot_mvgaze_tpu_torch.ops import quant

    shapes = []
    hooks = [m.register_forward_pre_hook(lambda m, a: shapes.append(
        (tuple(a[0].shape), tuple(m.weight.shape), m.stride, m.padding, m.groups)))
        for m in model.modules() if isinstance(m, QuantConv2d)]
    try:
        with torch.inference_mode():
            model._feat_extractor(torch.zeros((2 * PAIRS, 224, 224, 3), device="cuda", dtype=torch.bfloat16))
    finally:
        for h in hooks:
            h.remove()
    if len(shapes) != R50_CONVS:
        raise RuntimeError(f"int8 R50 ran {len(shapes)} convs, expected {R50_CONVS}")
    distinct = sorted(set(shapes))
    g = torch.Generator(device="cuda").manual_seed(5)
    launches = 0
    for xs, ws, stride, pad, groups in distinct:
        x8 = torch.randint(-127, 128, xs, dtype=torch.int8, device="cuda", generator=g)
        x8 = x8.to(memory_format=torch.channels_last)
        w8 = torch.randint(-127, 128, ws, dtype=torch.int8, device="cuda", generator=g)
        before = quant.int8_matmul.launches
        got = quant.int8_conv_accumulate(x8, w8, stride, pad, groups)
        launches += quant.int8_matmul.launches - before
        want = quant.int8_conv_accumulate_reference(x8, w8, stride, pad, groups)
        if not torch.equal(got, want):
            raise RuntimeError(f"int8 conv x {xs} w {ws} stride {stride}: the int32 sums differ from the plain "
                               f"version's in {(got != want).sum().item()} places")
        del x8, w8, got, want
    if launches != len(distinct):
        raise RuntimeError(f"int8 conv checks launched {launches} int8 GEMMs for {len(distinct)} shapes")
    log(f"int8 conv: all {len(shapes)} R50 conv shapes at {2 * PAIRS} images ({len(distinct)} distinct) through "
        f"torch._int_mm bit for bit the plain float64 convolution's int32 sums")
    return {"convs": len(shapes), "distinct_shapes": len(distinct)}


def run_serving_surface_phase(fusion, batchnorm, stereo_ckpt) -> dict:
    """Phase 11: the serving surface at R50 x 3 from phase 8's epoch-1
    checkpoint. Returns the fuser's launches over the phase's counted
    paths, by variant, and the numbers."""
    from rot_mvgaze_tpu_torch.augment import eval_preprocess
    from rot_mvgaze_tpu_torch.data import InMemoryGazeDataset
    from rot_mvgaze_tpu_torch.evaluate import EVAL_KEYS
    from rot_mvgaze_tpu_torch.export import AotGazePredictor, export_serving_artifact
    from rot_mvgaze_tpu_torch.geometry import angular_error_numpy, rotation_matrix_2d
    from rot_mvgaze_tpu_torch.serving import MultiViewGazePredictor

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fuser_launches = 0
    fuser_by_variant = dict.fromkeys(fusion.VARIANTS, 0)
    req100 = requests([100], seed=11)[0]
    micro_batches = 2  # 100 pairs at micro-batch 64
    out: dict = {}

    def add(counts, by_variant):
        nonlocal fuser_launches
        fuser_launches += counts["fusion"]
        for k in fuser_by_variant:
            fuser_by_variant[k] += by_variant[k]

    parts: dict = {}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    with tempfile.TemporaryDirectory() as tmp:
        # (a) the ablation predictors: bf16 served with launch counts, f32 beside
        out["ablations"] = {}
        for name, per_mb in SURFACE_ABLATIONS.items():
            path = os.path.join(tmp, f"{name}.pth.tar")
            ablation_checkpoint(stereo_ckpt, {name: True}, path)
            pred = surface_predictor(path, torch.bfloat16, **{name: True})
            pred.warmup()
            got, counts, by_variant, _ = counted(fusion, batchnorm, lambda: pred.predict(*req100))
            check_served(name, counts, by_variant, per_mb, micro_batches)
            add(counts, by_variant)
            del pred
            f32 = surface_predictor(path, torch.float32, **{name: True}).predict(*req100)
            delta = angular_error_numpy(got, f32)
            log(f"{name} predictor: 100 pairs, {counts['fusion']} wgmma fuser launches; bf16 against f32 mean "
                f"{delta.mean():.4f} max {delta.max():.4f} deg (bar: mean 0.1)")
            if got.shape != (100, 2) or not np.all(np.isfinite(got)) or not delta.mean() <= 0.1:
                raise RuntimeError(f"{name} predictor: shape {got.shape}, bf16 against f32 {delta.mean()} deg")
            out["ablations"][name] = {"fuser_launches": counts["fusion"], "bf16_vs_f32_mean_deg": float(delta.mean()),
                                      "bf16_vs_f32_max_deg": float(delta.max())}
            torch.cuda.empty_cache()

        part("ablations")
        # (b) the V-view predictor at V=3, and at V=2 against the stereo one
        rng = np.random.default_rng(12)
        reqv = (rng.integers(0, 256, (100, 3, 224, 224, 3), dtype=np.uint8),
                rng.uniform(-0.6, 0.6, (100, 3, 2)).astype(np.float32))
        mv = MultiViewGazePredictor(stereo_ckpt, num_views=3, backbone_depth=50, num_iter=3, micro_batch=PAIRS,
                                    image_size=224, dtype=torch.bfloat16, device="cuda")
        mv.warmup()
        got_v, counts, by_variant, _ = counted(fusion, batchnorm, lambda: mv.predict(*reqv))
        check_served("V=3 predictor", counts, by_variant, 0, micro_batches)
        if got_v.shape != (100, 2) or not np.all(np.isfinite(got_v)):
            raise RuntimeError(f"V=3 predictor: {got_v.shape}")
        st32 = surface_predictor(stereo_ckpt, torch.float32)
        mv2 = MultiViewGazePredictor(stereo_ckpt, num_views=2, backbone_depth=50, num_iter=3, micro_batch=PAIRS,
                                     image_size=224, dtype=torch.float32, device="cuda")
        pair = requests([PAIRS], seed=13)[0]
        v2 = angular_error_numpy(mv2.predict(np.stack(pair[:2], 1), np.stack(pair[2:], 1)), st32.predict(*pair))
        del mv2
        log(f"V=3 predictor: 100 samples, no fuser launch; V=2 against the stereo predictor (f32): max "
            f"{v2.max():.3e} deg (bar 1e-3)")
        if not v2.max() <= 1e-3:
            raise RuntimeError(f"V=2 predictor is {v2.max()} deg from the stereo predictor")
        out["multiview"] = {"v2_max_delta_deg": float(v2.max())}

        part("multiview")
        # (c) a 448x448 request against the same images resized on the CPU
        rng = np.random.default_rng(14)
        big = (rng.integers(0, 256, (PAIRS, 448, 448, 3), dtype=np.uint8),
               rng.integers(0, 256, (PAIRS, 448, 448, 3), dtype=np.uint8),
               rng.uniform(-0.6, 0.6, (PAIRS, 2)).astype(np.float32), rng.uniform(-0.6, 0.6, (PAIRS, 2)).astype(np.float32))
        served = st32.predict(*big)
        data = {f"img_{v}": eval_preprocess(torch.from_numpy(big[v]), 224).cuda() for v in (0, 1)}
        data.update({f"rot_{v}": rotation_matrix_2d(torch.from_numpy(big[2 + v]).cuda()) for v in (0, 1)})
        with torch.inference_mode():
            cpu_resized = st32.model(data)["pred_gaze"].float().cpu().numpy()
        resize = angular_error_numpy(served, cpu_resized)
        log(f"448x448 request resized on the card against the CPU's resize: mean {resize.mean():.3e} max "
            f"{resize.max():.3e} deg (bar: mean 0.01)")
        if not resize.mean() <= 0.01:
            raise RuntimeError(f"resize on the card is {resize.mean()} deg from the CPU's")
        out["resize_mean_delta_deg"] = float(resize.mean())

        # (d) int8: every conv shape bit for bit, the GEMM route counted,
        # features against f32, static calibration saved and reloaded
        part("resize")
        p8 = surface_predictor(stereo_ckpt, torch.bfloat16, int8=True)
        out["int8_conv_shapes"] = check_int8_conv_shapes(p8.model)
        part("int8_conv_shapes")
        p8.warmup()
        got8, counts, by_variant, n_gemm = counted(fusion, batchnorm, lambda: p8.predict(*req100))
        check_served("int8 predictor", counts, by_variant, 6, micro_batches, n_gemm, R50_CONVS)
        add(counts, by_variant)
        log(f"int8 predictor: 100 pairs, {n_gemm} int8 GEMMs ({R50_CONVS} per micro-batch), {counts['fusion']} "
            f"wgmma fuser launches")
        test_ds = InMemoryGazeDataset(1, n_frames=4, image_size=224, seed=100, learnable=True)
        samples = [test_ds[i] for i in range(len(test_ds))]
        subject = tuple(np.stack([s[k] for s in samples]) if k.startswith("img")
                        else np.stack([s[k] for s in samples]).astype(np.float32) for k in EVAL_KEYS)
        gt = np.stack([s["gt_gaze"] for s in samples])
        p8_32 = surface_predictor(stereo_ckpt, torch.float32, int8=True)
        with torch.inference_mode():
            imgs = eval_preprocess(torch.from_numpy(subject[0]).cuda(), 224)
            f = st32.model._feat_extractor(imgs).double().cpu().numpy()
            q = p8_32.model._feat_extractor(imgs).double().cpu().numpy()
        rel = np.linalg.norm(q - f, axis=1) / np.linalg.norm(f, axis=1)
        cos = (f * q).sum(1) / (np.linalg.norm(f, axis=1) * np.linalg.norm(q, axis=1))
        log(f"int8 backbone features against f32 over {len(f)} images: relative error mean {rel.mean():.5f} "
            f"max {rel.max():.5f} (bar mean 0.05), cosine mean {cos.mean():.6f} (bar 0.999)")
        if not (rel.mean() <= 0.05 and cos.mean() >= 0.999):
            raise RuntimeError(f"int8 features: relative error {rel.mean()}, cosine {cos.mean()}")
        out["int8_features"] = {"rel_err_mean": float(rel.mean()), "rel_err_max": float(rel.max()),
                                "cos_mean": float(cos.mean())}
        del p8_32, st32
        calib = os.path.join(tmp, "calibration.msgpack")
        ps = surface_predictor(stereo_ckpt, torch.bfloat16, int8="static", calibration_path=calib)
        ps.warmup()
        ps.calibrate(*subject)
        if not os.path.exists(calib):
            raise RuntimeError("static int8: calibrate() wrote no calibration file")
        ps2 = surface_predictor(stereo_ckpt, torch.bfloat16, int8="static", calibration_path=calib)
        if not ps2._calibrated or not np.array_equal(ps2.predict(*subject), ps.predict(*subject)):
            raise RuntimeError("static int8: the reloaded calibration predicts otherwise")
        del ps2
        pbf16 = surface_predictor(stereo_ckpt, torch.bfloat16)
        pbf16.warmup()
        errors = {name: float(angular_error_numpy(p.predict(*subject), gt).mean())
                  for name, p in (("bf16", pbf16), ("int8_dynamic", p8), ("int8_static", ps))}
        shifts = {k: abs(errors[k] - errors["bf16"]) for k in ("int8_dynamic", "int8_static")}
        log(f"test subject ({len(gt)} pairs): error bf16 {errors['bf16']:.4f}, int8 dynamic "
            f"{errors['int8_dynamic']:.4f}, int8 static {errors['int8_static']:.4f} deg; shifts {shifts} "
            f"(tripwire 3.0); the reloaded calibration predicts bit for bit")
        if not max(shifts.values()) <= 3.0:
            raise RuntimeError(f"int8 shifts the metric by {shifts} deg")
        out["metric_deg"] = errors
        out["int8_metric_shift_deg"] = shifts

        part("int8")
        # (f) serving numbers, same requests, host clock
        req64 = requests([PAIRS], seed=16)[0]
        out["serving"] = {name: time_serving(p, req64, n_iter=10)
                          for name, p in (("bf16", pbf16), ("int8_dynamic", p8), ("int8_static", ps))}
        log(f"serving at micro-batch 64: {out['serving']}")
        out["profiles"] = {name: profile_serving(p, req64)
                           for name, p in (("bf16", pbf16), ("int8_dynamic", p8), ("int8_static", ps))}
        for name, prof in out["profiles"].items():
            log(f"{name} serving profile: busy {prof['device_busy_ms_per_request']:.3f} of "
                f"{prof['window_ms_per_request']:.3f} ms per request; by class "
                f"{ {k: round(v, 3) for k, v in prof['device_ms_per_request_by_class'].items()} }")

        part("serving_numbers")
        # (e) export: bf16, dynamic int8 and V=3 bf16, served with the checkpoint
        out["artifacts"] = {}
        for name, live, reqs, nv in (("bf16", pbf16, req100, None), ("int8_dynamic", p8, req100, None),
                                     ("v3_bf16", mv, reqv, 3)):
            path = os.path.join(tmp, f"{name}.pt2")
            t0 = time.perf_counter()
            export_serving_artifact(live.model, path, micro_batch=PAIRS, image_size=224, num_views=nv)
            export_s = time.perf_counter() - t0
            aot = AotGazePredictor(path, stereo_ckpt)
            aot.predict(*(a[:1] for a in reqs))
            got_a, counts, by_variant, _ = counted(fusion, batchnorm, lambda: aot.predict(*reqs))
            check_served(f"{name} artifact", counts, by_variant, 0 if nv else 6, micro_batches)
            add(counts, by_variant)
            want = live.predict(*reqs)
            delta = angular_error_numpy(got_a, want)
            exact = bool(np.array_equal(got_a, want))
            size = os.path.getsize(path)
            log(f"{name} artifact: {size} bytes, exported in {export_s:.1f} s; {counts['fusion']} wgmma fuser "
                f"launches from the program; against the live predictor {'bit for bit' if exact else ''} max "
                f"{delta.max():.3e} deg (bar 1e-6)")
            if not (exact or delta.max() <= 1e-6):
                raise RuntimeError(f"{name} artifact predicts {delta.max()} deg from the live predictor")
            out["artifacts"][name] = {"bytes": size, "export_s": export_s, "bit_for_bit": exact,
                                      "max_delta_deg": float(delta.max()), "fuser_launches": counts["fusion"]}
            del aot
        del pbf16, p8, ps, mv
        torch.cuda.empty_cache()
        part("export")
    out["seconds_by_part"] = parts
    out["max_memory_allocated_mb"] = torch.cuda.max_memory_allocated() / 2**20
    out["seconds"] = time.perf_counter() - t_phase
    log(f"serving surface phase: peak {out['max_memory_allocated_mb']:.0f} MiB, {out['seconds']:.1f} s "
        f"{ {k: round(v, 1) for k, v in parts.items()} }")
    return {"launches": fuser_launches, "by_variant": fuser_by_variant, "numbers": out}


# ---------------------------------------------------------------------------
# the last training options and data parallelism (phase 12)
# ---------------------------------------------------------------------------

# launches per stereo update under --remat: the 52 BNs of R50's 16 blocks run
# their forward again in the backward, once per view (the stem's does not)
PER_STEP_REMAT = {**PER_STEP, "bn_stats": 210, "bn_apply": 210}
SUBSAMPLE = 2  # --bn_stat_subsample of phase 12a
DP_WORLD = 2  # phase 12d's ranks, both on the one card
# the finish kernel of each kernel whose statistics data parallelism reduces
DP_FINISH = {"bn_stats": "bn_stats_finish", "bn_bwd_reduce": "bn_bwd_finish"}


def check_prefix_kernels(batchnorm, cases) -> dict:
    """Phase 12a: the three kernels --bn_stat_subsample changes, on the
    prefix's path at each of ``cases`` (name, rows, C, relu, residual) with
    the first half of the rows as the prefix (k = 2: the first 32 of a
    view's 64 images), against their plain versions in float64 at phase 6a's
    bars, bf16 and f32: bn_stats on the prefix, bn_bwd_reduce over every row
    divided by the prefix's count, bn_bwd_dx with the statistics terms on
    the prefix rows only (the other rows exactly k*g'). With them the data
    parallelism's finish kernels: bn_stats' and bn_bwd_reduce's sums over
    the two halves of the rows, added (two ranks' all-reduce), then
    bn_stats_finish and bn_bwd_finish, against the float64 plain versions
    over all rows, and on all rows at once bit for bit the one-launch path.
    Returns each kernel's max |err| over the bf16 cases."""
    worst = {"bn_stats": 0.0, "bn_bwd_reduce": 0.0, "bn_bwd_dx": 0.0}
    for case, rows, c, relu, with_res in cases:
        n = rows // 2
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(rows + c + 7)
            x = (torch.randn(rows, c, device="cuda", generator=g) * 2 + 0.5).to(dtype)
            res = torch.randn(rows, c, device="cuda", generator=g).to(dtype) if with_res else None
            gy = torch.randn(rows, c, device="cuda", generator=g).to(dtype)
            scale = torch.rand(c, device="cuda", generator=g) + 0.5
            bias = torch.randn(c, device="cuda", generator=g) * 0.1
            gmean, gvar = torch.randn(c, device="cuda", generator=g), torch.randn(c, device="cuda", generator=g)
            mean, var, rstd, a, b = batchnorm.bn_stats(x[:n], scale, bias, 1e-5)
            y = batchnorm.bn_apply(x, a, b, res, relu)
            dscale, dbias, k, mg, mgx = batchnorm.bn_bwd_reduce(gy, y, x, mean, rstd, scale, relu, count=n)
            dx, _ = batchnorm.bn_bwd_dx(gy, y, x, mean, rstd, k, mg, mgx, gmean, gvar, relu, False,
                                        stat_rows=n, count=n)
            # the data-parallel path: one launch's results bit for bit, then two halves
            sums_all = batchnorm.bn_stats(x, scale, bias, 1e-5, sums=True)
            one = batchnorm.bn_stats(x, scale, bias, 1e-5)
            if not all(map(torch.equal, batchnorm.bn_stats_finish(sums_all, scale, bias, 1e-5), one)):
                raise RuntimeError(f"bn_stats_finish {case} {dtype}: not the one-launch path bit for bit")
            y_all = batchnorm.bn_apply(x, one[3], one[4], res, relu)
            red = batchnorm.bn_bwd_reduce(gy, y_all, x, one[0], one[2], scale, relu)
            gsums_all = batchnorm.bn_bwd_reduce(gy, y_all, x, one[0], one[2], scale, relu, sums=True)[3]
            if not all(map(torch.equal, batchnorm.bn_bwd_finish(gsums_all, sums_all), red[3:])):
                raise RuntimeError(f"bn_bwd_finish {case} {dtype}: not the one-launch path bit for bit")
            halves = (slice(0, n), slice(n, rows))
            sums = sum(batchnorm.bn_stats(x[h], scale, bias, 1e-5, sums=True) for h in halves)
            dmean, dvar, drstd, _, _ = batchnorm.bn_stats_finish(sums, scale, bias, 1e-5)
            gsums = sum(batchnorm.bn_bwd_reduce(gy[h], y_all[h], x[h], dmean, drstd, scale, relu, sums=True)[3]
                        for h in halves)
            dmg, dmgx = batchnorm.bn_bwd_finish(gsums, sums)
            torch.cuda.synchronize()
            g_masked = torch.where(y > 0, gy.float(), 0.0) if relu else gy.float()
            if not torch.equal(dx[n:], (k * g_masked[n:]).to(dtype)):
                raise RuntimeError(f"bn_bwd_dx {case} {dtype}: rows past the prefix are not k*g'")

            def d(t):
                return None if t is None else t.double()

            pm, pv, pr, pa, pb = batchnorm.bn_stats_reference(d(x[:n]), d(scale), d(bias), 1e-5)
            pds, pdb, pk, pmg, pmgx = batchnorm.bn_bwd_reduce_reference(
                d(gy), d(y), d(x), pm, pr, d(scale), relu, count=n)
            pdx, _ = batchnorm.bn_bwd_dx_reference(d(gy), d(y), d(x), pm, pr, pk, pmg, pmgx, d(gmean), d(gvar),
                                                   relu, False, stat_rows=n, count=n)
            am, av, ar, _, _ = batchnorm.bn_stats_reference(d(x), d(scale), d(bias), 1e-5)
            _, _, _, amg, amgx = batchnorm.bn_bwd_reduce_reference(d(gy), d(y_all), d(x), am, ar, d(scale), relu)
            f32 = dtype == torch.float32
            checks = [
                ("bn_stats", mean, pm, BN_FWD_TOL), ("bn_stats", var, pv, BN_FWD_TOL),
                ("bn_bwd_reduce", dscale, pds, BN_GRAD_TOL), ("bn_bwd_reduce", dbias, pdb, BN_GRAD_TOL),
                ("bn_bwd_reduce", mg, pmg, BN_GRAD_TOL), ("bn_bwd_reduce", mgx, pmgx, BN_GRAD_TOL),
                ("bn_bwd_dx", dx, pdx, BN_GRAD_TOL if f32 else BN_BF16_TOL),
                ("bn_stats", dmean, am, BN_FWD_TOL), ("bn_stats", dvar, av, BN_FWD_TOL),
                ("bn_bwd_reduce", dmg, amg, BN_GRAD_TOL), ("bn_bwd_reduce", dmgx, amgx, BN_GRAD_TOL),
            ]
            for name, got, want, (atol, rtol) in checks:
                torch.testing.assert_close(got.double(), want, atol=atol, rtol=rtol,
                                           msg=lambda m: f"{name} prefix/finish {case} {dtype}: {m}")
                if not f32:
                    worst[name] = max(worst[name], (got.double() - want).abs().max().item())
    log(f"prefix and data-parallel finish kernels held to float64 at {len(cases)} shapes, bf16 and f32; "
        f"bf16 max |err| {worst}")
    return worst


def time_options_bn(batchnorm, shapes) -> dict:
    """Phase 12a's timings over the 106 BN calls of one 64-pair step (bf16,
    device_ms, in turns with the k = 1 path on the same calls): bn_stats on
    the prefix (k = 2), bn_bwd_reduce with its count, bn_bwd_dx with the
    prefix; and the data-parallel path without its all-reduce: bn_stats'
    sums then bn_stats_finish, bn_bwd_reduce's sums then bn_bwd_finish, and
    the two finish kernels alone."""
    calls = bn_calls(batchnorm, shapes, seed=43)
    for q in calls:
        q["n"] = q["rows"] // SUBSAMPLE
        q["sums"] = batchnorm.bn_stats(q["x"], q["scale"], q["bias"], 1e-5, sums=True)
        q["gsums"] = batchnorm.bn_bwd_reduce(q["gy"], q["y"], q["x"], q["mean"], q["rstd"], q["scale"],
                                             q["relu"], sums=True)[3]

    def each(fn):
        def run(_):
            for q in calls:
                fn(q)
        return run

    runners = {
        "bn_stats_prefix": each(lambda q: batchnorm.bn_stats(q["x"][:q["n"]], q["scale"], q["bias"], 1e-5)),
        "bn_bwd_reduce_prefix": each(lambda q: batchnorm.bn_bwd_reduce(
            q["gy"], q["y"], q["x"], q["mean"], q["rstd"], q["scale"], q["relu"], count=q["n"])),
        "bn_bwd_dx_prefix": each(lambda q: batchnorm.bn_bwd_dx(
            q["gy"], q["y"], q["x"], q["mean"], q["rstd"], q["k"], q["mg"], q["mgx"], None, None, q["relu"],
            q["relu"] and q["res"], stat_rows=q["n"], count=q["n"])),
        "bn_stats_sums_and_finish": each(lambda q: batchnorm.bn_stats_finish(
            batchnorm.bn_stats(q["x"], q["scale"], q["bias"], 1e-5, sums=True), q["scale"], q["bias"], 1e-5)),
        "bn_bwd_reduce_sums_and_finish": each(lambda q: batchnorm.bn_bwd_finish(batchnorm.bn_bwd_reduce(
            q["gy"], q["y"], q["x"], q["mean"], q["rstd"], q["scale"], q["relu"], sums=True)[3], q["sums"])),
        "bn_stats_finish_alone": each(lambda q: batchnorm.bn_stats_finish(q["sums"], q["scale"], q["bias"], 1e-5)),
        "bn_bwd_finish_alone": each(lambda q: batchnorm.bn_bwd_finish(q["gsums"], q["sums"])),
    }
    k1_of = {"bn_stats_prefix": "bn_stats", "bn_bwd_reduce_prefix": "bn_bwd_reduce",
             "bn_bwd_dx_prefix": "bn_bwd_dx", "bn_stats_sums_and_finish": "bn_stats",
             "bn_bwd_reduce_sums_and_finish": "bn_bwd_reduce"}
    out = {}
    for name, fn in runners.items():
        base = k1_of.get(name)
        k1 = bn_runner(batchnorm, calls, base) if base else None
        # k = 1, this path, this path, k = 1: in turns on the same calls
        a1 = device_ms(k1) if k1 else None
        t1, t2 = device_ms(fn), device_ms(fn)
        a2 = device_ms(k1) if k1 else None
        out[name] = {"ms": min(t1, t2), "runs_ms": [t1, t2]}
        if k1:
            out[name].update(k1_ms=min(a1, a2), k1_runs_ms=[a1, a2], k1_kernel=base)
    log("options' BN paths over the step's 106 calls (device ms; k = 1 beside): "
        + "; ".join(f"{n} {r['ms']:.4f}" + (f" (k=1 {r['k1_ms']:.4f})" if "k1_ms" in r else "")
                    for n, r in out.items()))
    return out


def model_buffers(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def compare_remat(fusion, batchnorm, state, batch, seed=52) -> dict:
    """Phase 12b: one bf16 update with --remat against the same update
    without it, from one saved state and one generator seed: losses within
    1% and pred_gaze's mean angular delta <= 0.1 deg (phase 7b's bf16
    bars), every gradient within atol 5e-3 / rtol 5e-2 and every BN buffer
    within 1e-4 (phase 7b's f32 gradient bar and the running statistics'
    bar; cuDNN deterministic for the two updates), each BN's
    num_batches_tracked moved by 2 (once per view: the recompute moved
    none); launches 210 / 210 / 106 / 106 and 6 against 106 each and 6;
    torch.cuda.max_memory_allocated of each update."""
    from rot_mvgaze_tpu_torch.geometry import angular_error_numpy

    runs = {}
    for remat in (False, True):
        model, step = make_trainer(state, torch.bfloat16, flags={"remat": True} if remat else None)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fusion, batchnorm)
        stats = step(batch, torch.Generator(device="cuda").manual_seed(seed), step=0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        counts = launch_counts(fusion, batchnorm)
        want = PER_STEP_REMAT if remat else PER_STEP
        if counts != want or fusion.rotate_concat_matmul_relu.launches_by_variant["wgmma"] != 6:
            raise RuntimeError(f"remat={remat} update launched {counts}, expected {want}")
        runs[remat] = {"loss": float(stats["loss_gaze"]), "pred": stats["pred_gaze"].float().cpu().numpy(),
                       "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()
                                 if p.grad is not None},
                       "buffers": model_buffers(model), "peak_mib": peak, "counts": counts}
        del model, step
    a, b = runs[False], runs[True]
    rel = abs(b["loss"] - a["loss"]) / abs(a["loss"])
    delta = float(angular_error_numpy(b["pred"], a["pred"]).mean())
    if not (rel <= 1e-2 and delta <= 0.1):
        raise RuntimeError(f"remat update deviates: loss rel {rel}, pred_gaze {delta} deg")
    worst_grad, bit_equal = 0.0, True
    for n, g in a["grads"].items():
        torch.testing.assert_close(b["grads"][n], g, atol=5e-3, rtol=5e-2, msg=lambda m: f"remat grad {n}: {m}")
        worst_grad = max(worst_grad, (b["grads"][n] - g).abs().max().item())
        bit_equal &= torch.equal(b["grads"][n], g)
    for n, v in a["buffers"].items():
        if n.endswith("num_batches_tracked"):
            if int(v) != 2 or int(b["buffers"][n]) != 2:
                raise RuntimeError(f"{n}: num_batches_tracked {int(v)} and {int(b['buffers'][n])} under "
                                   f"remat, expected 2 (once per view)")
            continue
        torch.testing.assert_close(b["buffers"][n], v, atol=1e-4, rtol=0, msg=lambda m: f"remat buffer {n}: {m}")
    log(f"remat against plain (bf16, 64 pairs): loss {b['loss']:.6f} vs {a['loss']:.6f} (rel {rel:.2e}); "
        f"pred_gaze delta {delta:.3e} deg; gradients max |diff| {worst_grad:.3e} (bit for bit: {bit_equal}); "
        f"launches {b['counts']} vs {a['counts']}; peak memory {b['peak_mib']:.0f} vs {a['peak_mib']:.0f} MiB")
    return {"loss_rel": rel, "delta_deg": delta, "max_grad_diff": worst_grad, "grads_bit_for_bit": bit_equal,
            "peak_mib_remat": b["peak_mib"], "peak_mib_plain": a["peak_mib"],
            "launches_remat": b["counts"], "launches_plain": a["counts"]}


def run_profile_trainer(fusion, batchnorm) -> dict:
    """Phase 12c: the Trainer with profile_steps 2 over one epoch of 3
    updates (an in-memory corpus of 216 pairs): exactly one trace file in
    <output_dir>/profile, holding 2 optimizer steps (the first update is
    outside the window), and of each BN kernel more than one update's 106
    records and at most two updates' (the wgmma fuser: 6, 12; CUPTI may drop
    a record); every update 106 launches per BN kernel and 6 fuser."""
    from rot_mvgaze_tpu_torch.data import InMemoryGazeDataset

    train_ds = InMemoryGazeDataset(2, n_frames=6, image_size=224, seed=0, learnable=True)
    test_ds = InMemoryGazeDataset(1, n_frames=1, image_size=224, seed=100, learnable=True)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = port_trainer(tmp, train_ds, test_ds, epochs=1, profile_steps=2)
        steps = record_steps(trainer, fusion, batchnorm)
        reset_counts(fusion, batchnorm)
        trainer.train_one_epoch(0)
        launches = launch_counts(fusion, batchnorm)
        check_steps("profile_steps 2", steps, PER_STEP, 3)
        files = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(tmp, "profile")) for f in fs]
        if files != [trainer.profile_trace]:
            raise RuntimeError(f"profile_steps: trace files {files}, expected one ({trainer.profile_trace})")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(files[0])
    names = [e.get("name", "") for e in events]
    # the host's range of each optimizer step (the device timeline repeats
    # it as a gpu_user_annotation)
    counts = {"optimizer_steps": sum(e.get("name", "").startswith("Optimizer.step#Adam.step")
                                     and e.get("cat") != "gpu_user_annotation" for e in events)}
    for kind in BN_KERNELS:
        counts[kind] = sum(f"{kind}_kernel<" in n for n in names)
    counts["fusion"] = sum("fusion_wgmma_kernel<" in n for n in names)
    # two updates' records, the first update's none (CUPTI may drop a record)
    ok = counts["optimizer_steps"] == 2 and all(106 < counts[k] <= 2 * 106 for k in BN_KERNELS) \
        and 6 < counts["fusion"] <= 12
    if not ok:
        raise RuntimeError(f"profile trace records {counts}: expected 2 optimizer steps and, of each BN "
                           f"kernel, more than one update's 106 and at most two updates' (fuser: 6, 12)")
    log(f"profile_steps 2 through the Trainer: one trace ({size} bytes), records {counts}")
    return {"launches": launches, "trace_records": counts, "trace_bytes": size}


def dp_step(model, step, batch, seed) -> dict:
    """One update of phase 12d: loss, pred_gaze, gradients, and the state
    after Adam (CPU tensors)."""
    stats = step(batch, torch.Generator(device="cuda").manual_seed(seed), step=0)
    torch.cuda.synchronize()
    return {"loss": float(stats["loss_gaze"]), "pred": stats["pred_gaze"].float().cpu(),
            "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None},
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


def dp_worker(mode: str, work: str) -> None:
    """One process of phase 12d (started by run_dp_phase with torchrun's
    variables): ``gloo`` ranks train on their rows of the saved batch, over
    CUDA tensors on the one card; ``nccl1`` is a world of one over nccl that
    runs the same update without a group and then through the group path.
    Saves its readings to ``work``."""
    from rot_mvgaze_tpu_torch import parallel
    from rot_mvgaze_tpu_torch.kernels import build
    from rot_mvgaze_tpu_torch.ops import batchnorm, fusion

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    build.build()
    state = torch.load(os.path.join(work, "state.pt"))
    full = torch.load(os.path.join(work, "batch.pt"))
    out = {}
    if mode == "nccl1":
        for dtype in (torch.bfloat16, torch.float32):
            model, step = make_trainer(state, dtype)
            out[f"none_{dtype}"] = dp_step(model, step, {k: v.cuda() for k, v in full.items()}, seed=62)
            del model, step
        if not parallel.initialize("cuda", backend="nccl"):
            raise RuntimeError("the nccl world of one did not start")
    else:
        if not parallel.initialize("cuda", backend="gloo"):
            raise RuntimeError("the gloo ranks did not start")
    rank, world, group = parallel.process_index(), parallel.process_count(), torch.distributed.group.WORLD
    n = full["img_0"].shape[0] // world
    local = {k: v[rank * n:(rank + 1) * n].cuda() for k, v in full.items()}
    for dtype in (torch.bfloat16, torch.float32):
        model, step = make_trainer(state, dtype, group=group)
        reset_counts(fusion, batchnorm)
        batchnorm.bn_stats.finish_launches = batchnorm.bn_bwd_reduce.finish_launches = 0
        reading = dp_step(model, step, local, seed=62)
        reading["launches"] = {**launch_counts(fusion, batchnorm),
                               "bn_stats_finish": batchnorm.bn_stats.finish_launches,
                               "bn_bwd_finish": batchnorm.bn_bwd_reduce.finish_launches}
        out[f"group_{dtype}"] = reading
        del model, step
    torch.save(out, os.path.join(work, f"{mode}_rank{rank}.pt"))
    parallel.shutdown()


def launch_dp(mode: str, world: int, work: str, timeout: float = 300) -> list:
    """Start ``world`` dp_worker processes of ``mode`` with torchrun's
    variables (every rank on card 0) and wait for them; their readings."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker", mode, work],
                                      cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{mode} rank {rank} failed (exit {p.returncode}):\n{text[-6000:]}")
    return [torch.load(os.path.join(work, f"{mode}_rank{r}.pt")) for r in range(world)]


def held_as_one_process(name, dtype, ranks, single, state, batch, seed) -> dict:
    """Phase 12d's bars for the ranks' update against one process's on the
    concatenated batch. bf16 (phase 7b's bars): loss within 1%, and the
    updated model's float32 eval predictions on the batch within 0.1 deg
    mean; the train forward's pred_gaze (the ranks' rows in order) is read.
    f32 (phase 7b's f32
    bars): loss rtol 1e-4, gradients by hold_f32_grads against a float64
    step, the updated model's eval predictions at phase 4's f32 bar (atol
    2e-4 / rtol 1e-3), every BN running buffer within 1e-4. Both: every
    rank's state the same bits (global statistics: local ones would differ
    by rank); the buffers' largest norm-relative difference is read."""
    from rot_mvgaze_tpu_torch.geometry import angular_error_numpy

    for r in ranks[1:]:
        for k, v in ranks[0]["state"].items():
            if not torch.equal(r["state"][k], v):
                raise RuntimeError(f"{name}: ranks disagree on {k}")
    loss = ranks[0]["loss"]
    rel = abs(loss - single["loss"]) / abs(single["loss"])
    pred = torch.cat([r["pred"] for r in ranks]).numpy()
    delta = float(angular_error_numpy(pred, single["pred"].numpy()).mean())
    eval_batch = {k: v.cuda() for k, v in batch.items()}

    def evaluate(sd):
        from rot_mvgaze_tpu_torch.train.steps import make_eval_step

        model = family_model({})
        model.load_state_dict(sd, strict=True)
        model = model.to(device="cuda", memory_format=torch.channels_last)
        return make_eval_step(model, 224)(eval_batch)["pred_gaze"].cpu().numpy()

    e_ranks, e_single = evaluate(ranks[0]["state"]), evaluate(single["state"])
    eval_delta = float(angular_error_numpy(e_ranks, e_single).mean())
    # the running statistics. That they are the global batch's shows in the
    # ranks' buffers being the same bits (above): local statistics would
    # differ by rank. Against one process, f32 holds them within 1e-4. bf16
    # is read, not held: cuDNN and cuBLAS pick their kernels by batch size,
    # so 32 and 64 images round their bf16 activations (2^-9 of each) apart
    # from the augmentation's resize on, and the random-init R50 amplifies
    # that layer by layer; phase 7b holds bf16 by the loss and pred_gaze.
    buffer_rel = 0.0
    for k, v in single["state"].items():
        if "running" not in k:
            continue
        if dtype == torch.float32:
            torch.testing.assert_close(ranks[0]["state"][k], v, atol=1e-4, rtol=0, msg=lambda m: f"{name} {k}: {m}")
        buffer_rel = max(buffer_rel, float((ranks[0]["state"][k].double() - v.double()).norm()
                                           / max(v.double().norm(), 1e-30)))
    out = {"loss_rel": rel, "pred_delta_deg": delta, "eval_delta_deg_after_adam": eval_delta,
           "running_buffers_max_norm_rel_diff": buffer_rel}
    if dtype == torch.bfloat16:
        # the update is what the ranks must get right: its loss and the
        # model after Adam. The train forward's pred_gaze is read: 32 and 64
        # images take other conv and GEMM kernels, whose bf16 roundings
        # (2^-9) the random-init R50 amplifies as it does f32's (2^-24),
        # which the f32 update below holds
        if not (rel <= 1e-2 and eval_delta <= 0.1):
            raise RuntimeError(f"{name}: loss rel {rel}, after Adam {eval_delta} deg")
    else:
        np.testing.assert_allclose(loss, single["loss"], rtol=1e-4)
        np.testing.assert_allclose(e_ranks, e_single, atol=2e-4, rtol=1e-3)
        _, g64 = reference_step_f64(state, eval_batch, seed=seed)
        worst, ill = hold_f32_grads(name, {n: g.cuda() for n, g in ranks[0]["grads"].items()},
                                    {n: g.cuda() for n, g in single["grads"].items()}, g64)
        out.update(max_grad_diff=worst, ill_conditioned=ill)
    log(f"{name}: {len(ranks)} ranks against one process: {out}")
    return out


def run_dp_phase(fusion, batchnorm, seed=62) -> dict:
    """Phase 12d: data parallelism. Two gloo ranks on the one card (CUDA
    tensors), 32 pairs each, against one process on the concatenated 64
    pairs, from one saved state, bf16 and f32 (held_as_one_process);
    launches per rank per update: 106 per BN kernel, 6 fuser, 106 of each
    finish kernel. Then a world of one over nccl: the group path (sums,
    all-reduce, finish kernels, the gradients' all-reduce) bit for bit the
    path without a group, in one process. cuDNN deterministic throughout.
    NCCL across cards is not measured (one card)."""
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.manual_seed(3)
    state = FeatRotationSymm(backbone_depth=50, num_iter=3).state_dict()
    batch = {k: v.cpu() for k, v in training_batch(seed=61).items()}
    out = {}
    try:
        with tempfile.TemporaryDirectory() as work:
            torch.save(state, os.path.join(work, "state.pt"))
            torch.save(batch, os.path.join(work, "batch.pt"))
            t0 = time.perf_counter()
            ranks = launch_dp("gloo", DP_WORLD, work)
            out["gloo_seconds"] = time.perf_counter() - t0
            for dtype in (torch.bfloat16, torch.float32):
                model, step = make_trainer(state, dtype)
                single = dp_step(model, step, {k: v.cuda() for k, v in batch.items()}, seed)
                del model, step
                torch.cuda.empty_cache()
                readings = [r[f"group_{dtype}"] for r in ranks]
                want = {**PER_STEP, "bn_stats_finish": 106, "bn_bwd_finish": 106}
                for r, reading in enumerate(readings):
                    if reading["launches"] != want:
                        raise RuntimeError(f"gloo rank {r} ({dtype}) launched {reading['launches']}, "
                                           f"expected {want}")
                name = f"dp_gloo_{str(dtype)[6:]}"
                out[name] = held_as_one_process(name, dtype, readings, single, state, batch, seed)
                out[name]["launches_per_rank"] = [reading["launches"] for reading in readings]
            del ranks
            t0 = time.perf_counter()
            (one,) = launch_dp("nccl1", 1, work)
            out["nccl1_seconds"] = time.perf_counter() - t0
            for dtype in (torch.bfloat16, torch.float32):
                a, b = one[f"none_{dtype}"], one[f"group_{dtype}"]
                same = a["loss"] == b["loss"] and torch.equal(a["pred"], b["pred"]) and all(
                    torch.equal(a["grads"][n], b["grads"][n]) for n in a["grads"]) and all(
                    torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
                if not same:
                    raise RuntimeError(f"nccl world of one ({dtype}): the group path is not the "
                                       f"no-group path bit for bit")
                out[f"nccl1_{str(dtype)[6:]}_bit_for_bit"] = True
                out[f"nccl1_{str(dtype)[6:]}_launches"] = b["launches"]
            log(f"nccl world of one: loss, pred_gaze, every gradient and the state after Adam bit for bit "
                f"the no-group path, bf16 and f32; launches {one[f'group_{torch.bfloat16}']['launches']}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
    return out


def run_options_phase(fusion, batchnorm, bn_shapes) -> dict:
    """Phase 12: --bn_stat_subsample (a), --remat (b), --profile_steps (c)
    and data parallelism (d) at R50 x 3, full width. Returns the main path's
    launches (a-c, counts set to 0 just before each update and read just
    after), the DP ranks' launches and the numbers."""
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm

    t_phase = time.perf_counter()
    torch.manual_seed(5)
    state = FeatRotationSymm(backbone_depth=50, num_iter=3).state_dict()
    batch = training_batch(seed=51)
    numbers, launches = {}, dict.fromkeys(PER_STEP, 0)
    seconds = {}
    # (a) the subsample: kernels against plain in both dtypes, then the
    # changed kernels against float64 at every prefix shape, and their times
    t0 = time.perf_counter()
    for dtype in (torch.bfloat16, torch.float32):
        name = f"subsample_{str(dtype)[6:]}"
        numbers.update(compare_paths(fusion, batchnorm, f"--bn_stat_subsample {SUBSAMPLE} step {name}", name,
                                     state, batch, dtype, PER_STEP, flags={"bn_stat_subsample": SUBSAMPLE}))
        for k, v in PER_STEP.items():
            launches[k] += v
    numbers["prefix_bn_max_abs_err_bf16"] = check_prefix_kernels(batchnorm, step_bn_cases(PAIRS))
    numbers["options_bn_ms_per_step"] = time_options_bn(batchnorm, bn_shapes)
    seconds["subsample"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # (b) remat
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        numbers["remat"] = compare_remat(fusion, batchnorm, state, batch)
    finally:
        torch.backends.cudnn.deterministic = False
    for k in launches:
        launches[k] += PER_STEP[k] + PER_STEP_REMAT[k]
    seconds["remat"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # (c) the profiler window through the Trainer
    t0 = time.perf_counter()
    prof = run_profile_trainer(fusion, batchnorm)
    numbers["profile"] = {k: prof[k] for k in ("trace_records", "trace_bytes")}
    for k in launches:
        launches[k] += prof["launches"][k]
    seconds["profile"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # (d) data parallelism
    t0 = time.perf_counter()
    numbers["data_parallel"] = run_dp_phase(fusion, batchnorm)
    seconds["data_parallel"] = time.perf_counter() - t0
    dp_launches = [numbers["data_parallel"][f"dp_gloo_{t}"]["launches_per_rank"] for t in ("bfloat16", "float32")]
    numbers["seconds"] = time.perf_counter() - t_phase
    numbers["seconds_by_part"] = seconds
    log(f"options phase: {numbers['seconds']:.1f} s {seconds}")
    return {"launches": launches, "dp_launches": dp_launches, "numbers": numbers}


# ---------------------------------------------------------------------------
# phase 13: mesh serving and spatial partitioning
# ---------------------------------------------------------------------------

# (data, spatial) logical meshes of phase 13a, on cuda:0
MESH_LAYOUTS = ((2, 1), (1, 2), (2, 2), (1, 4))
MESH_MICRO_BATCH = 63  # rounds up to 64 on two data replicas, stays 63 on one
# launches per bf16 update of 64 pairs on a spatial mesh at 224x224 (the
# counts PERF.md §6 predicted): every BN call of both views on its strips (2
# launches of each kernel and one of each finish kernel over 2 strips); over
# 4 strips layer4's 7 rows would split 2, 2, 2, 1, so its 10 BN calls a view
# run on the gathered map (the one-launch path) and the other 43 on 4 strips
PER_SPATIAL_UPDATE = {
    2: {**PER_STEP, **{k: 2 * 106 for k in BN_KERNELS}, "bn_stats_finish": 106, "bn_bwd_finish": 106},
    4: {**PER_STEP, **{k: 4 * 86 + 20 for k in BN_KERNELS}, "bn_stats_finish": 86, "bn_bwd_finish": 86},
}


def reset_mesh_counts(fusion, batchnorm) -> None:
    reset_counts(fusion, batchnorm)
    batchnorm.bn_stats.finish_launches = batchnorm.bn_bwd_reduce.finish_launches = 0


def mesh_counts(fusion, batchnorm) -> dict:
    return {**launch_counts(fusion, batchnorm), "bn_stats_finish": batchnorm.bn_stats.finish_launches,
            "bn_bwd_finish": batchnorm.bn_bwd_reduce.finish_launches}


def serve_on_mesh(fusion, batchnorm, pred, req, data: int) -> tuple:
    """One counted predict of ``req`` through a mesh predictor: (pitchyaw,
    counts); the fuser must launch 6 times per data replica and micro-batch,
    of the variant its dtype takes, and no train-mode BN or conv kernel."""
    reset_mesh_counts(fusion, batchnorm)
    mb_before = pred.micro_batches_run
    out = pred.predict(*req)
    counts = mesh_counts(fusion, batchnorm)
    micro_batches = pred.micro_batches_run - mb_before
    variant = "wgmma" if pred.model._lifter._lifter.blocks[0][0].weight.dtype == torch.bfloat16 else "generic"
    if counts["fusion"] != 6 * data * micro_batches or \
            fusion.rotate_concat_matmul_relu.launches_by_variant[variant] != counts["fusion"]:
        raise RuntimeError(f"mesh serving launched {counts} ({fusion.rotate_concat_matmul_relu.launches_by_variant})"
                           f" over {micro_batches} micro-batches x {data} replicas, expected 6 {variant} each")
    if any(counts[k] for k in BN_KERNELS) or counts["conv3x3_bn_stats"] or counts["bn_stats_finish"]:
        raise RuntimeError(f"mesh serving launched train-mode BN or conv kernels: {counts}")
    if out.shape != (req[0].shape[0], 2) or not np.all(np.isfinite(out)):
        raise RuntimeError(f"mesh serving returned {out.shape}, finite: {np.isfinite(out).all()}")
    return out, counts


def run_mesh_serving(fusion, batchnorm, ckpt: str, devices: list) -> dict:
    """Phase 13a on ``devices`` (a logical mesh on cuda:0: each layout's
    devices repeat it): each (data, spatial) layout of MESH_LAYOUTS serves
    100 pairs in bf16 and f32 beside the single-card predictor (phase 4's
    bars: bf16 mean delta <= 0.1 deg, f32 atol 2e-4 / rtol 1e-3), the
    micro-batch rounding, the launches, images/s and p50 of the bf16
    predictor; then serve.py's --dp --spatial_partition 2 over HTTP."""
    from rot_mvgaze_tpu_torch import serve
    from rot_mvgaze_tpu_torch.geometry import angular_error_numpy
    from rot_mvgaze_tpu_torch.parallel import make_mesh
    from rot_mvgaze_tpu_torch.serving import BatchingPredictor, GazePredictor

    kw = dict(backbone_depth=50, num_iter=3, image_size=224)
    req = requests([100], seed=81)[0]
    timed = requests([64], seed=82)[0]
    out, launches, single = {}, 0, {}

    def one_card(dtype, micro_batch):
        """The single-card predictor's pitchyaw of ``req`` at ``micro_batch``
        (a mesh replica's rows per call: the same shapes, so the same cuDNN
        and cuBLAS kernels, whose bf16 roundings the random-init R50
        amplifies past 0.1 deg between batch sizes)."""
        if (dtype, micro_batch) not in single:
            pred = GazePredictor(ckpt, micro_batch=micro_batch, dtype=dtype, device=devices[0], **kw)
            single[dtype, micro_batch] = pred.predict(*req)
            if (dtype, micro_batch) == (torch.bfloat16, 64):
                out["single_card"] = time_serving(pred, timed, n_iter=5)
            del pred
        return single[dtype, micro_batch]

    # the card's own bf16 spread between two micro-batch sizes: the random-init
    # R50 turns the per-shape kernels' roundings into this much (phase 12d
    # reads 0.4 deg in training between batches of 32 and 64 images)
    spread = float(angular_error_numpy(one_card(torch.bfloat16, 64), one_card(torch.bfloat16, 32)).mean())
    bf16_bar = max(0.1, 1.5 * spread)
    out["one_card_bf16_spread_deg_micro_batch_32_vs_64"] = spread
    log(f"one card, bf16, micro-batch 32 against 64: mean delta {spread:.4e} deg; mesh bf16 bar {bf16_bar:.4f} deg")
    for data, sp in MESH_LAYOUTS:
        name = f"data{data}_spatial{sp}"
        mesh = make_mesh(devices[:data * sp] if len(devices) >= data * sp else [devices[0]] * (data * sp),
                         spatial=sp)
        rec = {"devices": [[str(d) for d in row] for row in mesh.grid]}
        for dtype in (torch.bfloat16, torch.float32):
            pred = GazePredictor(ckpt, micro_batch=MESH_MICRO_BATCH, dtype=dtype, mesh=mesh, **kw)
            want_mb = -(-MESH_MICRO_BATCH // data) * data
            if pred.micro_batch != want_mb:
                raise RuntimeError(f"{name}: micro-batch {pred.micro_batch}, expected {want_mb}")
            got, counts = serve_on_mesh(fusion, batchnorm, pred, req, data)
            launches += counts["fusion"]
            want = one_card(dtype, pred.micro_batch // data)
            if dtype == torch.bfloat16:
                delta = float(angular_error_numpy(got, want).mean())
                if not delta <= (0.1 if sp == 1 else bf16_bar):
                    raise RuntimeError(f"{name} bf16 serving deviates from one card by {delta} deg")
                rec.update(micro_batch=pred.micro_batch, bf16_delta_deg=delta, fuser_launches_bf16=counts["fusion"],
                           bf16_delta_deg_vs_micro_batch_64=float(
                               angular_error_numpy(got, one_card(dtype, 64)).mean()),
                           **{f"bf16_{k}": v for k, v in time_serving(pred, timed, n_iter=5).items()})
            else:
                err = float(np.abs(got - want).max())
                np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
                rec["f32_max_abs_diff"] = err
            del pred
        log(f"mesh serving {name}: micro-batch {rec['micro_batch']}, bf16 delta {rec['bf16_delta_deg']:.3e} deg "
            f"({rec['bf16_delta_deg_vs_micro_batch_64']:.3e} against one card at micro-batch 64), "
            f"f32 max |diff| {rec['f32_max_abs_diff']:.3e}, {rec['bf16_serve_imgs_per_s']:.1f} images/s, p50 "
            f"{rec['bf16_serve_p50_ms']:.2f} ms (one card: {out['single_card']['serve_imgs_per_s']:.1f}, "
            f"{out['single_card']['serve_p50_ms']:.2f} ms)")
        out[name] = rec
        torch.cuda.empty_cache()

    # serve.py --dp --spatial_partition 2 over HTTP on 127.0.0.1
    n_dev = 4 if len(devices) < 4 else len(devices) - len(devices) % 2
    listed = ",".join(str(d) for d in (devices[:n_dev] if len(devices) >= 4 else [devices[0]] * 4))
    args = serve.get_parser().parse_args(["--ckpt", ckpt, "--dp", "--spatial_partition", "2", "--device", listed,
                                          "--host", "127.0.0.1", "--port", "0"])
    if serve.refused(args) or not serve.serves_on_a_mesh(args):
        raise RuntimeError(f"serve.py refused {listed}: {serve.refused(args)}")
    pred = serve.build_predictor(args)
    pred.warmup()
    batching = BatchingPredictor(pred, max_delay_ms=5.0)
    stats = {"requests": 0, "samples": 0, "time": 0.0}
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.build_handler(batching, stats))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    reqs = requests([1, 17, 64, 100], seed=83)
    try:
        reset_mesh_counts(fusion, batchnorm)
        mb_before = pred.micro_batches_run
        replies = [post_predict(httpd.server_address[1], pred.request_fields, r) for r in reqs]
        http_launches = fusion.rotate_concat_matmul_relu.launches
        micro_batches = pred.micro_batches_run - mb_before
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
        batching.close()
    dp = len(pred.mesh.grid)
    if http_launches != 6 * dp * micro_batches:
        raise RuntimeError(f"serve.py over the mesh: {http_launches} fuser launches, expected 6 x {dp} x "
                           f"{micro_batches}")
    for r, reply in zip(reqs, replies):
        np.testing.assert_allclose(reply, pred.predict(*r), atol=1e-3, rtol=0)
    launches += http_launches
    out["serve_py_http"] = {"devices": listed, "micro_batch": pred.micro_batch, "requests": stats["requests"],
                            "micro_batches": micro_batches, "fuser_launches": http_launches}
    log(f"serve.py --dp --spatial_partition 2 --device {listed}: {stats['requests']} HTTP requests, "
        f"{micro_batches} micro-batches, {http_launches} fuser launches, replies equal direct predicts")
    del pred
    return {"numbers": out, "launches": launches}


def record_strip_shapes(model, shapes: list) -> list:
    """Forward pre-hooks appending ((rows, C), relu, residual) of every
    block of each BatchNormAct call on height strips; returns the hooks."""
    from rot_mvgaze_tpu_torch.models.norm import BatchNormAct
    from rot_mvgaze_tpu_torch.parallel import Sharded

    def hook(mod, args):
        x = args[0]
        if isinstance(x, Sharded):
            res = len(args) > 1 and args[1] is not None
            shapes.extend(((t.shape[0] * t.shape[2] * t.shape[3], t.shape[1]), mod.relu, res) for t in x.blocks())

    return [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, BatchNormAct)]


def mesh_update(fusion, batchnorm, state, batch, dtype, devices, layout, flags=None, seed=91, shapes=None) -> dict:
    """One update of 64 pairs (or V-view frames) of the configuration
    ``flags`` (family_model) from ``state`` on a (data, spatial) ``layout``
    of ``devices``, repeated where the list is shorter (a logical mesh;
    None: unsharded on the first), counts set to 0 just before and read
    just after; its loss, pred_gaze, gradients, BN buffers and counts."""
    from rot_mvgaze_tpu_torch.parallel import make_mesh, with_spatial_floor
    from rot_mvgaze_tpu_torch.train import (
        cyclic_triangular2,
        make_multiview_train_step,
        make_optimizer,
        make_train_step,
    )

    flags = flags or {}
    mesh = None
    if layout is not None:
        data, sp = layout
        mesh = make_mesh([devices[i % len(devices)] for i in range(data * sp)], spatial=sp)
    model = family_model(flags)
    model.load_state_dict(state, strict=True)
    model = with_spatial_floor(model.to(device=devices[0], memory_format=torch.channels_last), mesh)
    factory = make_multiview_train_step if family_views(flags) > 2 else make_train_step
    step = factory(model, family_metrics(flags), make_optimizer(model.parameters()), image_size=224,
                   schedule=cyclic_triangular2(1e-6, 1e-3, step_size_up=50, step_size_down=50),
                   compute_dtype=dtype, mesh=mesh)
    hooks = [] if shapes is None else record_strip_shapes(model, shapes)
    reset_mesh_counts(fusion, batchnorm)
    stats = step(batch, torch.Generator(device=devices[0]).manual_seed(seed), step=0)
    torch.cuda.synchronize()
    counts = mesh_counts(fusion, batchnorm)
    for h in hooks:
        h.remove()
    return {"loss": float(stats["loss_gaze"]), "pred": stats["pred_gaze"].float().cpu().numpy(),
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None},
            "buffers": model_buffers(model), "counts": counts, "model": model, "step": step}


def grad_gap(grads: dict, anchor: dict) -> float:
    """Norm-relative distance of a whole gradient from ``anchor``'s, in
    float64, over every leaf."""
    num = sum(float((grads[n].double() - a.double()).square().sum()) for n, a in anchor.items())
    den = sum(float(a.double().square().sum()) for a in anchor.values())
    return (num / den) ** 0.5


def time_updates(run, batch, n=3) -> float:
    """Host ms per update over ``n`` updates of a warm (model, step) pair,
    each ending in a synchronize."""
    step = run["step"]
    gen = torch.Generator(device=next(iter(batch.values())).device).manual_seed(92)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        float(step(batch, gen, step=1 + i)["loss_gaze"])
    return (time.perf_counter() - t0) * 1e3 / n


def run_spatial_training(fusion, batchnorm, devices: list) -> dict:
    """Phase 13b from one saved state and one generator seed: one f32
    update of 64 pairs under (data 1, spatial 2) and under (data 1, spatial
    4) against the unsharded f32 update (loss rtol 1e-4, gradients at phase
    7b's f32 bars against a float64 step, BN buffers within 1e-4); one bf16
    update under each against the unsharded bf16 update (phase 7b's bars:
    loss within 1%, pred_gaze within 0.1 deg; where pred_gaze moves past
    0.1 deg, it must be no farther from the f32 unsharded update's than
    1.5x the unsharded bf16 update's, the rule of hold_f32_grads; the whole
    gradient's distance from the f32 update's is recorded beside the
    unsharded bf16 update's), with the predicted launches
    (PER_SPATIAL_UPDATE); the step's host ms beside the unsharded step's;
    the BN kernels against float64 at every distinct strip shape of the
    (1, 2) update."""
    from rot_mvgaze_tpu_torch.geometry import angular_error_numpy
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm

    torch.manual_seed(7)
    state = FeatRotationSymm(backbone_depth=50, num_iter=3).state_dict()
    batch = {k: v.to(devices[0]) for k, v in training_batch(seed=93).items()}
    out, launches = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def discard(run):
        for k in ("model", "step", "buffers"):
            run.pop(k, None)
        torch.cuda.empty_cache()

    # f32 under (1, 2) and (1, 4) against the unsharded f32 update and a float64 step
    a = mesh_update(fusion, batchnorm, state, batch, torch.float32, devices, None)
    add(a["counts"])
    l64, g64 = reference_step_f64(state, batch, seed=91)
    for sp in (2, 4):
        b = mesh_update(fusion, batchnorm, state, batch, torch.float32, devices, (1, sp))
        add(b["counts"])
        if b["counts"] != PER_SPATIAL_UPDATE[sp]:
            raise RuntimeError(f"spatial {sp} f32 update launched {b['counts']}, predicted {PER_SPATIAL_UPDATE[sp]}")
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
        worst, ill = hold_f32_grads(f"spatial{sp}_f32", b["grads"], a["grads"], g64)
        worst_buf = 0.0
        for n, v in a["buffers"].items():
            if n.endswith("num_batches_tracked"):
                if int(v) != int(b["buffers"][n]):
                    raise RuntimeError(f"{n}: num_batches_tracked {int(b['buffers'][n])} on strips, {int(v)} without")
                continue
            torch.testing.assert_close(b["buffers"][n], v, atol=1e-4, rtol=0,
                                       msg=lambda m: f"spatial {sp} buffer {n}: {m}")
            worst_buf = max(worst_buf, (b["buffers"][n] - v).abs().max().item())
        out[f"spatial{sp}_f32"] = {"loss": b["loss"], "loss_unsharded": a["loss"], "loss_f64": l64,
                                   "max_grad_diff": worst, "ill_conditioned": ill, "max_buffer_diff": worst_buf}
        log(f"spatial {sp} f32 update: loss {b['loss']:.8f} vs {a['loss']:.8f} (f64 {l64:.8f}); gradients max "
            f"|diff| {worst:.3e}, beyond f32's reach: {ill}; BN buffers max |diff| {worst_buf:.3e}")
        del b
        torch.cuda.empty_cache()
    del g64
    discard(a)

    base = mesh_update(fusion, batchnorm, state, batch, torch.bfloat16, devices, None)
    add(base["counts"])
    if base["counts"] != {**PER_STEP, "bn_stats_finish": 0, "bn_bwd_finish": 0}:
        raise RuntimeError(f"unsharded update launched {base['counts']}")
    base_ms = time_updates(base, batch)
    discard(base)
    base_far = float(angular_error_numpy(base["pred"], a["pred"]).mean())
    base_gap = grad_gap(base["grads"], a["grads"])
    strip_shapes = []
    for sp in (2, 4):
        run = mesh_update(fusion, batchnorm, state, batch, torch.bfloat16, devices, (1, sp),
                          shapes=strip_shapes if sp == 2 else None)
        add(run["counts"])
        if run["counts"] != PER_SPATIAL_UPDATE[sp] or fusion.rotate_concat_matmul_relu.launches_by_variant["wgmma"] != 6:
            raise RuntimeError(f"spatial {sp} update launched {run['counts']}, predicted {PER_SPATIAL_UPDATE[sp]}")
        rel = abs(run["loss"] - base["loss"]) / abs(base["loss"])
        delta = float(angular_error_numpy(run["pred"], base["pred"]).mean())
        far = float(angular_error_numpy(run["pred"], a["pred"]).mean())
        gap = grad_gap(run["grads"], a["grads"])
        # phase 7b's bars; where the train forward's bf16 pred_gaze moves past
        # 0.1 deg (other conv heights, other cuDNN kernels, amplified by the
        # random-init R50), the strips' bf16 pred_gaze no farther from the f32
        # update's than 1.5x the unsharded bf16's. The gradients are held in
        # f32 above: at random init the whole bf16 gradient lies about its own
        # norm away from the f32 one, too far for a bar to see a fault
        if not (rel <= 1e-2 and (delta <= 0.1 or far <= 1.5 * base_far)):
            raise RuntimeError(f"spatial {sp} bf16 update deviates: loss rel {rel}, pred_gaze {delta} deg; from the "
                               f"f32 update {far} deg (unsharded bf16 {base_far})")
        ms = time_updates(run, batch)
        out[f"spatial{sp}_bf16"] = {"loss_rel": rel, "delta_deg": delta, "f32_delta_deg": far,
                                    "unsharded_f32_delta_deg": base_far, "grad_gap_f32": gap,
                                    "unsharded_grad_gap_f32": base_gap, "launches": run["counts"],
                                    "update_ms": ms, "unsharded_update_ms": base_ms}
        log(f"spatial {sp} bf16 update: loss {run['loss']:.6f} vs {base['loss']:.6f} (rel {rel:.2e}), pred_gaze "
            f"delta {delta:.3e} deg; from the f32 update: pred_gaze {far:.3e} deg (unsharded bf16 {base_far:.3e}), "
            f"gradient {gap:.3e} (unsharded bf16 {base_gap:.3e}); launches {run['counts']}; "
            f"{ms:.1f} ms per update vs {base_ms:.1f} unsharded")
        del run
        torch.cuda.empty_cache()
    del a, base

    # the BN kernels against float64 at every distinct strip shape of the (1, 2) update
    cases = sorted({(rows, c, relu, res) for (rows, c), relu, res in strip_shapes})
    out["strip_bn_shapes"] = len(cases)
    out["strip_bn_max_abs_err_bf16"] = check_bn_kernels(
        batchnorm, [(f"(1, 2) strip", rows, c, relu, res) for rows, c, relu, res in cases])
    return {"numbers": out, "launches": launches}


def run_spatial_cli(fusion, batchnorm, devices: list) -> dict:
    """Phase 13c: --spatial_partition 2 on a machine with one card is
    refused in JAX's words before any data is read. Where this process sees
    two cards or more, the command line's build_experiment with
    --spatial_partition 2 over two of them (phase 9's packs, batches of 50)
    and two updates through its Trainer's loader and step: finite losses,
    the predicted launches, each card's peak memory."""
    from rot_mvgaze_tpu_torch.cli import main as cli
    from rot_mvgaze_tpu_torch.data import device_prefetch

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--exp_name", "xgaze2mpiinv_known", "--data_path", os.path.join(tmp, "absent.yaml"),
                "-out", os.path.join(tmp, "logs"), "--spatial_partition", "2"]
        if torch.cuda.device_count() < 2:
            try:
                cli.main(argv)
            except SystemExit as e:
                if "needs the mesh path" not in str(e.code):
                    raise RuntimeError(f"--spatial_partition 2 on one card exited with {e.code!r}")
                out["refused"] = str(e.code)
            else:
                raise RuntimeError("--spatial_partition 2 on one card was not refused")
            log(f"--spatial_partition 2 with one card: refused ({out['refused']})")
            return {"numbers": out, "launches": {}}
        paths = write_cli_corpus(tmp)
        config = cli.get_parser().parse_args([
            "--exp_name", "xgaze2mpiinv_known", "--data_path", paths["data_path"], "-out", os.path.join(tmp, "logs"),
            "--spatial_partition", "2", "--device", f"{devices[0]},{devices[1]}", "--epochs", "1"])
        trainer = cli.build_experiment(config)
        for d in devices[:2]:
            torch.cuda.reset_peak_memory_stats(d)
        losses, counts = [], []
        for i, batch in zip(range(2), device_prefetch(iter(trainer.train_loader), trainer.device)):
            reset_mesh_counts(fusion, batchnorm)
            losses.append(float(trainer._train_step(batch, trainer.generator, step=i)["loss_gaze"]))
            counts.append(mesh_counts(fusion, batchnorm))
        want = PER_SPATIAL_UPDATE[2]  # a batch of 50 pairs splits as 64 does at 224x224
        if not all(np.isfinite(losses)) or any(c != want for c in counts):
            raise RuntimeError(f"--spatial_partition 2 updates: losses {losses}, launches {counts}")
        out.update(losses=losses, launches=counts[0],
                   per_card_peak_mib={str(d): torch.cuda.max_memory_allocated(d) / 2**20 for d in devices[:2]})
        log(f"--spatial_partition 2 over {devices[:2]}: losses {losses}, launches {counts[0]}, peak memory "
            f"{out['per_card_peak_mib']}")
    return {"numbers": out, "launches": {k: 2 * v for k, v in counts[0].items()}}


# launches per update of 64 V=3 frames (192 images) on a (data d) mesh (the
# counts PERF.md §6 predicted): each of the 53 BN calls of the fused B·V
# batch on d blocks of whole samples' views (96 or 48 images), one finish
# kernel each; the V-view fusers are F.linear
MV_MESH_DATA = (2, 4)
PER_MV_MESH_UPDATE = {d: {**{k: 53 * d for k in BN_KERNELS}, "fusion": 0, "conv3x3_bn_stats": 0,
                          "bn_stats_finish": 53, "bn_bwd_finish": 53} for d in MV_MESH_DATA}
MV_EVAL_SAMPLES = 67  # a ragged evaluation: padded by samples to 68 on (data 2) and (data 4)


def run_multiview_mesh(fusion, batchnorm, ckpt: str, devices: list) -> dict:
    """Phase 13d: the V-view model (V=3, R50 x 3, 224x224, 64 frames) on
    (data 2) and (data 4) meshes of ``devices`` from phase 13's checkpoint
    (a stereo state dict loads at any V) and one generator seed. One f32
    update on each against the unsharded one: loss rtol 1e-4, every
    gradient atol 5e-3 / rtol 5e-2 (where a gradient misses that bar, phase
    7b's rule against a float64 step, recorded), BN buffers within 1e-4;
    one bf16 update on each against the unsharded bf16 update at phase 7b's
    bars (loss 1%, pred_gaze 0.1 deg; past 0.1 deg, phase 13b's rule: no
    farther from the f32 update than 1.5x the unsharded bf16 update), with
    its host ms beside the unsharded one; the launches PER_MV_MESH_UPDATE
    predicts; the BN kernels against float64 at every distinct block shape
    of the (data 2) and (data 4) updates (96 and 48 images per block); the eval step on MV_EVAL_SAMPLES frames on each
    mesh against the unsharded one at phase 4's f32 bar, no kernel
    launched."""
    from rot_mvgaze_tpu_torch.geometry import angular_error_numpy
    from rot_mvgaze_tpu_torch.parallel import make_mesh
    from rot_mvgaze_tpu_torch.train import make_multiview_eval_step

    t0 = time.perf_counter()
    flags = FAMILY["v3"][0]
    state = torch.load(ckpt)
    batch = {k: v.to(devices[0]) for k, v in training_batch(seed=95, views=3).items()}
    out, launches = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def update(dtype, data, shapes=None):
        run = mesh_update(fusion, batchnorm, state, batch, dtype, devices, None if data is None else (data, 1),
                          flags=flags, seed=96, shapes=shapes)
        add(run["counts"])
        want = ({**family_per_step("v3"), "bn_stats_finish": 0, "bn_bwd_finish": 0} if data is None
                else PER_MV_MESH_UPDATE[data])
        if run["counts"] != want:
            raise RuntimeError(f"V=3 {str(dtype)[6:]} update on (data {data}) launched {run['counts']}, "
                               f"predicted {want}")
        return run

    def discard(run):
        for k in ("model", "step", "buffers"):
            run.pop(k, None)
        torch.cuda.empty_cache()

    a = update(torch.float32, None)
    f64 = {}
    for d in MV_MESH_DATA:
        b = update(torch.float32, d)
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
        missed = [n for n, g in a["grads"].items()
                  if not torch.allclose(b["grads"][n], g, atol=5e-3, rtol=5e-2)]
        worst = max((b["grads"][n] - g).abs().max().item() for n, g in a["grads"].items())
        ill = {}
        if missed:  # phase 7b's rule where float32 cannot reach the bar of a float64 step
            if not f64:
                f64["grads"] = reference_step_f64(state, batch, seed=96, flags=flags)[1]
            worst, ill = hold_f32_grads(f"v3_data{d}_f32", b["grads"], a["grads"], f64["grads"])
        worst_buf = 0.0
        for n, v in a["buffers"].items():
            if n.endswith("num_batches_tracked"):
                if int(v) != int(b["buffers"][n]):
                    raise RuntimeError(f"{n}: num_batches_tracked {int(b['buffers'][n])} on (data {d}), {int(v)}")
                continue
            torch.testing.assert_close(b["buffers"][n], v, atol=1e-4, rtol=0,
                                       msg=lambda m: f"V=3 (data {d}) buffer {n}: {m}")
            worst_buf = max(worst_buf, (b["buffers"][n] - v).abs().max().item())
        out[f"data{d}_f32"] = {"loss": b["loss"], "loss_unsharded": a["loss"], "max_grad_diff": worst,
                               "missed_strict_bar": missed, "ill_conditioned": ill, "max_buffer_diff": worst_buf,
                               "launches": b["counts"]}
        log(f"V=3 (data {d}) f32 update: loss {b['loss']:.8f} vs {a['loss']:.8f}; gradients max |diff| "
            f"{worst:.3e}, past atol 5e-3 / rtol 5e-2: {missed} (against float64: {ill}); BN buffers max |diff| "
            f"{worst_buf:.3e}; launches {b['counts']}")
        del b
        torch.cuda.empty_cache()
    discard(a)
    f64.clear()

    base = update(torch.bfloat16, None)
    base_ms = time_updates(base, batch)
    discard(base)
    base_far = float(angular_error_numpy(base["pred"], a["pred"]).mean())
    block_shapes = {d: [] for d in MV_MESH_DATA}
    for d in MV_MESH_DATA:
        run = update(torch.bfloat16, d, shapes=block_shapes[d])
        rel = abs(run["loss"] - base["loss"]) / abs(base["loss"])
        delta = float(angular_error_numpy(run["pred"], base["pred"]).mean())
        far = float(angular_error_numpy(run["pred"], a["pred"]).mean())
        if not (rel <= 1e-2 and (delta <= 0.1 or far <= 1.5 * base_far)):
            raise RuntimeError(f"V=3 (data {d}) bf16 update deviates: loss rel {rel}, pred_gaze {delta} deg; from "
                               f"the f32 update {far} deg (unsharded bf16 {base_far})")
        ms = time_updates(run, batch)
        out[f"data{d}_bf16"] = {"loss_rel": rel, "delta_deg": delta, "f32_delta_deg": far,
                                "unsharded_f32_delta_deg": base_far, "launches": run["counts"], "update_ms": ms,
                                "unsharded_update_ms": base_ms}
        log(f"V=3 (data {d}) bf16 update: loss {run['loss']:.6f} vs {base['loss']:.6f} (rel {rel:.2e}), pred_gaze "
            f"delta {delta:.3e} deg (from the f32 update {far:.3e}, unsharded bf16 {base_far:.3e}); launches "
            f"{run['counts']}; {ms:.1f} ms per update vs {base_ms:.1f} unsharded")
        discard(run)
    del a, base

    # the union over both meshes: 96-image blocks on (data 2), 48 on (data 4)
    cases = {}
    for d in MV_MESH_DATA:
        for (rows, c), relu, res in block_shapes[d]:
            cases.setdefault((rows, c, relu, res), d)
    out["block_bn_shapes"] = {f"data{d}": len({(r, c, u, s) for (r, c), u, s in block_shapes[d]})
                              for d in MV_MESH_DATA}
    out["block_bn_cases"] = len(cases)
    out["block_bn_max_abs_err_bf16"] = check_bn_kernels(
        batchnorm, [(f"V=3 (data {d}) block", rows, c, relu, res)
                    for (rows, c, relu, res), d in sorted(cases.items())])

    model = family_model(flags)
    model.load_state_dict(state, strict=True)
    model = model.to(device=devices[0], memory_format=torch.channels_last)
    frames = training_batch(seed=97, pairs=MV_EVAL_SAMPLES, views=3)
    ev = {k: frames[k].to(devices[0]) for k in ("imgs", "head_poses")}
    want = make_multiview_eval_step(model, 224)(ev)["pred_gaze"].cpu().numpy()
    for d in MV_MESH_DATA:
        mesh = make_mesh([devices[i % len(devices)] for i in range(d)])
        reset_mesh_counts(fusion, batchnorm)
        got = make_multiview_eval_step(model, 224, mesh=mesh)(ev)["pred_gaze"]
        torch.cuda.synchronize()
        counts = mesh_counts(fusion, batchnorm)
        if any(counts.values()) or got.shape != (MV_EVAL_SAMPLES, 2):
            raise RuntimeError(f"V=3 eval on (data {d}): {tuple(got.shape)}, launches {counts}")
        got = got.cpu().numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
        out[f"eval_data{d}_max_abs_diff"] = float(np.abs(got - want).max())
        log(f"V=3 eval of {MV_EVAL_SAMPLES} frames on (data {d}) (padded to {-(-MV_EVAL_SAMPLES // d) * d}): "
            f"max |diff| {out[f'eval_data{d}_max_abs_diff']:.3e} against one device (bar atol 2e-4 / rtol 1e-3)")
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"V=3 data meshes: {out['seconds']:.1f} s")
    return {"numbers": out, "launches": launches}


def run_mesh_phase(fusion, batchnorm) -> dict:
    """Phase 13: mesh serving (a), spatial training (b), the command line
    (c) and the V-view model on data meshes (d) at R50 x 3, full width,
    224x224, on a logical mesh of cuda:0, and where this process sees more
    cards, again over the real cards."""
    t_phase = time.perf_counter()
    numbers, launches, serving_launches = {}, {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "r50_seed0.pth.tar")
        make_checkpoint(ckpt)
        targets = [("logical", [torch.device("cuda", 0)])]
        if torch.cuda.device_count() > 1:
            targets.append(("cards", [torch.device("cuda", i) for i in range(torch.cuda.device_count())]))
        for name, devices in targets:
            t0 = time.perf_counter()
            served = run_mesh_serving(fusion, batchnorm, ckpt, devices)
            serving_launches += served["launches"]
            trained = run_spatial_training(fusion, batchnorm, devices)
            multiview = run_multiview_mesh(fusion, batchnorm, ckpt, devices)
            for part in (trained, multiview):
                for k, v in part["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            numbers[name] = {"serving": served["numbers"], "training": trained["numbers"],
                             "multiview": multiview["numbers"], "seconds": time.perf_counter() - t0}
            torch.cuda.empty_cache()
    cli = run_spatial_cli(fusion, batchnorm, [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    numbers["cli"] = cli["numbers"]
    for k, v in cli["launches"].items():
        launches[k] = launches.get(k, 0) + v
    numbers["seconds"] = time.perf_counter() - t_phase
    log(f"mesh phase: {numbers['seconds']:.1f} s")
    return {"numbers": numbers, "launches": launches, "serving_launches": serving_launches}


# ---------------------------------------------------------------------------
# phase 14: int8 serving under a mesh
# ---------------------------------------------------------------------------

INT8_MODES = {"dynamic": True, "static": "static"}
# int8 GEMMs per data replica and micro-batch at 224x224 (the counts PERF.md
# §6 predicted): one per conv on a whole map, one per strip for each conv
# that runs on strips; over 4 strips layer 4's 10 convs run on the gathered
# map (its 7 rows would split 2, 2, 2, 1)
INT8_GEMMS_PER_REPLICA = {1: R50_CONVS, 2: 2 * R50_CONVS, 4: 4 * (R50_CONVS - 10) + 10}


def int8_ranges(pred) -> np.ndarray:
    return np.array([float(c.act_amax) for _, c in pred._quant_convs])


def serve_int8_on_mesh(fusion, batchnorm, pred, req, data: int, sp: int) -> tuple:
    """One counted predict of ``req`` through an int8 mesh predictor:
    (pitchyaw, counts with the int8 GEMMs); the fuser must launch 6 times
    per data replica and micro-batch, of the variant its dtype takes, the
    int8 GEMM INT8_GEMMS_PER_REPLICA[sp] times per replica and micro-batch,
    and no train-mode BN or conv kernel."""
    mb_before = pred.micro_batches_run
    out, counts, by_variant, gemms = counted(fusion, batchnorm, lambda: pred.predict(*req))
    counts["int8_gemm"] = gemms
    micro_batches = pred.micro_batches_run - mb_before
    variant = "wgmma" if pred.model._lifter._lifter.blocks[0][0].weight.dtype == torch.bfloat16 else "generic"
    want = {"fusion": 6 * data * micro_batches, "int8_gemm": INT8_GEMMS_PER_REPLICA[sp] * data * micro_batches}
    if any(counts[k] != v for k, v in want.items()) or by_variant[variant] != want["fusion"]:
        raise RuntimeError(f"int8 mesh serving launched {counts} ({by_variant}) over {micro_batches} micro-batches "
                           f"x {data} replicas, expected {want}, the fuser's all {variant}")
    if any(counts[k] for k in BN_KERNELS) or counts["conv3x3_bn_stats"]:
        raise RuntimeError(f"int8 mesh serving launched train-mode BN or conv kernels: {counts}")
    if out.shape != (req[0].shape[0], 2) or not np.all(np.isfinite(out)):
        raise RuntimeError(f"int8 mesh serving returned {out.shape}, finite: {np.isfinite(out).all()}")
    return out, counts


def run_int8_mesh_phase(fusion, batchnorm) -> dict:
    """Phase 14: GazePredictor(mesh=, int8=True|"static") at R50 x 3, 224x224,
    micro-batch 64, on phase 13's logical meshes of cuda:0, bf16 and f32:
    100 pairs against the one-card int8 predictor on the same micro-batches
    (f32 at phase 4's bar, bf16 mean delta <= 0.1 deg), static ranges
    calibrated on the same 64 pairs against the one card's (f32 bit for
    bit, bf16's largest relative difference recorded), the launches per
    micro-batch, images/s and p50 of the bf16 int8 predictors beside one
    card's int8 and the same mesh's bf16; then serve.py --dp
    --spatial_partition 2 --int8_static over HTTP."""
    from rot_mvgaze_tpu_torch import serve
    from rot_mvgaze_tpu_torch.geometry import angular_error_numpy
    from rot_mvgaze_tpu_torch.parallel import make_mesh
    from rot_mvgaze_tpu_torch.serving import BatchingPredictor, GazePredictor

    t_phase = time.perf_counter()
    kw = dict(backbone_depth=50, num_iter=3, image_size=224)
    card = torch.device("cuda", 0)
    req = requests([100], seed=141)[0]
    calib = requests([PAIRS], seed=142)[0]
    timed = requests([PAIRS], seed=143)[0]
    out, refs = {}, {}
    launches = {"fusion": 0, "int8_gemm": 0}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "r50_seed0.pth.tar")
        make_checkpoint(ckpt)

        def one_card(dtype, mode):
            """The one-card int8 predictor's pitchyaw of ``req`` and static
            ranges (calibrated on ``calib``) at the mesh's micro-batch (the
            dynamic scale is the micro-batch's)."""
            key = (dtype, mode)
            if key not in refs:
                pred = GazePredictor(ckpt, micro_batch=PAIRS, dtype=dtype, int8=INT8_MODES[mode], device=card, **kw)
                if mode == "static":
                    pred.calibrate(*calib)
                refs[key] = {"pred": pred.predict(*req), "ranges": int8_ranges(pred) if mode == "static" else None}
                if dtype == torch.bfloat16:
                    out[f"one_card_int8_{mode}"] = time_serving(pred, timed, n_iter=5)
                del pred
            return refs[key]

        for data, sp in MESH_LAYOUTS:
            name = f"data{data}_spatial{sp}"
            mesh = make_mesh([card] * (data * sp), spatial=sp)
            pred = GazePredictor(ckpt, micro_batch=PAIRS, dtype=torch.bfloat16, mesh=mesh, **kw)
            rec = {"bf16": time_serving(pred, timed, n_iter=5)}
            del pred
            for mode, int8 in INT8_MODES.items():
                for dtype in (torch.bfloat16, torch.float32):
                    tag = f"{mode}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
                    pred = GazePredictor(ckpt, micro_batch=PAIRS, dtype=dtype, int8=int8, mesh=mesh, **kw)
                    ref = one_card(dtype, mode)
                    if mode == "static":
                        pred.calibrate(*calib)
                        rel = float(np.max(np.abs(int8_ranges(pred) - ref["ranges"]) / ref["ranges"]))
                        rec[f"{tag}_ranges_max_rel_diff"] = rel
                        if not (rel == 0.0 if dtype == torch.float32 else rel <= 0.05):
                            raise RuntimeError(f"{name} {tag}: static ranges {rel} (relative) from one card's")
                    got, counts = serve_int8_on_mesh(fusion, batchnorm, pred, req, data, sp)
                    for k in launches:
                        launches[k] += counts[k]
                    rec[f"{tag}_launches"] = {k: counts[k] for k in ("fusion", "int8_gemm")}
                    if dtype == torch.float32:
                        rec[f"{tag}_max_abs_diff"] = float(np.abs(got - ref["pred"]).max())
                        np.testing.assert_allclose(got, ref["pred"], atol=2e-4, rtol=1e-3)
                    else:
                        delta = float(angular_error_numpy(got, ref["pred"]).mean())
                        rec[f"{tag}_delta_deg"] = delta
                        if not delta <= 0.1:
                            raise RuntimeError(f"{name} {tag}: {delta} deg from the one-card int8 predictor")
                        rec[f"{tag}_serve"] = time_serving(pred, timed, n_iter=5)
                    del pred
            out[name] = rec
            log(f"int8 mesh serving {name}: " + ", ".join(
                f"{mode}: bf16 delta {rec[f'{mode}_bf16_delta_deg']:.3e} deg, f32 max |diff| "
                f"{rec[f'{mode}_f32_max_abs_diff']:.3e}, {rec[f'{mode}_bf16_serve']['serve_imgs_per_s']:.1f} images/s "
                f"p50 {rec[f'{mode}_bf16_serve']['serve_p50_ms']:.2f} ms, launches {rec[f'{mode}_bf16_launches']}"
                for mode in INT8_MODES)
                + f"; static ranges bf16 {rec['static_bf16_ranges_max_rel_diff']:.3e}, f32 "
                f"{rec['static_f32_ranges_max_rel_diff']:.3e} (relative); this mesh's bf16 "
                f"{rec['bf16']['serve_imgs_per_s']:.1f} images/s, one card's int8 "
                f"{out['one_card_int8_dynamic']['serve_imgs_per_s']:.1f} / "
                f"{out['one_card_int8_static']['serve_imgs_per_s']:.1f}")
            torch.cuda.empty_cache()

        # serve.py --dp --spatial_partition 2 --int8_static over HTTP on
        # 127.0.0.1: the first request calibrates (and saves the ranges),
        # the later replies equal direct predicts
        calibration = os.path.join(tmp, "ranges.msgpack")
        listed = ",".join(["cuda:0"] * 4)
        args = serve.get_parser().parse_args(["--ckpt", ckpt, "--dp", "--spatial_partition", "2", "--int8_static",
                                              "--calibration", calibration, "--device", listed,
                                              "--host", "127.0.0.1", "--port", "0"])
        if serve.refused(args) or not serve.serves_on_a_mesh(args):
            raise RuntimeError(f"serve.py refused {listed} --int8_static: {serve.refused(args)}")
        pred = serve.build_predictor(args)
        pred.warmup()
        batching = BatchingPredictor(pred, max_delay_ms=5.0)
        stats = {"requests": 0, "samples": 0, "time": 0.0}
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.build_handler(batching, stats))
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        reqs = requests([PAIRS, 1, 17, 100], seed=144)
        try:
            post_predict(httpd.server_address[1], pred.request_fields, reqs[0])  # calibrates
            if not (pred._calibrated and os.path.exists(calibration)):
                raise RuntimeError("serve.py --int8_static: the first request calibrated nothing")
            replies, counts = serve_int8_on_mesh_http(fusion, batchnorm, pred, httpd, reqs[1:])
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join(timeout=30)
            batching.close()
        for r, reply in zip(reqs[1:], replies):
            np.testing.assert_allclose(reply, pred.predict(*r), atol=1e-3, rtol=0)
        for k in launches:
            launches[k] += counts[k]
        out["serve_py_http"] = {"devices": listed, "requests": stats["requests"], **counts}
        log(f"serve.py --dp --spatial_partition 2 --int8_static --device {listed}: {stats['requests']} HTTP "
            f"requests, the first calibrating; then {counts}; replies equal direct predicts")
        del pred
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"int8 mesh phase: {out['seconds']:.1f} s")
    return {"numbers": out, "launches": launches}


def serve_int8_on_mesh_http(fusion, batchnorm, pred, httpd, reqs) -> tuple:
    """``reqs`` posted in turn to ``httpd`` (in front of ``pred``, a frozen
    static-int8 predictor on (data 2, spatial 2)): the replies and the
    counts, 6 fuser launches and 2 x 106 int8 GEMMs per micro-batch."""
    from rot_mvgaze_tpu_torch.ops import quant

    dp, sp = len(pred.mesh.grid), len(pred.mesh.grid[0])
    mb_before = pred.micro_batches_run
    reset_mesh_counts(fusion, batchnorm)
    quant.int8_matmul.launches = 0
    replies = [post_predict(httpd.server_address[1], pred.request_fields, r) for r in reqs]
    torch.cuda.synchronize()
    micro_batches = pred.micro_batches_run - mb_before
    counts = {"micro_batches": micro_batches, "fusion": fusion.rotate_concat_matmul_relu.launches,
              "int8_gemm": quant.int8_matmul.launches}
    want = {"fusion": 6 * dp * micro_batches, "int8_gemm": INT8_GEMMS_PER_REPLICA[sp] * dp * micro_batches}
    if any(counts[k] != v for k, v in want.items()) or any(getattr(batchnorm, k).launches for k in BN_KERNELS):
        raise RuntimeError(f"serve.py int8 over the mesh launched {counts}, expected {want}")
    return replies, counts


# ---------------------------------------------------------------------------
# phase 15: the protocol commands
# ---------------------------------------------------------------------------

PARITY_MODEL = dict(backbone_depth=50, num_iter=3, share_weights=False, encode_rotmat=False,
                    share_feature=False, ignore_rotmat=False)


def parity_batches(rows: int) -> int:
    return -(-rows // CLI_BATCH)


def run_parity_table(fusion, batchnorm, stereo_ckpt, tmp) -> dict:
    """Phase 15a: reference_parity's four-protocol table at R50 x 3, 224x224,
    batch 50, float32, from phase 8's epoch-1 checkpoint saved as a reference
    .pth.tar, over the rehearsal's two synthetic corpora at 224x224
    (``reference_parity.rehearsal_corpora``: packs, 2 subjects x 3 frames x
    18 cameras each), through the packed route and the C++ pool. Each protocol's launches: 6 of the fuser's
    generic variant per eval batch (PERF.md's prediction), nothing else;
    each protocol's error within 1e-3 deg of the same table through the
    plain versions on the card."""
    from rot_mvgaze_tpu_torch import reference_parity as rp
    from rot_mvgaze_tpu_torch.compat import checkpoint_state_dict, read_checkpoint

    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "epoch_1.pth.tar")
    torch.save(checkpoint_state_dict(read_checkpoint(stereo_ckpt)), ckpt)
    roots, subjects = rp.rehearsal_corpora(tmp, 224, seed=300, learnable=True)
    t_written = time.perf_counter()
    table, launches, generic = {}, {}, 0
    for p in rp.PROTOCOLS:
        _, test_loader, route = rp.protocol_loaders(p, roots, subjects, CLI_BATCH, 0)
        rows = len(test_loader.dataset)
        if route != "packed" or test_loader.dataset.pool is None:
            raise RuntimeError(f"reference_parity {p}: the {route} route served, not the packs' C++ pool")

        def ours(dir_name, p=p):
            return rp.run_our_eval(p, ckpt, roots, subjects, PARITY_MODEL, 224, CLI_BATCH, 0,
                                   os.path.join(tmp, dir_name, p), device="cuda")

        err, counts, by_variant, _ = counted(fusion, batchnorm, lambda: ours("kernels"))
        gen = by_variant["generic"]
        want = {**dict.fromkeys(PER_STEP, 0), "fusion": 6 * parity_batches(rows)}
        if counts != want or gen != want["fusion"]:
            raise RuntimeError(f"reference_parity {p}: {rows} test pairs launched {counts} ({gen} generic), "
                               f"expected {want}")
        with plain_kernels():
            plain = ours("plain")
        delta = abs(err - plain)
        log(f"reference_parity {p}: {err:.6f} deg on the kernels, {plain:.6f} through the plain versions "
            f"(delta {delta:.3e}, bar 1e-3) over {rows} pairs; {gen} generic fuser launches")
        if not (math.isfinite(err) and delta <= 1e-3):
            raise RuntimeError(f"reference_parity {p}: {err} deg against {plain} through the plain versions")
        table[p] = {"ours_deg": err, "plain_deg": plain, "delta_deg": delta, "test_pairs": rows,
                    "eval_batches": parity_batches(rows), "fusion_generic_launches": gen}
        generic += gen
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    return {"table": table, "launches": launches, "generic": generic,
            "corpus_seconds": t_written - t0, "seconds": time.perf_counter() - t0}


def run_pairing_experiment(fusion, batchnorm, tmp) -> dict:
    """Phase 15b: pairing_sensitivity at its defaults (R18 x 3, 64x64, batch
    18, 2 subjects x 6 frames) cut to --epochs 1 --seeds 2: training (12
    float32 updates: 40 launches of each BN kernel and 6 of the generic
    fuser per update) and 3 evaluations (2 seeds and the reference pairing,
    12 batches each, 6 generic fuser launches per batch); then the same
    frozen weights through the plain versions, each error within 1e-3 deg."""
    from rot_mvgaze_tpu_torch import pairing_sensitivity as ps

    t0 = time.perf_counter()
    args = ps.get_parser().parse_args(["--epochs", "1", "--seeds", "2", "--device", "cuda",
                                       "--out", os.path.join(tmp, "pairing.json")])
    (record, model, subjects), counts, by_variant, _ = counted(fusion, batchnorm, lambda: ps.run(args, tmp))
    gen = by_variant["generic"]
    updates = record["setup"]["n_samples"] // args.batch_size
    evals = 3 * -(-record["setup"]["n_samples"] // args.batch_size)
    want = {**{k: 40 * updates for k in BN_KERNELS}, "fusion": 6 * updates + 6 * evals, "conv3x3_bn_stats": 0}
    if counts != want or gen != want["fusion"]:
        raise RuntimeError(f"pairing_sensitivity launched {counts} ({gen} generic), expected {want}")
    with plain_kernels():
        seeds, ref = ps.pairing_errors(model, tmp, subjects, range(args.seeds), args.image_size, args.batch_size)
    got = [*record["per_seed_mean_error_deg"].values(), record["reference_pairing_mean_error_deg"]]
    delta = max(abs(a - b) for a, b in zip(got, [*seeds.values(), ref]))
    log(f"pairing_sensitivity (--epochs 1 --seeds 2): spread {record['spread_deg']:.4f} deg, reference "
        f"pairing {record['reference_pairing_mean_error_deg']:.4f}; through the plain versions within "
        f"{delta:.3e} deg (bar 1e-3)")
    if not delta <= 1e-3:
        raise RuntimeError(f"pairing_sensitivity: kernels {got} against plain {seeds} {ref}")
    return {"record": record, "plain_max_delta_deg": delta, "launches": counts, "generic": gen,
            "seconds": time.perf_counter() - t0}


def run_ema_probe(fusion, batchnorm, tmp) -> dict:
    """Phase 15c: probe_ema_benefit at its defaults (R18 x 1, 32x32, batch
    24, 288 training pairs, 72 held out) cut to --epochs 2: 24 float32
    updates (40 launches of each BN kernel and 2 of the generic fuser per
    update), and after each epoch the raw and the averaged weights scored (3
    batches each, 2 generic fuser launches per batch); then both through the
    plain versions, each within 1e-3 deg of the last epoch's scores."""
    from rot_mvgaze_tpu_torch import probe_ema_benefit as pe
    from rot_mvgaze_tpu_torch.evaluate import evaluate_gaze

    t0 = time.perf_counter()
    ap = pe.get_parser()
    args = ap.parse_args(["--epochs", "2", "--device", "cuda"])
    pe.check_args(ap, args)
    run, counts, by_variant, _ = counted(fusion, batchnorm, lambda: pe.run(args, tmp))
    gen = by_variant["generic"]
    record, state = run["record"], run["state"]
    updates = args.epochs * (record["train_rows"] // args.batch)
    evals = args.epochs * 2 * -(-record["eval_rows"] // args.batch)
    want = {**{k: 40 * updates for k in BN_KERNELS}, "fusion": 2 * updates + 2 * evals, "conv3x3_bn_stats": 0}
    if counts != want or gen != want["fusion"]:
        raise RuntimeError(f"probe_ema_benefit launched {counts} ({gen} generic), expected {want}")
    last = state["history"][-1]
    with plain_kernels():
        raw = evaluate_gaze(state["model"], state["eval_loader"], image_size=args.image_size)
        avg = evaluate_gaze(state["model"], state["eval_loader"], image_size=args.image_size, params=state["ema"])
    delta = max(abs(raw - last["raw_deg"]), abs(avg - last["ema_deg"]))
    log(f"probe_ema_benefit (--epochs 2): raw {last['raw_deg']:.4f} deg, EMA {last['ema_deg']:.4f}; through "
        f"the plain versions within {delta:.3e} deg (bar 1e-3)")
    if not delta <= 1e-3:
        raise RuntimeError(f"probe_ema_benefit: kernels {last} against plain raw {raw}, EMA {avg}")
    return {"record": record, "plain_max_delta_deg": delta, "launches": counts, "generic": gen,
            "seconds": time.perf_counter() - t0}


def run_protocol_phase(fusion, batchnorm, stereo_ckpt) -> dict:
    """Phase 15: the three protocol commands on the card. Returns the main
    path's launch counts (the table's, the two experiments' training and
    evaluation) and the numbers."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        work = {}
        for name in ("parity", "pairing", "ema"):
            work[name] = os.path.join(tmp, name)
            os.makedirs(work[name])
        table = run_parity_table(fusion, batchnorm, stereo_ckpt, work["parity"])
        torch.cuda.empty_cache()
        pairing = run_pairing_experiment(fusion, batchnorm, work["pairing"])
        torch.cuda.empty_cache()
        ema = run_ema_probe(fusion, batchnorm, work["ema"])
        torch.cuda.empty_cache()
    launches = {k: table["launches"].get(k, 0) + pairing["launches"][k] + ema["launches"][k]
                for k in pairing["launches"]}
    out = {
        "table": table["table"], "reference_parity_seconds": table["seconds"],
        "corpus_seconds": table["corpus_seconds"],
        "pairing_sensitivity": {k: pairing[k] for k in ("record", "plain_max_delta_deg", "launches", "seconds")},
        "probe_ema_benefit": {k: ema[k] for k in ("record", "plain_max_delta_deg", "launches", "seconds")},
        "launches": launches, "fusion_generic_launches": table["generic"] + pairing["generic"] + ema["generic"],
        "seconds": time.perf_counter() - t_phase,
    }
    log(f"protocol commands phase: table {table['seconds']:.1f} s, pairing {pairing['seconds']:.1f} s, EMA probe "
        f"{ema['seconds']:.1f} s; {out['seconds']:.1f} s in all")
    return {"numbers": out, "launches": launches, "generic": out["fusion_generic_launches"]}


# ---------------------------------------------------------------------------
# the benchmark commands (phase 16)
# ---------------------------------------------------------------------------

BENCH_EVAL_MODES = {"bf16": "0", "int8": "1", "int8_static": "static"}
SWEEP_STEPS = 3  # phase 16's timed calls per variant of bench_sweep
PROBE_STEPS = 5  # and per probe of bench_probes
BB_TRAIN_IMAGES = 256  # bench_probes' batch: both views of 128 pairs in one backbone call
EVAL_STEPS, EVAL_REQUESTS = 5, 10  # bench_eval's and probe_int8_static's timed calls, bench_eval's requests
INT8_ITERS, INT8_REPS = 10, 2  # probe_int8's chained iterations per call and timed calls
LOADER_THREADS = [8]  # bench_loader_scaling's one point: a thread per core of the card's host
R50_CONVS = 53  # int8 GEMMs per forward of the int8 backbone (one per conv)


def per_step(n: int, per: dict) -> dict:
    return {k: n * v for k, v in per.items()}


def run_bench_command(fusion, batchnorm) -> dict:
    """Phase 16a, the main path: ``bench.run`` at its defaults (R50 x 3,
    224x224, 128 pairs, bf16; 3 warm-up and 20 timed steps), the counts set
    to 0 just before and read just after: 106 launches of each BN kernel and
    6 of the fuser's wgmma variant per step. Its host-fenced images/s within
    5% of the CUDA events' around the same 20 steps."""
    from rot_mvgaze_tpu_torch import bench

    out, counts, by_variant, _ = counted(fusion, batchnorm, lambda: bench.run(bench.read_settings({}), "cuda"))
    rec, n = out["record"], out["steps_run"]
    want = per_step(n, PER_STEP)
    if counts != want or by_variant["wgmma"] != want["fusion"]:
        raise RuntimeError(f"bench launched {counts} ({by_variant}) over {n} steps, expected {want}, all wgmma")
    rel = abs(rec["value"] - rec["value_by_cuda_events"]) / rec["value_by_cuda_events"]
    log(f"bench: {rec['value']:.1f} images/s (CUDA events {rec['value_by_cuda_events']:.1f}, rel {rel:.3e}, "
        f"bar 0.05), {rec['flops_per_step'] / 1e12:.3f} TFLOP per step, mfu {rec['mfu']:.4f}; {n} steps of "
        f"{PER_STEP}")
    if not rel <= 0.05:
        raise RuntimeError(f"bench's host clock and CUDA events disagree: {rec}")
    return {"record": rec, "launches": counts, "by_variant": by_variant, "steps_run": n,
            "host_vs_events_rel": rel}


# bench at V=3 over a logical (data 2) mesh of cuda:0: 32 frames per replica,
# 192 images per step; per step the launches of phase 13d's (data 2) update
MV_BENCH_ENV = {"BENCH_NUM_VIEWS": "3", "BENCH_BATCH": "32"}
MV_BENCH_DEVICES = "cuda:0,cuda:0"


def run_multiview_bench(fusion, batchnorm) -> dict:
    """Phase 16a's V-view part: ``bench.run`` with MV_BENCH_ENV on
    MV_BENCH_DEVICES, the counts set to 0 just before and read just after:
    per step PER_MV_MESH_UPDATE[2] (106 launches of each BN kernel on the
    two replicas' blocks, 53 of each finish kernel, no fuser); its host
    images/s within 5% of the CUDA events'; the record's n_chips 2."""
    from rot_mvgaze_tpu_torch import bench

    reset_mesh_counts(fusion, batchnorm)
    out = bench.run(bench.read_settings(MV_BENCH_ENV), MV_BENCH_DEVICES)
    torch.cuda.synchronize()
    counts = mesh_counts(fusion, batchnorm)
    rec, n = out["record"], out["steps_run"]
    want = per_step(n, PER_MV_MESH_UPDATE[2])
    if counts != want or rec.get("n_chips") != 2:
        raise RuntimeError(f"bench at V=3 on {MV_BENCH_DEVICES} launched {counts} over {n} steps, expected {want}; "
                           f"record {rec}")
    rel = abs(rec["value"] - rec["value_by_cuda_events"]) / rec["value_by_cuda_events"]
    log(f"bench V=3 on {MV_BENCH_DEVICES}: {rec['value']:.1f} images/s per replica, {rec['total_imgs_per_sec']:.1f} "
        f"in all (CUDA events {rec['value_by_cuda_events']:.1f}, rel {rel:.3e}, bar 0.05), "
        f"{rec['flops_per_step'] / 1e12:.3f} TFLOP per step; {n} steps of {PER_MV_MESH_UPDATE[2]}")
    if not rel <= 0.05:
        raise RuntimeError(f"bench V=3: the host's clock and CUDA events disagree: {rec}")
    return {"record": rec, "launches": counts, "steps_run": n, "host_vs_events_rel": rel}


def run_eval_commands(fusion, batchnorm) -> dict:
    """Phase 16b: bench_eval in bf16, BENCH_INT8=1 and BENCH_INT8=static, at
    EVAL_STEPS timed calls and EVAL_REQUESTS requests: per forward 6 wgmma
    fuser launches, 53 int8 GEMMs under int8, no train-mode BN kernel."""
    from rot_mvgaze_tpu_torch import bench_eval

    records, fused = {}, 0
    for name, raw in BENCH_EVAL_MODES.items():
        settings = bench_eval.read_settings({"BENCH_INT8": raw})
        out, counts, by_variant, gemms = counted(
            fusion, batchnorm, lambda: bench_eval.run(settings, "cuda", n_steps=EVAL_STEPS, n_latency=EVAL_REQUESTS))
        n = out["forwards"]
        want = {**dict.fromkeys(PER_STEP, 0), "fusion": 6 * n}
        want_gemms = R50_CONVS * n if settings["int8"] else 0
        if counts != want or by_variant["wgmma"] != want["fusion"] or gemms != want_gemms:
            raise RuntimeError(f"bench_eval {name}: launches {counts} ({by_variant}), int8 GEMM {gemms} over {n} "
                               f"forwards; expected {want}, all wgmma, int8 GEMM {want_gemms}")
        records[name] = {**out["record"], "forwards": n, "int8_gemm_launches": gemms}
        fused += counts["fusion"]
        log(f"bench_eval {name}: {json.dumps(out['record'])}")
        torch.cuda.empty_cache()
    return {"records": records, "fusion": fused}


def run_split_commands(fusion, batchnorm, tmp) -> dict:
    """Phase 16c: bench_sweep's five variants at SWEEP_STEPS timed calls,
    bench_probes' four probes at PROBE_STEPS, probe_int8 at INT8_ITERS x
    INT8_REPS (its int8 chain on the card bit for bit the integer chain on
    the CPU), probe_int8_static at EVAL_STEPS, bench_loader_scaling at one
    thread count and bench_cold_path, both at small sample counts. Launches: full and noaug 106 of each BN kernel and 6
    wgmma fuser per step, fwdonly 6 wgmma per forward; bb_train 53 of each BN
    kernel per call; probe_int8 one int8 GEMM per chained conv or product."""
    from rot_mvgaze_tpu_torch import (
        bench_cold_path,
        bench_loader_scaling,
        bench_probes,
        bench_sweep,
        probe_int8,
        probe_int8_static,
    )

    out = {}
    calls = 3 + SWEEP_STEPS
    sweep, counts, by_variant, _ = counted(
        fusion, batchnorm, lambda: bench_sweep.run(list(bench_sweep.VARIANTS), steps=SWEEP_STEPS, log=log))
    want = {**per_step(2 * calls, PER_STEP), "fusion": 2 * calls * 6 + calls * 6}
    if counts != want or by_variant["wgmma"] != want["fusion"]:
        raise RuntimeError(f"bench_sweep launched {counts} ({by_variant}), expected {want}, all wgmma")
    out["sweep"], launches = sweep, dict(counts)
    torch.cuda.empty_cache()

    calls = 3 + PROBE_STEPS
    probes, counts, _, _ = counted(
        fusion, batchnorm, lambda: bench_probes.run(list(bench_probes.PROBES), BB_TRAIN_IMAGES, PROBE_STEPS, log=log))
    want = {**{k: 53 * calls for k in BN_KERNELS}, "fusion": 0, "conv3x3_bn_stats": 0}
    if counts != want:
        raise RuntimeError(f"bench_probes launched {counts}, expected {want}")
    out["probes"] = probes
    for k, n in counts.items():
        launches[k] += n
    torch.cuda.empty_cache()

    # the int8 chain through im2col and torch._int_mm against the CPU's exact integer chain
    rng = np.random.default_rng(5)
    x8, w8, _, _ = probe_int8.conv_operands(rng, (4, 14, 14, 64), (3, 3, 64, 64), "cpu")
    a8 = torch.from_numpy(rng.integers(-127, 127, (40, 96), dtype=np.int8))
    b8 = torch.from_numpy(rng.integers(-127, 127, (96, 96), dtype=np.int8))
    exact = (torch.equal(probe_int8.int8_conv_chain(x8.cuda(), w8.cuda(), 3).cpu(),
                         probe_int8.int8_conv_chain(x8, w8, 3))
             and torch.equal(probe_int8.int8_dot_chain(a8.cuda(), b8.cuda(), 3).cpu(),
                             probe_int8.int8_dot_chain(a8, b8, 3)))
    if not exact:
        raise RuntimeError("probe_int8's int8 chain on the card differs from the CPU's integer chain")
    int8, _, _, gemms = counted(fusion, batchnorm, lambda: probe_int8.run(INT8_ITERS, INT8_REPS, log=log))
    want_gemms = INT8_ITERS * (1 + INT8_REPS) * (len(probe_int8.CONV_CASES) + len(probe_int8.DOT_CASES))
    if gemms != want_gemms:
        raise RuntimeError(f"probe_int8 launched {gemms} int8 GEMMs, expected {want_gemms}")
    out["probe_int8"] = int8
    static, counts, by_variant, gemms = counted(fusion, batchnorm,
                                                lambda: probe_int8_static.run(steps=EVAL_STEPS, log=log))
    n = static["forwards"]
    if gemms != R50_CONVS * n or counts["fusion"] != 6 * n or by_variant["wgmma"] != 6 * n:
        raise RuntimeError(f"probe_int8_static launched {gemms} int8 GEMMs and {counts} ({by_variant}) over {n} "
                           f"forwards")
    out["probe_int8_static"] = static["record"]
    launches["fusion"] += counts["fusion"]
    torch.cuda.empty_cache()

    out["loader_scaling"] = bench_loader_scaling.run(LOADER_THREADS, samples=256, iter_samples=1024, work_dir=tmp,
                                                     log=log)
    log("\n" + bench_loader_scaling.table(out["loader_scaling"]))
    out["cold_path"] = bench_cold_path.run(samples=128, files=2, work_dir=tmp, log=log)
    log(f"bench_cold_path: {json.dumps(out['cold_path'])}")
    return {"numbers": out, "launches": launches, "int8_exact": exact}


# launches per update of dryrun_multichip(4, "multiview"): R18's 20 BN calls
# of the fused batch, each on 4 blocks, one finish each; F.linear fusers
MV_DRYRUN_PER_UPDATE = {**{k: 4 * 20 for k in BN_KERNELS}, "fusion": 0, "conv3x3_bn_stats": 0,
                        "bn_stats_finish": 20, "bn_bwd_finish": 20}


def backbone_bn_cases(depth: int, images: int, size: int, name: str) -> list:
    """Every distinct BN shape of one call of the depth-``depth`` backbone
    on ``images`` images of size x size, as BN_CASES entries (name, rows,
    C, relu, residual)."""
    from rot_mvgaze_tpu_torch.models.resnet import BACKBONES

    backbone = BACKBONES[depth]().to(device="cuda", memory_format=torch.channels_last).eval()
    shapes = []
    hooks = record_bn_shapes(backbone, shapes)
    with torch.no_grad():
        backbone(torch.zeros(images, size, size, 3, device="cuda"))
    for h in hooks:
        h.remove()
    cases = {(n * h * w, c, relu, res): None for (n, c, h, w), relu, res in shapes}
    return [(name, rows, c, relu, res) for rows, c, relu, res in cases]


def run_dryrun_commands(fusion, batchnorm) -> dict:
    """Phase 16d: dryrun.entry()'s forward through the kernels against
    plain_kernels() (phase 4's bf16 bar, mean angular delta <= 0.1 deg; 6
    wgmma fuser launches), and dryrun_multichip(4, "reduced") on a logical
    mesh of cuda:0 (and on 4 real cards where the process sees them): 6
    generic fuser launches per update and for the evaluation."""
    from rot_mvgaze_tpu_torch import dryrun
    from rot_mvgaze_tpu_torch.geometry import angular_error

    fn, args = dryrun.entry()
    pred, counts, by_variant, _ = counted(fusion, batchnorm, lambda: fn(*args))
    want = {**dict.fromkeys(PER_STEP, 0), "fusion": 6}
    if counts != want or by_variant["wgmma"] != 6:
        raise RuntimeError(f"entry's forward launched {counts} ({by_variant}), expected {want}, all wgmma")
    with plain_kernels():
        plain = fn(*args)
    delta = float(angular_error(pred, plain).mean())
    log(f"dryrun.entry(): (8, 2) bf16 forward, kernels against plain versions mean {delta:.3e} deg (bar 0.1)")
    if pred.shape != (8, 2) or not torch.isfinite(pred).all() or not delta <= 0.1:
        raise RuntimeError(f"entry's forward: {tuple(pred.shape)}, delta {delta} deg")
    del fn, args
    torch.cuda.empty_cache()
    runs, launches = {}, dict(counts)
    meshes = {"logical": ["cuda:0"] * 4}
    if torch.cuda.device_count() >= 4:
        meshes["cards"] = [f"cuda:{i}" for i in range(4)]
    else:
        log(f"dryrun_multichip(4) over real cards: not run ({torch.cuda.device_count()} visible)")
    for name, devices in meshes.items():
        run, counts, by_variant, _ = counted(
            fusion, batchnorm, lambda: dryrun.dryrun_multichip(4, config="reduced", devices=devices))
        want_fusion = 6 * (run["updates"] + 1)
        if counts["fusion"] != want_fusion or by_variant["generic"] != want_fusion or not all(
                counts[k] for k in BN_KERNELS):
            raise RuntimeError(f"dryrun_multichip(4) on {name} launched {counts} ({by_variant}); expected "
                               f"{want_fusion} generic fuser launches and the BN kernels")
        runs[name] = {**run, "launches": counts}
        for k, n in counts.items():
            launches[k] += n
        torch.cuda.empty_cache()
    # the V-view configuration (R18/64², V=3, f32) on the same meshes: each BN
    # call on four blocks of one sample's three views, one finish each
    bn_err = check_bn_kernels(batchnorm, backbone_bn_cases(18, 3, 64, "multiview dry-run block"))
    for name, devices in meshes.items():
        reset_mesh_counts(fusion, batchnorm)
        run = dryrun.dryrun_multichip(4, config="multiview", devices=devices)
        torch.cuda.synchronize()
        counts = mesh_counts(fusion, batchnorm)
        want = per_step(run["updates"], MV_DRYRUN_PER_UPDATE)
        if counts != want or (run["eval_rows"], run["padded_to"]) != (6, 8):
            raise RuntimeError(f"dryrun_multichip(4, 'multiview') on {name} launched {counts}, expected {want}; "
                               f"evaluation {run['eval_rows']} rows padded to {run['padded_to']}")
        runs[f"multiview_{name}"] = {**run, "launches": counts, "launches_per_update": MV_DRYRUN_PER_UPDATE}
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        log(f"dryrun_multichip(4, 'multiview') on {name}: losses {run['losses']}, {MV_DRYRUN_PER_UPDATE} per update")
        torch.cuda.empty_cache()
    return {"entry_mean_delta_deg": delta, "dryrun": runs, "launches": launches,
            "multiview_block_bn_max_abs_err_bf16": bn_err}


def ema_probe_once(tmp: str, cudnn_deterministic: bool = True) -> dict:
    """probe_ema_benefit --epochs 2 on the card: its record, its unrounded
    history and its final weights and average on the host.
    ``cudnn_deterministic=False``: the control, with the flag set_seed sets
    undone right after it (cuDNN free to take any algorithm, as before the
    repair)."""
    from rot_mvgaze_tpu_torch import probe_ema_benefit as pe
    from rot_mvgaze_tpu_torch.utils import seed

    args = pe.get_parser().parse_args(["--epochs", "2", "--device", "cuda"])
    set_seed = seed.set_seed

    def without_the_flag(*a, **kw):
        gen = set_seed(*a, **kw)
        torch.backends.cudnn.deterministic = False
        return gen

    if not cudnn_deterministic:
        seed.set_seed = without_the_flag
    try:
        out = pe.run(args, tmp)
    finally:
        seed.set_seed = set_seed
        torch.backends.cudnn.deterministic = True
    state = out["state"]
    return {"record": out["record"], "history": state["history"],
            "model": {k: v.detach().cpu().clone() for k, v in state["model"].state_dict().items()},
            "ema": {k: v.detach().cpu().clone() for k, v in state["ema"].items()}}


def weights_digest(run: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for part in ("model", "ema"):
        for k in sorted(run[part]):
            h.update(k.encode())
            h.update(run[part][k].contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def det_worker(out_path: str) -> None:
    """Child process of the determinism check: probe_ema_benefit --epochs 2
    under torch.use_deterministic_algorithms(True), which raises on any
    operation without a deterministic implementation (CUBLAS_WORKSPACE_CONFIG
    set by the parent); writes the history and the weights' digest. TF32
    off, as in the parent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    with tempfile.TemporaryDirectory() as tmp:
        run = ema_probe_once(tmp)
    with open(out_path, "w") as f:
        json.dump({"history": run["history"], "digest": weights_digest(run),
                   "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG")}, f)


def start_det_worker(path: str) -> subprocess.Popen:
    """The child process of :func:`det_worker`, started; it writes to
    ``path``."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--det-worker", path], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def run_determinism(phase15_record: dict, worker: subprocess.Popen, path: str) -> dict:
    """Phase 16f: probe_ema_benefit --epochs 2 (phase 15's cut: 24 float32
    updates at 3e-4) twice in this process, through set_seed: the histories,
    the weights and the average bit for bit the same, and the record phase
    15's; and the child process ``worker`` (:func:`start_det_worker`), the
    probe under torch.use_deterministic_algorithms(True), which must run to
    its end (no operation of the path without a deterministic
    implementation). One control run, with cuDNN's flag undone, is recorded
    beside them: whether its bits differ from the seeded runs'."""
    runs = []
    for _ in range(2):
        with tempfile.TemporaryDirectory() as tmp:
            runs.append(ema_probe_once(tmp))
        torch.cuda.empty_cache()
    a, b = runs
    same_weights = all(torch.equal(a[p][k], b[p][k]) for p in ("model", "ema") for k in a[p])
    same = a["history"] == b["history"] and same_weights and a["record"] == phase15_record
    digest = weights_digest(a)
    log(f"determinism: two seeded EMA probe runs {'bit for bit the same' if same else 'DIFFER'}: "
        f"{a['history']} / {b['history']}; phase 15 {phase15_record['history']}; weights {digest[:16]}")
    if not same:
        raise RuntimeError(f"seeded training is not repeatable: {a['history']} against {b['history']} "
                           f"(weights the same: {same_weights}; phase 15 {phase15_record})")
    with tempfile.TemporaryDirectory() as tmp:
        control = ema_probe_once(tmp, cudnn_deterministic=False)
    control_same = control["history"] == a["history"] and weights_digest(control) == digest
    log(f"determinism, control (cudnn.deterministic off): {control['history']} "
        f"({'the same bits as the seeded runs' if control_same else 'other bits than the seeded runs'})")
    stdout, stderr = worker.communicate(timeout=300)
    if worker.returncode != 0:
        raise RuntimeError(f"the EMA probe under torch.use_deterministic_algorithms(True) failed:\n"
                           f"{stdout[-3000:]}\n{stderr[-6000:]}")
    with open(path) as f:
        det = json.load(f)
    det["same_as_in_process"] = det["history"] == a["history"] and det["digest"] == digest
    log(f"determinism: under use_deterministic_algorithms(True) the probe ran to its end: {det['history']} "
        f"(the same bits as in this process: {det['same_as_in_process']})")
    return {"history": a["history"], "digest": digest, "repeat_bit_for_bit": same,
            "deterministic_algorithms": det,
            "control_without_cudnn_deterministic": {"history": control["history"],
                                                    "same_bits_as_seeded": control_same}}


def run_budget_checks() -> dict:
    """check_command_budgets' three commands on the card, each a fresh
    process under its budget, started side by side (each is timed alone
    from its own start, so running beside the others only makes its budget
    harder to keep); the module's summary of each."""
    from rot_mvgaze_tpu_torch import check_command_budgets

    todo = check_command_budgets.checks("cuda")
    out: list = [None] * len(todo)

    def one(i):
        out[i] = check_command_budgets.run_checks([todo[i]], "cuda")

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(todo))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    checks = [c for summary in out if summary for c in summary["checks"]]
    return {"ok": len(checks) == len(todo) and all(c["ok"] for c in checks), "checks": checks}


def run_drivers_phase(fusion, batchnorm, phase15_record) -> dict:
    """Phase 16: the benchmark commands on the card. Returns the main path's
    launch counts (bench, bench_eval, bench_sweep, bench_probes, the int8
    probes, entry and the dry runs) and the numbers."""
    t_phase = time.perf_counter()
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        bench_out = timed("bench", lambda: run_bench_command(fusion, batchnorm))
        mv_bench = timed("bench_v3_data2", lambda: run_multiview_bench(fusion, batchnorm))
        evals = timed("bench_eval", lambda: run_eval_commands(fusion, batchnorm))
        split = timed("split", lambda: run_split_commands(fusion, batchnorm, tmp))
    with tempfile.TemporaryDirectory() as tmp:
        # the budgets' commands and the determinism check's child (fresh
        # processes) run beside the parts that time nothing: the forward
        # check, the dry runs, the in-process determinism runs
        path = os.path.join(tmp, "det.json")
        worker = start_det_worker(path)
        budgets: dict = {}

        def run_budgets():
            t0 = time.perf_counter()
            budgets.update(run_budget_checks())
            budgets["seconds"] = time.perf_counter() - t0

        thread = threading.Thread(target=run_budgets)
        thread.start()
        try:
            dry = timed("dryrun", lambda: run_dryrun_commands(fusion, batchnorm))
            det = timed("determinism", lambda: run_determinism(phase15_record, worker, path))
        finally:
            thread.join()
            if worker.poll() is None:
                worker.kill()
                worker.wait()
    seconds["check_command_budgets"] = budgets.get("seconds")
    log(f"check_command_budgets on the card, side by side: {json.dumps(budgets)}")
    if not budgets.get("ok"):
        raise RuntimeError(f"check_command_budgets failed on the card: {budgets}")
    launches = {k: bench_out["launches"][k] + mv_bench["launches"][k] + split["launches"][k] + dry["launches"][k]
                for k in PER_STEP}
    launches["fusion"] += evals["fusion"]
    for k in ("bn_stats_finish", "bn_bwd_finish"):
        launches[k] = mv_bench["launches"][k] + dry["launches"][k]
    out = {"bench": bench_out["record"], "bench_host_vs_events_rel": bench_out["host_vs_events_rel"],
           "bench_launches": bench_out["launches"], "bench_v3_data2": mv_bench["record"],
           "bench_v3_data2_host_vs_events_rel": mv_bench["host_vs_events_rel"],
           "bench_v3_data2_launches": mv_bench["launches"], "bench_eval": evals["records"], **split["numbers"],
           "probe_int8_chain_exact": split["int8_exact"], "entry_mean_delta_deg": dry["entry_mean_delta_deg"],
           "dryrun": dry["dryrun"], "multiview_block_bn_max_abs_err_bf16": dry["multiview_block_bn_max_abs_err_bf16"],
           "determinism": det, "check_command_budgets": budgets,
           "seconds_by_part": seconds, "seconds": time.perf_counter() - t_phase}
    log(f"drivers phase: {json.dumps(seconds)}; {out['seconds']:.1f} s in all")
    return {"numbers": out, "launches": launches}


# ---------------------------------------------------------------------------
# old against new in turns (--old DIR)
# ---------------------------------------------------------------------------


def step_bn_shapes(pairs: int = PAIRS) -> list:
    """((N, C, H, W), relu, residual) of the 106 BN calls of one R50
    training step at ``pairs`` pairs: the backbone once per view, as the
    step runs it (eval mode, so that no kernel is needed to find the
    shapes)."""
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm

    torch.manual_seed(0)
    backbone = FeatRotationSymm(backbone_depth=50, num_iter=3)._feat_extractor
    backbone = backbone.to(device="cuda", memory_format=torch.channels_last).eval()
    shapes = []
    hooks = record_bn_shapes(backbone, shapes)
    x = torch.zeros(pairs, 224, 224, 3, device="cuda")  # NHWC, as the backbone takes it
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        for _ in range(2):
            backbone(x)
    for h in hooks:
        h.remove()
    if len(shapes) != 106:
        raise RuntimeError(f"{len(shapes)} BN calls in a step, expected 106")
    return shapes


def step_bn_cases(pairs: int, name: str = "") -> list:
    """Every distinct BN shape of the R50 step at ``pairs`` pairs (of one
    backbone call on ``pairs`` images), as BN_CASES entries (name, rows, C,
    relu, residual)."""
    cases = {}
    for (n, c, h, w), relu, res in step_bn_shapes(pairs):
        cases.setdefault((n * h * w, c, relu, res), None)
    return [(name or f"{pairs}-pair step", rows, c, relu, res) for rows, c, relu, res in cases]


TURN_KERNELS = ("bn_bwd_dx", "bn_bwd_reduce", "bn_stats", "bn_apply")


def time_steps() -> dict:
    """A turn's ``--what steps``: phase 7's bare R50 x 3 step (64 pairs,
    bf16; 2 warm-up and 10 timed steps) seeded through the tree's
    ``set_seed``, and the tree's Trainer (phase 8's corpus and
    ``port_trainer``: one epoch of 3 updates as warm-up, then 2 epochs
    timed), images/s on the host clock; and the cuDNN flags the tree's
    seeding left."""
    from rot_mvgaze_tpu_torch.data import InMemoryGazeDataset
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm
    from rot_mvgaze_tpu_torch.utils.seed import set_seed

    gen = set_seed(0, "cuda")
    flags = {"cudnn_deterministic": torch.backends.cudnn.deterministic,
             "cudnn_benchmark": torch.backends.cudnn.benchmark}
    model, step = make_trainer(FeatRotationSymm(backbone_depth=50, num_iter=3).state_dict(), torch.bfloat16)
    batch = training_batch(seed=21)
    for i in range(2):
        step(batch, gen, step=i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2, 12):
        step(batch, gen, step=i)
    torch.cuda.synchronize()
    bare = 2 * PAIRS * 10 / (time.perf_counter() - t0)
    del model, step, batch
    torch.cuda.empty_cache()
    train_ds = InMemoryGazeDataset(2, n_frames=6, image_size=224, seed=0, learnable=True)
    test_ds = InMemoryGazeDataset(1, n_frames=4, image_size=224, seed=100, learnable=True)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = port_trainer(tmp, train_ds, test_ds, print_freq=10**9, epochs=3)
        trainer.train_one_epoch(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for epoch in (1, 2):
            trainer.train_one_epoch(epoch)
        torch.cuda.synchronize()
        through_trainer = 2 * PAIRS * 6 / (time.perf_counter() - t0)
    return {"bare_step_imgs_per_s": bare, "trainer_imgs_per_s": through_trainer, **flags}


def run_turn(tree: str, shapes_file: str, what: str = "kernels") -> dict:
    """One turn, in a child process: import ``tree``'s port, build its
    kernels and time the fuser at the serving shape (time_cuda, W1 from
    HBM), each kernel of TURN_KERNELS over the step's 106 BN calls
    (device_ms), on the inputs of time_fusion and time_bn, the conv
    kernel at the probe's shape (time_cuda on conv_probe_case's inputs),
    and ``tree``'s bf16 GazePredictor at micro-batch 64 (phase 4's
    checkpoint and time_serving); with ``what="steps"``, :func:`time_steps`
    instead."""
    sys.path.insert(0, tree)
    from rot_mvgaze_tpu_torch.kernels import build
    from rot_mvgaze_tpu_torch.ops import batchnorm, conv_bn, fusion

    if not fusion.__file__.startswith(tree):
        raise RuntimeError(f"turn of {tree} imported {fusion.__file__}")
    build.build()
    if what == "steps":
        return {"tree": tree, **time_steps()}
    _, _, kernel = fusion_serving_case(fusion)
    with open(shapes_file) as f:
        calls = bn_calls(batchnorm, json.load(f))
    record = {"tree": tree, "fusion_ms": time_cuda(kernel, n_iter=200, n_warm=20),
              **{f"{kind}_ms_per_step": device_ms(bn_runner(batchnorm, calls, kind))
                 for kind in TURN_KERNELS},
              "bn_calls": len(calls)}
    del calls
    torch.cuda.empty_cache()
    record["conv_probe_kernel_ms"] = time_cuda(conv_probe_case(conv_bn), n_iter=50, n_warm=3)
    torch.cuda.empty_cache()
    from rot_mvgaze_tpu_torch.serving import GazePredictor

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "r50_seed0.pth.tar")
        make_checkpoint(ckpt)
        pred = GazePredictor(ckpt, backbone_depth=50, num_iter=3, micro_batch=PAIRS, image_size=224,
                             dtype=torch.bfloat16, device="cuda")
        pred.warmup()
        record.update(time_serving(pred, requests([PAIRS], seed=3)[0]))
    return record


def kernel_turns(old: str, card: str, pairs: int = 2, what: str = "kernels") -> dict:
    """The fuser, the BN kernels of TURN_KERNELS and the conv kernel (or,
    ``what="steps"``, the bare step and the Trainer) of an earlier checkout
    ``old`` against this tree's, in ``pairs`` pairs of child processes on
    one card, the order alternating: old, new, new, old, old, new, ...
    Each child prints one JSON line; so does each turn here."""
    new = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(old, "rot_mvgaze_tpu_torch")):
        raise RuntimeError(f"{old} holds no rot_mvgaze_tpu_torch")
    shapes_file = os.path.join(new, "build", "turn_bn_shapes.json")
    os.makedirs(os.path.dirname(shapes_file), exist_ok=True)
    with open(shapes_file, "w") as f:
        json.dump(step_bn_shapes(), f)
    turns = []
    order = [(("old", old), ("new", new)) if k % 2 == 0 else (("new", new), ("old", old)) for k in range(pairs)]
    for label, tree in (turn for pair in order for turn in pair):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", tree, "--shapes", shapes_file, "--what", what],
            capture_output=True, text=True, cwd=tree, timeout=900,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"{label} turn failed:\n{proc.stdout}\n{proc.stderr}")
        record = {"turn": label, **json.loads(proc.stdout.strip().splitlines()[-1]),
                  "seconds": time.perf_counter() - t0}
        print(json.dumps(record), flush=True)
        turns.append(record)
    return {"kernel_turns": turns, "card": card}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default=None, metavar="DIR",
                    help="instead of the phases above, time an earlier checkout's fuser, "
                         "BN kernels and conv kernel against this tree's, in turns")
    ap.add_argument("--pairs", type=int, default=2,
                    help="with --old: pairs of turns, the order alternating (2: old, new, new, old)")
    ap.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--shapes", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--what", default="kernels", choices=["kernels", "steps"],
                    help="with --old: what each turn times: the kernels and bf16 serving, or the bare R50 "
                         "step and the Trainer (each seeded through its tree's set_seed)")
    ap.add_argument("--dp-worker", nargs=2, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--det-worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card", file=sys.stderr)
        return 1
    if args.dp_worker:
        dp_worker(*args.dp_worker)
        return 0
    if args.det_worker:
        det_worker(args.det_worker)
        return 0
    if args.turn:
        print(json.dumps(run_turn(os.path.abspath(args.turn), args.shapes, args.what)), flush=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_seconds, lap = {}, [t_start]

    def done(name):
        now = time.perf_counter()
        phase_seconds[name] = now - lap[0]
        lap[0] = now

    card = card_line()
    name, power = [s.strip() for s in card.split(",", 1)]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.old:
        print(json.dumps(kernel_turns(os.path.abspath(args.old), card, args.pairs, args.what)), flush=True)
        return 0

    from rot_mvgaze_tpu_torch.kernels import build
    from rot_mvgaze_tpu_torch.ops import batchnorm, conv_bn, fusion

    tag = {"card": name, "power_limit": power}
    t0 = time.perf_counter()
    build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for src, report in build.build_logs().items():
        print(f"--- nvcc -Xptxas -v: {src}\n{report.strip()}", flush=True)
    done("1-2 card, build")

    max_abs_err = check_kernels(fusion)
    done("3 fusion kernel")
    # and bench_probes' bb_train (phase 16): one backbone call on both views' 256 images
    bn_err = check_bn_kernels(batchnorm, BN_CASES + step_bn_cases(CLI_BATCH)
                              + step_bn_cases(BB_TRAIN_IMAGES, f"bb_train call of {BB_TRAIN_IMAGES} images"))
    check_fusion_grads(fusion)
    conv_err = check_conv_kernel(conv_bn)
    conv = run_conv_probe(conv_bn, tag)
    torch.cuda.empty_cache()
    done("6 BN and conv kernels, probe")

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "r50_seed0.pth.tar")
        make_checkpoint(ckpt)
        served = run_serving(fusion, ckpt)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    done("4 serving")

    timing = time_fusion(fusion)
    serve = time_serving(served["predictor"], served["request"])
    breakdown = profile_serving(served["predictor"], served["request"])
    served_launches = served["launches"]
    served_variants = served["by_variant"]
    del served
    torch.cuda.empty_cache()
    done("5 timings")

    t0 = time.perf_counter()
    trained = run_training(fusion, batchnorm)
    paths = check_training_paths(fusion, batchnorm)
    bn_timing = time_bn(batchnorm, trained["bn_shapes"])
    log(f"training phases took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    done("7 training")
    keep = tempfile.TemporaryDirectory()
    trainer = run_trainer_phase(fusion, batchnorm, trained["imgs_per_s"], keep.name)
    torch.cuda.empty_cache()
    done("8 trainer")
    cli = run_cli_phase(fusion, batchnorm, trained["imgs_per_s"])
    torch.cuda.empty_cache()
    done("9 command line")
    family = run_family_phase(fusion, batchnorm, bn_timing, trainer["checkpoint"])
    torch.cuda.empty_cache()
    done("10 model family")
    surface = run_serving_surface_phase(fusion, batchnorm, trainer["checkpoint"])
    torch.cuda.empty_cache()
    done("11 serving surface")
    options = run_options_phase(fusion, batchnorm, trained["bn_shapes"])
    torch.cuda.empty_cache()
    done("12 options and data parallelism")
    mesh = run_mesh_phase(fusion, batchnorm)
    torch.cuda.empty_cache()
    done("13 meshes")
    int8_mesh = run_int8_mesh_phase(fusion, batchnorm)
    torch.cuda.empty_cache()
    done("14 int8 on meshes")
    protocols = run_protocol_phase(fusion, batchnorm, trainer["checkpoint"])
    keep.cleanup()
    torch.cuda.empty_cache()
    done("15 protocol commands")
    drivers = run_drivers_phase(fusion, batchnorm, protocols["numbers"]["probe_ema_benefit"]["record"])
    done("16 speed drivers")

    print(json.dumps({"serving_profile": breakdown, **tag}), flush=True)
    print(json.dumps({"training_profile": trained["profile"], **tag}), flush=True)
    print(json.dumps({"training_kernel_vs_plain": paths, **tag}), flush=True)
    print(json.dumps({"trainer": trainer["numbers"], **tag}), flush=True)
    print(json.dumps({"cli": cli["numbers"], **tag}), flush=True)
    print(json.dumps({"model_family": family["numbers"], **tag}), flush=True)
    print(json.dumps({"serving_surface": surface["numbers"], **tag}), flush=True)
    print(json.dumps({"options": options["numbers"], **tag}), flush=True)
    print(json.dumps({"mesh_spatial": mesh["numbers"], **tag}), flush=True)
    print(json.dumps({"int8_mesh": int8_mesh["numbers"], **tag}), flush=True)
    print(json.dumps({"reference_parity": protocols["numbers"], **tag}), flush=True)
    print(json.dumps({"drivers": drivers["numbers"], **tag}), flush=True)
    for metric, value, unit in [
        ("fusion_kernel_ms", timing["ms"], "ms"),
        ("fusion_plain_ms", timing["plain_ms"], "ms"),
        ("fusion_library_ms", timing["library_ms"], "ms"),
        ("fusion_bound_ms", timing["bound_ms"], "ms"),
        ("serve_imgs_per_s", serve["serve_imgs_per_s"], "images/s (2 per stereo pair)"),
        ("serve_p50_ms", serve["serve_p50_ms"], "ms per 64-pair request"),
        ("max_memory_allocated_mb", peak_mb, "MiB"),
        ("train_step_ms", trained["step_ms"], "ms per step of 64 pairs, bf16"),
        ("train_imgs_per_s", trained["imgs_per_s"], "images/s (128 per step)"),
        ("train_max_memory_allocated_mb", trained["peak_mib"], "MiB"),
        ("train_bn_grad_layout_copies", trained["grad_copies"], "copies over 10 steps"),
        ("trainer_imgs_per_s", trainer["numbers"]["train_imgs_per_s_trainer"],
         "images/s through Trainer.train_one_epoch (loader, prefetch, step), 2 epochs of 3 steps"),
        ("trainer_device_idle_share", trainer["numbers"]["device_idle_share_3_trainer_steps"],
         "share of the host wall time over one epoch of 3 Trainer steps"),
        ("trainer_max_memory_allocated_mb", trainer["numbers"]["max_memory_allocated_mb"], "MiB"),
        ("cli_imgs_per_s", cli["numbers"]["imgs_per_s_over_updates"],
         "images/s over the command line's 28 updates of 50 pairs (first start to last end, host "
         "clock; a smoke reading)"),
        ("cli_loader_wait_share", cli["numbers"]["loader_wait_share"],
         "share of that span between updates (loader wait and batch staging)"),
        ("cli_max_memory_allocated_mb", cli["numbers"]["max_memory_allocated_mb"], "MiB"),
        ("cli_phase_seconds", cli["numbers"]["seconds"], "s (corpus, train, test, export)"),
        ("family_fuse_views_imgs_per_s", family["numbers"]["imgs_per_s_bare_update"]["fuse_views"],
         "images/s over 5 bare fuse_views updates of 64 pairs, bf16 (host clock; a smoke reading)"),
        ("family_v3_imgs_per_s", family["numbers"]["imgs_per_s_bare_update"]["v3"],
         "images/s over 5 bare V=3 updates of 64 frames, bf16 (host clock; a smoke reading)"),
        ("family_max_memory_allocated_mb", family["numbers"]["max_memory_allocated_mb"], "MiB"),
        ("family_phase_seconds", family["numbers"]["seconds"], "s"),
    ] + [
        (f"surface_serve_{k}_{name}", v, unit)
        for name, t in surface["numbers"]["serving"].items()
        for k, v, unit in (("imgs_per_s", t["serve_imgs_per_s"], "images/s at micro-batch 64, R50 x 3, host clock"),
                           ("p50_ms", t["serve_p50_ms"], "ms per 64-pair request"))
    ] + [
        (f"surface_artifact_bytes_{name}", a["bytes"], "bytes") for name, a in surface["numbers"]["artifacts"].items()
    ] + [
        ("surface_max_memory_allocated_mb", surface["numbers"]["max_memory_allocated_mb"], "MiB"),
        ("surface_phase_seconds", surface["numbers"]["seconds"], "s"),
        ("remat_update_max_memory_allocated_mb", options["numbers"]["remat"]["peak_mib_remat"],
         "MiB, one bf16 update of 64 pairs with --remat"),
        ("plain_update_max_memory_allocated_mb", options["numbers"]["remat"]["peak_mib_plain"],
         "MiB, the same update without --remat"),
        ("options_phase_seconds", options["numbers"]["seconds"], "s"),
        ("mesh_phase_seconds", mesh["numbers"]["seconds"], "s"),
        ("int8_mesh_phase_seconds", int8_mesh["numbers"]["seconds"], "s"),
        ("protocol_commands_phase_seconds", protocols["numbers"]["seconds"], "s (the four-protocol table at R50, "
         "pairing_sensitivity and probe_ema_benefit, each with its plain-version check)"),
        ("bench_imgs_per_s", drivers["numbers"]["bench"]["value"],
         "images/s of python -m rot_mvgaze_tpu_torch.bench at its defaults (R50 x 3, 224^2, 128 pairs, bf16; "
         "host clock over 20 steps)"),
        ("bench_mfu", drivers["numbers"]["bench"]["mfu"], "flops_per_step x steps/s / 989e12"),
        ("drivers_phase_seconds", drivers["numbers"]["seconds"], "s (the benchmark commands)"),
    ] + [
        (f"mesh_serve_{k}_{name}", rec[f"bf16_serve_{k}"], unit)
        for name, rec in mesh["numbers"]["logical"]["serving"].items() if name.startswith("data")
        for k, unit in (("imgs_per_s", "images/s at micro-batch 63/64, R50 x 3, bf16, logical mesh on one card, "
                                       "host clock"), ("p50_ms", "ms per 64-pair request"))
    ] + [
        (f"int8_mesh_serve_{k}_{mode}_{name}", rec[f"{mode}_bf16_serve"][f"serve_{k}"], unit)
        for name, rec in int8_mesh["numbers"].items() if name.startswith("data") for mode in INT8_MODES
        for k, unit in (("imgs_per_s", "images/s at micro-batch 64, R50 x 3, bf16, int8, logical mesh on one "
                                       "card, host clock"), ("p50_ms", "ms per 64-pair request"))
    ] + [
        (f"mesh_{name}_update_ms", rec["update_ms"], "ms per bf16 update of 64 pairs on a logical mesh, host clock "
         f"(unsharded: {rec['unsharded_update_ms']:.1f} ms)")
        for name, rec in mesh["numbers"]["logical"]["training"].items() if name.startswith("spatial")
        and "update_ms" in rec
    ] + [
        (f"{name}_ms_per_step", rec["ms"], "ms over the step's 106 BN calls at 64 pairs, bf16"
         + (f" (k=1 {rec['k1_kernel']} beside it: {rec['k1_ms']} ms)" if "k1_ms" in rec else ""))
        for name, rec in options["numbers"]["options_bn_ms_per_step"].items()
    ] + [
        (f"{kind}_ms_per_{name}_update", rec["ms"], "ms over the update's 53 calls")
        for name, t in family["numbers"]["bn_ms_per_update"].items() for kind, rec in t.items()
    ] + [
        (f"{kind}_{key}_per_step", t[key], "ms over the step's 106 calls")
        for kind, t in bn_timing.items()
        for key in ("ms", "plain_ms", "library_ms", "library_pair_ms", "bound_ms")
    ]:
        print(json.dumps({"metric": metric, "value": value, "unit": unit, **tag}), flush=True)

    dp_ranks = {k: sum(r[k] for per_dtype in options["dp_launches"] for r in per_dtype)
                for k in list(PER_STEP) + ["bn_stats_finish", "bn_bwd_finish"]}
    mesh_fusion = mesh["serving_launches"] + mesh["launches"].get("fusion", 0)
    int8_mesh_fusion = int8_mesh["launches"]["fusion"]
    kernels = [{
        **FUSION,
        "launches": served_launches + trained["launches"]["fusion"] + trainer["launches"]["fusion"]
                    + cli["launches"]["fusion"] + family["launches"]["fusion"] + surface["launches"]
                    + options["launches"]["fusion"] + dp_ranks["fusion"] + mesh_fusion + int8_mesh_fusion
                    + protocols["launches"]["fusion"] + drivers["launches"]["fusion"],
        "launches_by_path": {"serving": served_launches, "training": trained["launches"]["fusion"],
                             "trainer": trainer["launches"]["fusion"], "cli": cli["launches"]["fusion"],
                             "model_family": family["launches"]["fusion"], "serving_surface": surface["launches"],
                             "options": options["launches"]["fusion"], "data_parallel_ranks": dp_ranks["fusion"],
                             "mesh_spatial": mesh_fusion, "int8_mesh": int8_mesh_fusion,
                             "protocol_commands": protocols["launches"]["fusion"],
                             "drivers": drivers["launches"]["fusion"]},
        "int8_gemm_launches_int8_mesh": int8_mesh["launches"]["int8_gemm"],
        "launches_by_variant": {k: served_variants[k] + trained["fusion_by_variant"][k]
                                + trainer["by_variant"][k] + cli["by_variant"][k] + family["by_variant"][k]
                                + surface["by_variant"][k] + (protocols["generic"] if k == "generic" else 0)
                                for k in fusion.VARIANTS},
        "max_abs_err": max_abs_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }] + [{
        "name": kind,
        "route": "cuda",
        "source": BN_SOURCE,
        "replaces": replaces,
        "launches": trained["launches"][kind] + trainer["launches"][kind] + cli["launches"][kind]
                    + family["launches"][kind] + options["launches"][kind] + dp_ranks[kind]
                    + mesh["launches"].get(kind, 0) + protocols["launches"][kind] + drivers["launches"][kind],
        "launches_by_path": {"training": trained["launches"][kind], "trainer": trainer["launches"][kind],
                             "cli": cli["launches"][kind], "model_family": family["launches"][kind],
                             "options": options["launches"][kind], "data_parallel_ranks": dp_ranks[kind],
                             "mesh_spatial": mesh["launches"].get(kind, 0),
                             "protocol_commands": protocols["launches"][kind],
                             "drivers": drivers["launches"][kind]},
        **({"finish_launches_data_parallel_ranks": dp_ranks[DP_FINISH[kind]],
            "finish_launches_mesh_spatial": mesh["launches"].get(DP_FINISH[kind], 0),
            "finish_launches_drivers": drivers["launches"][DP_FINISH[kind]]} if kind in DP_FINISH else {}),
        **{f"{name}_ms": rec["ms"] for name, rec in options["numbers"]["options_bn_ms_per_step"].items()
           if name.startswith(kind)},
        "max_abs_err": max(bn_err[kind], family["numbers"]["bn_max_abs_err_bf16"][kind],
                           options["numbers"]["prefix_bn_max_abs_err_bf16"].get(kind, 0.0),
                           mesh["numbers"]["logical"]["training"]["strip_bn_max_abs_err_bf16"][kind],
                           mesh["numbers"]["logical"]["multiview"]["block_bn_max_abs_err_bf16"][kind],
                           drivers["numbers"]["multiview_block_bn_max_abs_err_bf16"][kind]),
        "ms": bn_timing[kind]["ms"],
        "plain_ms": bn_timing[kind]["plain_ms"],
        "bound_ms": bn_timing[kind]["bound_ms"],
        "bound_by": bn_timing[kind]["bound_by"],
        "library_ms": bn_timing[kind]["library_ms"],
        "library_covers": bn_timing[kind]["library_covers"],
        "library_pair_ms": bn_timing[kind]["library_pair_ms"],
        "library_pair_covers": bn_timing[kind]["library_pair_covers"],
        "timed_over": "the 106 BN calls of one R50 step at 64 pairs, bf16",
    } for kind, replaces in BN_KERNELS.items()] + [{
        **CONV,
        "launches": conv["launches"],
        "launches_by_path": {"probe": conv["launches"]},
        "launches_by_variant": conv["by_variant"],
        "max_abs_err": conv_err,
        "ms": conv["record"]["kernel_ms"],
        "plain_ms": conv["record"]["plain_ms"],
        "bound_ms": conv["record"]["bound_ms"],
        "bound_by": conv["record"]["bound_by"],
        "library_ms": conv["record"]["library_conv_plus_stats_ms"],
        "library_covers": "F.conv2d (bf16, channels_last) + torch.batch_norm_stats",
        "r50_shapes": [{k: rec[k] for k in ("B", "HW", "C", "kernel_ms", "library_conv_ms",
                                             "library_conv_plus_stats_ms", "bound_ms", "verdict")}
                       for rec in conv["r50"]],
        "timed_over": "one call at the probe's shape, 256 x 14 x 14 x 256 -> 256, bf16",
    }]
    phase_seconds["all"] = time.perf_counter() - t_start
    log(f"phase seconds: {json.dumps(phase_seconds)}")
    print(json.dumps({"phase_seconds": phase_seconds, **tag}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
