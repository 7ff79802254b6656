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
   card, at the serving shapes, B in {1, 8, 32, 50, 200} (8 and 32: the
   trainer phase's ragged f32 eval batch and grad_accum micro-batch),
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
   a ragged shape and every distinct BN shape of the step at 50 pairs (the
   command line phase's batch), with bn_stats and bn_bwd_reduce called twice, bit
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
   phase's seconds. --num_views 3 --grad_accum 2 and --remat true exit
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
11. the kernels line, the card line, and as the last line
   {"ok": true, "device": {...}}.

    python3 chip_smoke.py --old DIR

runs phase 1 and then, instead of phases 2-11, times an earlier checkout's
kernels against this tree's in turns on the same card: DIR holds a checkout
of an earlier commit (for example ``git archive <commit>`` unpacked into a
directory that .gitignore lists). Four child processes run in the order
old, new, new, old; each builds its own tree's kernels and times the fuser
at the serving shape (time_fusion's inputs and timing), bn_bwd_dx,
bn_bwd_reduce, bn_stats and bn_apply over the 106 BN calls of one training step
(time_bn's inputs and timing), at shapes taken once from this tree's R50
backbone, and the conv kernel at the probe's shape (run_probe's inputs and
timing). One JSON line per turn, and a last line with every turn and the
card.
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
    ragged last batch, b20 the command line phase's."""
    cases = [
        ("serving", B, D, V, H, torch.bfloat16), ("serving", B, D, V, H, torch.float32),
        ("b1", 1, D, V, H, torch.bfloat16), ("b1", 1, D, V, H, torch.float32),
        ("b8", 8, D, V, H, torch.float32),
        ("b20", 20, D, V, H, torch.float32),
        ("b32", 32, D, V, H, torch.bfloat16), ("b32", 32, D, V, H, torch.float32),
        ("b50", 50, D, V, H, torch.bfloat16), ("b50", 50, D, V, H, torch.float32),
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


def make_trainer(state, dtype, grad_accum=1, flags=None):
    """(model, train_step) from a saved state dict: R50 x 3 iterations of
    the configuration ``flags`` (family_model)."""
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
    options = dict(image_size=224, schedule=cyclic_triangular2(1e-6, 1e-3, step_size_up=50, step_size_down=50),
                   compute_dtype=dtype)
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
                raise RuntimeError(f"grad {n} ({name}): kernel path {ek:.3e} from f64, plain {ep:.3e}")
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
        for refused in (["--num_views", "3", "--grad_accum", "2"], ["--remat", "true"]):
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


def step_bn_cases(pairs: int) -> list:
    """Every distinct BN shape of the R50 step at ``pairs`` pairs, as
    BN_CASES entries (name, rows, C, relu, residual)."""
    cases = {}
    for (n, c, h, w), relu, res in step_bn_shapes(pairs):
        cases.setdefault((n * h * w, c, relu, res), None)
    return [(f"{pairs}-pair step", rows, c, relu, res) for rows, c, relu, res in cases]


TURN_KERNELS = ("bn_bwd_dx", "bn_bwd_reduce", "bn_stats", "bn_apply")


def run_turn(tree: str, shapes_file: str) -> dict:
    """One turn, in a child process: import ``tree``'s port, build its
    kernels and time the fuser at the serving shape (time_cuda, W1 from
    HBM), each kernel of TURN_KERNELS over the step's 106 BN calls
    (device_ms), on the inputs of time_fusion and time_bn, and the conv
    kernel at the probe's shape (time_cuda on conv_probe_case's inputs)."""
    sys.path.insert(0, tree)
    from rot_mvgaze_tpu_torch.kernels import build
    from rot_mvgaze_tpu_torch.ops import batchnorm, conv_bn, fusion

    if not fusion.__file__.startswith(tree):
        raise RuntimeError(f"turn of {tree} imported {fusion.__file__}")
    build.build()
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
    return record


def kernel_turns(old: str, card: str) -> dict:
    """The fuser, the BN kernels of TURN_KERNELS and the conv kernel of
    an earlier checkout ``old`` against this tree's, in four child
    processes on one card: old, new, new, old. Each child prints one JSON
    line; so does each turn here."""
    new = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(old, "rot_mvgaze_tpu_torch")):
        raise RuntimeError(f"{old} holds no rot_mvgaze_tpu_torch")
    shapes_file = os.path.join(new, "build", "turn_bn_shapes.json")
    os.makedirs(os.path.dirname(shapes_file), exist_ok=True)
    with open(shapes_file, "w") as f:
        json.dump(step_bn_shapes(), f)
    turns = []
    for label, tree in (("old", old), ("new", new), ("new", new), ("old", old)):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", tree, "--shapes", shapes_file],
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
    ap.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--shapes", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card", file=sys.stderr)
        return 1
    if args.turn:
        print(json.dumps(run_turn(os.path.abspath(args.turn), args.shapes)), flush=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name, power = [s.strip() for s in card.split(",", 1)]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.old:
        print(json.dumps(kernel_turns(os.path.abspath(args.old), card)), flush=True)
        return 0

    from rot_mvgaze_tpu_torch.kernels import build
    from rot_mvgaze_tpu_torch.ops import batchnorm, conv_bn, fusion

    tag = {"card": name, "power_limit": power}
    t0 = time.perf_counter()
    build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for src, report in build.build_logs().items():
        print(f"--- nvcc -Xptxas -v: {src}\n{report.strip()}", flush=True)

    max_abs_err = check_kernels(fusion)
    bn_err = check_bn_kernels(batchnorm, BN_CASES + step_bn_cases(CLI_BATCH))
    check_fusion_grads(fusion)
    conv_err = check_conv_kernel(conv_bn)
    conv = run_conv_probe(conv_bn, tag)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "r50_seed0.pth.tar")
        make_checkpoint(ckpt)
        served = run_serving(fusion, ckpt)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    timing = time_fusion(fusion)
    serve = time_serving(served["predictor"], served["request"])
    breakdown = profile_serving(served["predictor"], served["request"])
    served_launches = served["launches"]
    served_variants = served["by_variant"]
    del served
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    trained = run_training(fusion, batchnorm)
    paths = check_training_paths(fusion, batchnorm)
    bn_timing = time_bn(batchnorm, trained["bn_shapes"])
    log(f"training phases took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    keep = tempfile.TemporaryDirectory()
    trainer = run_trainer_phase(fusion, batchnorm, trained["imgs_per_s"], keep.name)
    torch.cuda.empty_cache()
    cli = run_cli_phase(fusion, batchnorm, trained["imgs_per_s"])
    torch.cuda.empty_cache()
    family = run_family_phase(fusion, batchnorm, bn_timing, trainer["checkpoint"])
    keep.cleanup()

    print(json.dumps({"serving_profile": breakdown, **tag}), flush=True)
    print(json.dumps({"training_profile": trained["profile"], **tag}), flush=True)
    print(json.dumps({"training_kernel_vs_plain": paths, **tag}), flush=True)
    print(json.dumps({"trainer": trainer["numbers"], **tag}), flush=True)
    print(json.dumps({"cli": cli["numbers"], **tag}), flush=True)
    print(json.dumps({"model_family": family["numbers"], **tag}), flush=True)
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
        (f"{kind}_ms_per_{name}_update", rec["ms"], "ms over the update's 53 calls")
        for name, t in family["numbers"]["bn_ms_per_update"].items() for kind, rec in t.items()
    ] + [
        (f"{kind}_{key}_per_step", t[key], "ms over the step's 106 calls")
        for kind, t in bn_timing.items()
        for key in ("ms", "plain_ms", "library_ms", "library_pair_ms", "bound_ms")
    ]:
        print(json.dumps({"metric": metric, "value": value, "unit": unit, **tag}), flush=True)

    kernels = [{
        **FUSION,
        "launches": served_launches + trained["launches"]["fusion"] + trainer["launches"]["fusion"]
                    + cli["launches"]["fusion"] + family["launches"]["fusion"],
        "launches_by_path": {"serving": served_launches, "training": trained["launches"]["fusion"],
                             "trainer": trainer["launches"]["fusion"], "cli": cli["launches"]["fusion"],
                             "model_family": family["launches"]["fusion"]},
        "launches_by_variant": {k: served_variants[k] + trained["fusion_by_variant"][k]
                                + trainer["by_variant"][k] + cli["by_variant"][k] + family["by_variant"][k]
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
                    + family["launches"][kind],
        "launches_by_path": {"training": trained["launches"][kind], "trainer": trainer["launches"][kind],
                             "cli": cli["launches"][kind], "model_family": family["launches"][kind]},
        "max_abs_err": max(bn_err[kind], family["numbers"]["bn_max_abs_err_bf16"][kind]),
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
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
