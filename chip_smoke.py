#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rot_mvgaze_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the repository root. It drives the port only and imports nothing
of JAX or of the JAX package. Phases, in order; any failure raises, so the
script exits non-zero and prints no result line:

1. card: requires CUDA; prints the card's name and power limit.
2. build: compiles every csrc/*.cu for sm_90a and prints each -Xptxas -v
   report (registers, shared memory, spills).
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes and at ragged ones. float32 runs with TF32 off
   (cuBLAS and cuDNN) throughout the script, so float32 means float32.
4. serving: FeatRotationSymm(backbone_depth=50, num_iter=3) at full width,
   seeded random weights (BN running statistics estimated from one batch,
   so activations have a trained net's scale), saved as a reference-format
   .pth.tar and loaded by GazePredictor (bf16, micro-batch 64, 224x224).
   The HTTP server answers concurrent requests of N in {1, 17, 64, 100}
   through BatchingPredictor; kernel launch counts are reset just before and
   read just after, and must be 6 per micro-batch (2 views x 3 iterations).
   Replies must match direct predicts, and the kernel path must agree with
   the plain path on the card (bf16: mean angular delta <= 0.1 deg; f32:
   atol 2e-4 / rtol 1e-3 on pred_gaze).
5. timings: each kernel, its plain version and one PyTorch library call for
   the same function (CUDA events, four weight copies in rotation so that W1
   comes from HBM as on the serving path), the bound from bytes and
   operations, serving throughput and p50 latency, peak device memory, and
   the serving path's device time by kernel class (torch.profiler). One
   JSON line per number, tagged with the card's name and power limit.
6. the kernels line, the card line, and as the last line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import http.client
import io
import json
import os
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
    "source": "rot_mvgaze_tpu_torch/csrc/fusion.cu",
    "replaces": "rot_mvgaze_tpu/ops/fusion.py:44",
}
# serving shapes of the fuser's layer 1 at R50: B, D, V, H
B, D, V, H = 64, 2048, 512, 3584


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
    max |err| at the serving shape in bf16."""
    cases = [
        ("serving", B, H, torch.bfloat16), ("serving", B, H, torch.float32),
        ("b1", 1, H, torch.bfloat16), ("b1", 1, H, torch.float32),
        ("b50", 50, H, torch.bfloat16), ("b50", 50, H, torch.float32),
        ("h1000", B, 1000, torch.bfloat16), ("h1000", B, 1000, torch.float32),
    ]
    serving_err = None
    for name, b, h, dtype in cases:
        (img, feat, rot), [(w1, b1)] = fusion_inputs(b, D, V, h, dtype, seed=b + h)
        got = fusion.rotate_concat_matmul_relu(img, feat, rot, w1, b1)
        torch.cuda.synchronize()
        want = fusion.rotate_concat_matmul_relu_reference(img, feat, rot, w1, b1)
        # f32: TF32 off on both sides. bf16 compared in f32: one bf16 ulp is
        # 2^-8 and K is 3584
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        log(f"fusion kernel {name} B={b} H={h} {str(dtype)[6:]}: max|err| {err:.3e} (tol {tol})")
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
def plain_fusion(fusion):
    """Route the model's fuser through the plain PyTorch version (on the
    card), for the kernel-vs-plain check of the whole path."""
    kernel = fusion.rotate_concat_matmul_relu
    fusion.rotate_concat_matmul_relu = fusion.rotate_concat_matmul_relu_reference
    try:
        yield
    finally:
        fusion.rotate_concat_matmul_relu = kernel


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
    try:
        # --- main path: counts reset just before, read just after
        fusion.rotate_concat_matmul_relu.launches = 0
        mb_before = pred.micro_batches_run
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        launches = fusion.rotate_concat_matmul_relu.launches
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
    with plain_fusion(fusion):
        plain_bf16 = pred.predict(*check)
    delta = float(angular_error_numpy(kernel_bf16, plain_bf16).mean())
    log(f"bf16 kernel vs plain path: mean angular delta {delta:.4e} deg (bar 0.1)")
    if not delta <= 0.1:
        raise RuntimeError(f"bf16 kernel path deviates from plain path by {delta} deg")
    pred32 = GazePredictor(ckpt, backbone_depth=50, num_iter=3, micro_batch=64,
                           image_size=224, dtype=torch.float32, device="cuda")
    kernel_f32 = pred32.predict(*check)
    with plain_fusion(fusion):
        plain_f32 = pred32.predict(*check)
    err32 = float(np.abs(kernel_f32 - plain_f32).max())
    np.testing.assert_allclose(kernel_f32, plain_f32, atol=2e-4, rtol=1e-3)
    log(f"f32 kernel vs plain path: max |diff| {err32:.3e} (atol 2e-4, rtol 1e-3)")
    del pred32
    return {"launches": launches, "predictor": pred, "request": requests([64], seed=3)[0]}


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


def time_fusion(fusion) -> dict:
    """Kernel, plain version and library call at the serving shape in bf16.
    Four (W1, b1) copies in rotation (103 MB, over the 50 MB L2), so each
    call reads W1 from HBM."""
    (img, feat, rot), weights = fusion_inputs(B, D, V, H, torch.bfloat16, seed=7, copies=4)
    x_cat = torch.cat(
        [img, torch.einsum("bij,bjv->biv", rot, feat.float()).to(img.dtype).flatten(1)], 1
    )
    lib_bias = [b1.to(torch.bfloat16) for _, b1 in weights]

    def kernel(i):
        w1, b1 = weights[i % 4]
        fusion.rotate_concat_matmul_relu(img, feat, rot, w1, b1)

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
    ("fusion kernel", ("rotate_concat_matmul_relu",)),
    ("convolution", ("conv", "fprop", "implicit", "dgrad", "xmma", "winograd")),
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pred.predict(*req)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_iter):
            pred.predict(*req)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_class: dict = {}
    for e in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats the
        # time of the kernels it launched
        us = e.self_device_time_total
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue
        key = e.key.lower()
        cls = next((c for c, pats in PROFILE_CLASSES if any(p in key for p in pats)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us
    busy = sum(by_class.values())
    return {
        "window_ms_per_request": wall_us / n_iter / 1e3,
        "device_busy_ms_per_request": busy / n_iter / 1e3,
        "device_idle_share": (1 - busy / wall_us) if busy else None,
        "device_ms_per_request_by_class": {
            c: us / n_iter / 1e3 for c, us in sorted(by_class.items(), key=lambda kv: -kv[1])
        },
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name, power = [s.strip() for s in card.split(",", 1)]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from rot_mvgaze_tpu_torch.kernels import build
    from rot_mvgaze_tpu_torch.ops import fusion

    t0 = time.perf_counter()
    build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for src, report in build.build_logs().items():
        print(f"--- nvcc -Xptxas -v: {src}\n{report.strip()}", flush=True)

    max_abs_err = check_kernels(fusion)

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "r50_seed0.pth.tar")
        make_checkpoint(ckpt)
        served = run_serving(fusion, ckpt)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    timing = time_fusion(fusion)
    serve = time_serving(served["predictor"], served["request"])
    breakdown = profile_serving(served["predictor"], served["request"])

    tag = {"card": name, "power_limit": power}
    print(json.dumps({"serving_profile": breakdown, **tag}), flush=True)
    for metric, value, unit in [
        ("fusion_kernel_ms", timing["ms"], "ms"),
        ("fusion_plain_ms", timing["plain_ms"], "ms"),
        ("fusion_library_ms", timing["library_ms"], "ms"),
        ("fusion_bound_ms", timing["bound_ms"], "ms"),
        ("serve_imgs_per_s", serve["serve_imgs_per_s"], "images/s (2 per stereo pair)"),
        ("serve_p50_ms", serve["serve_p50_ms"], "ms per 64-pair request"),
        ("max_memory_allocated_mb", peak_mb, "MiB"),
    ]:
        print(json.dumps({"metric": metric, "value": value, "unit": unit, **tag}), flush=True)

    kernels = [{
        **FUSION,
        "launches": served["launches"],
        "max_abs_err": max_abs_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
