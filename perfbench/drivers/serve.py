"""Closed-loop serving: concurrent clients, each sending its next frame
when the reply to the last has come.

Set-up writes the benchmark's seeded weights as a checkpoint under
``TMPDIR`` (in the served dtype, BatchNorm float32) and builds the system's
predictor from it (``serving.MultiViewGazePredictor``), behind
``serving.BatchingPredictor``; a thin proxy between the two records a span
around every micro-batch the dispatcher runs. It makes a pool of ``frames`` seeded frames, and warms the whole path with
the clients below for ``warmup_seconds``. The window starts ``clients``
threads together (:class:`Clients`); each sends requests of
``frames_per_request`` frames, the next when the reply to the last has
come, until ``--seconds`` have passed, and times each from its send to its
reply on its own clock. Throughput counts the images of the replies delivered inside the
window; the latency tail is over every request sent inside it (the last
ones are waited for). Once the window has closed and the peak memory is
read, the predictor is freed and the float32 reference answers every frame
of the pool; each reply is judged against the answer for its own frame.

Traffic keys: ``clients``, ``frames_per_request``, ``frames``, ``max_delay_ms``, ``micro_batch``,
``warmup_seconds`` and ``int8`` (the system's int8 path; false for a
bf16 cell).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import inputs, weights
from perfbench.manifest import sub_seed
from perfbench.reference.ops import angle_deg
from perfbench.reference.train import serve_answers

OVER_DEG = 1.0  # a reply this far from the reference's answer for its frame is wrong, whatever the rest read


class SpanProxy:
    """The predictor as ``BatchingPredictor`` sees it, with a span around
    each ``predict`` (one coalesced micro-batch)."""

    def __init__(self, predictor: Any, spans: Any) -> None:
        self.inner, self.spans = predictor, spans
        self.request_fields = predictor.request_fields
        self.micro_batch = predictor.micro_batch
        self.image_size = predictor.image_size

    def validate_request(self, *args: Any, **kwargs: Any) -> int:
        return self.inner.validate_request(*args, **kwargs)

    def predict(self, *args: np.ndarray) -> np.ndarray:
        with self.spans.span("microbatch"):
            return self.inner.predict(*args)


class Clients:
    """``clients`` threads, started at once, each sending requests of
    ``frames_per_request`` frames of the pool, the next when the reply to
    the last has come, until ``end``; client ``c``'s ``j``-th request holds
    the pool's frames from ``(c + clients * j) * frames_per_request`` on.
    Records ``(frames, sent, replied, answer or None)`` per request, and a
    ``request`` span where ``spans`` is given."""

    def __init__(self, server: Any, pool: Dict[str, np.ndarray], traffic: Dict[str, Any], spans: Any = None) -> None:
        self.server, self.pool, self.spans = server, pool, spans
        self.n, self.per_request, self.frames = traffic["clients"], traffic["frames_per_request"], traffic["frames"]
        self.results: List[List[tuple]] = [[] for _ in range(self.n)]
        self.errors: List[int] = [0] * self.n
        self.end = 0.0
        self._go = threading.Event()
        self._threads = [threading.Thread(target=self._client, args=(c,), daemon=True) for c in range(self.n)]
        for t in self._threads:
            t.start()

    def _client(self, c: int) -> None:
        self._go.wait()
        j = 0
        while True:
            ts = time.perf_counter()
            if ts >= self.end:
                return
            first = (c + self.n * j) * self.per_request % self.frames
            # a slice of the pool is a view: the harness copies no pixels
            rows = (slice(first, first + self.per_request) if first + self.per_request <= self.frames
                    else np.arange(first, first + self.per_request) % self.frames)
            try:
                out = self.server.predict(self.pool["imgs"][rows], self.pool["head_poses"][rows])
            except Exception:  # a failed request counts as failed, the run goes on
                self.errors[c] += 1
                out = None
            te = time.perf_counter()
            if self.spans is not None:
                self.spans.add("request", ts, te)
            self.results[c].append((rows, ts, te, out))
            j += 1

    def run(self, end: float) -> None:
        """Release the clients until ``end`` and wait for their last replies."""
        self.end = end
        self._go.set()
        for t in self._threads:
            t.join()


def run(ctx: Any) -> Dict[str, Any]:
    from rot_mvgaze_tpu_torch.serving import BatchingPredictor, MultiViewGazePredictor

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    m = cfg["model"]
    dtype = getattr(torch, m["dtype"])
    w_seed = sub_seed(ctx.seed, "weights")
    state = weights.make_state(cfg, w_seed, dev, dtype)
    ctx.mark("weights")
    fd, path = tempfile.mkstemp(suffix=".pth.tar", dir=os.environ.get("TMPDIR"))
    os.close(fd)
    try:
        torch.save(state, path)
        del state
        predictor = MultiViewGazePredictor(path, num_views=m["num_views"], backbone_depth=m["backbone_depth"],
                                           num_iter=m["num_iter"], micro_batch=traffic["micro_batch"],
                                           image_size=m["image_size"], dtype=dtype, int8=traffic["int8"],
                                           device=dev)
    finally:
        os.unlink(path)
    ctx.mark("predictor")
    if ctx.plant is not None:
        predictor = ctx.plant(predictor)
    g = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, "frames"))
    pool_dev = inputs.frames(traffic["frames"], m["num_views"], m["image_size"], g)
    pool = {k: v.cpu().numpy() for k, v in pool_dev.items()}
    predictor.warmup()
    server = BatchingPredictor(SpanProxy(predictor, ctx.spans), max_delay_ms=traffic["max_delay_ms"])
    Clients(server, pool, traffic).run(time.perf_counter() + traffic["warmup_seconds"])
    ctx.mark("warmup")

    clients = Clients(server, pool, traffic, ctx.spans)
    ctx.sync()
    with ctx.window():
        before = predictor.micro_batches_run
        t0 = ctx.window_start()
        end = t0 + ctx.seconds
        clients.run(end)
        after = predictor.micro_batches_run
        ctx.sync()
    ctx.mark("window_end")
    ctx.log("requests by quarter of the window (count, mean s): "
            f"{ctx.spans.quarters('request', t0, end)}")
    server.close()
    peak = ctx.memory_peak()

    done = [(np.arange(traffic["frames"])[r[0]], *r[1:]) for rs in clients.results for r in rs]
    delivered = sum(len(r[0]) for r in done if r[3] is not None and r[2] <= end)
    latency_ms = sorted((r[2] - r[1]) * 1e3 for r in done)
    failed = sum(clients.errors)
    answered = [r for r in done if r[3] is not None]
    del predictor, server
    ctx.free()
    ref = serve_answers(cfg, weights.make_state(cfg, w_seed, dev, dtype), pool_dev).cpu().numpy()
    frames_idx = np.concatenate([r[0] for r in answered]) if answered else np.zeros(0, int)
    got = np.concatenate([r[3] for r in answered]) if answered else np.zeros((0, 2))
    gaps = angle_deg(got, ref[frames_idx]) if answered else np.array([np.inf])
    ctx.mark("reference")
    views = m["num_views"]
    return {
        "e2e": {"serve_images_per_s": delivered * views / ctx.seconds,
                "serve_p95_ms": float(np.quantile(latency_ms, 0.95)) if latency_ms else float("inf")},
        "record": {"frames": int(sum(len(r[0]) for r in done)), "frames_delivered": delivered, "microbatches": after - before,
                   "images_per_frame": views, "window_s": ctx.seconds},
        "numbers": {"answer_gap_deg": float(gaps.max()), "answer_gap_p99_deg": float(np.quantile(gaps, 0.99)),
                    "answer_gap_mean_deg": float(gaps.mean()),
                    "answers_over_1deg": float(np.count_nonzero(gaps > OVER_DEG))},
        "attempted": len(done), "failed": failed, "memory_peak_bytes": peak,
    }
