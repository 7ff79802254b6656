"""Train-mode BatchNorm with fused residual add and ReLU (port of
``rot_mvgaze_tpu/ops/batchnorm.py``).

Four passes over ``x`` viewed as ``(rows, C)`` with C contiguous, which is
an ``(N, C, H, W)`` tensor in ``torch.channels_last`` layout, the backbone's
(``rows = N*H*W``):

    forward   bn_stats        mean, var (biased), rstd, a = scale*rstd, b = bias - mean*a
              bn_apply        y = act(x*a + b [+ res])
    backward  bn_bwd_reduce   dscale = Σg'x̂, dbias = Σg', scale*rstd, Σg'/N, Σg'x̂/N
              bn_bwd_dx       dx = scale*rstd*(g' - Σg'/N - x̂*Σg'x̂/N)
                              [+ (gmean + 2*gvar*(x - mean))/N], dres = g'

with ``g' = g*[y > 0]`` under ReLU (the mask is recomputed from y, never
stored). Two options change the rows the statistics cover (N below):

- ``subsample=k`` ("ghost" statistics, the JAX package's
  ``TorchBatchNorm.stat_subsample``): the first ``B // k`` images' rows, a
  prefix of the (rows, C) view; the output and the gradient still cover
  every row, and rows past the prefix get ``dx = scale*rstd*g'``;
- ``group`` (a ``torch.distributed`` process group):
  the statistics of the global batch, the rank-ordered concatenation of
  every rank's x. bn_stats and bn_bwd_reduce then return their float64
  per-channel sums (``sums=True``), which are all-reduced, and
  ``bn_stats_finish`` / ``bn_bwd_finish`` form the results from them with
  the kernels' own arithmetic. dscale and dbias stay this rank's sums (the
  gradient average over ranks adds them up), as ``SyncBatchNorm`` does.

:func:`fused_batchnorm_act_blocks` takes the batch as blocks on their own
devices (height strips of a spatial mesh, ``parallel/spatial.py``; data
replicas of one process): every block's ``sums=True`` launches, the sums
added on the first block's device (then all-reduced over ``group``), one
finish, each block's apply; the backward likewise. One block is the
one-launch path.

Each wrapper launches its hand-written CUDA kernel
(``csrc/batchnorm.cu``) for a CUDA tensor, counted in ``.launches``, and runs
its plain PyTorch version (``*_reference``) for a CPU tensor. It never falls
back: a CUDA call launches or raises. :func:`fused_batchnorm_act` ties the
four together as a ``torch.autograd.Function`` returning ``(y, mean, var)``.
Statistics, scale and bias are float32; x, res, y and the gradients share
x's dtype (float32 or bfloat16).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch

from rot_mvgaze_tpu_torch.kernels.counters import tile_counters

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # must agree with NT in csrc/batchnorm.cu (checked at load)
# the reductions' threads per block, most lanes and chunks per first-level
# group: must agree with NTR, kMaxReduceLanes and kGroup (checked at load)
_REDUCE_THREADS, _REDUCE_MAX_LANES, REDUCE_GROUP = 128, 8, 16
# at most this many rows go into one block's partial sums
MAX_CHUNK_ROWS = 4096
# blocks per SM the planner aims at: the elementwise kernels (46-54
# registers) over-subscribe for tail balance; bn_bwd_reduce takes one wave of
# fewer blocks than fit an SM (at most 96 registers, 5 fit), so that fewer
# partials are left to add (the fastest over the step's 106 calls in a sweep
# of 3-8 per SM on the H100).
_BLOCKS_PER_SM = 8
# bn_stats takes one wave of as many blocks as its launch bounds fit
# (kStatsMinBlocks in csrc/batchnorm.cu; this may not exceed it, checked at
# load), each thread with 4 rows of 16-byte loads in flight: 6 blocks x 128
# threads x 4 rows x 16 B = 48 KB per SM.
STATS_BLOCKS_PER_SM = 6
BWD_REDUCE_BLOCKS_PER_SM = 4
# bn_bwd_dx: the blocks that fit an SM (its launch bounds) and the rows each
# thread keeps in flight; must agree with kBwdDxMinBlocks and kBwdDxRows in
# csrc/batchnorm.cu (checked at load)
BWD_DX_BLOCKS_PER_SM, BWD_DX_ROWS = 3, 2


# ---------------------------------------------------------------------------
# plain PyTorch versions: the CPU path, and the kernels' oracle on the card.
# They take the kernels' steps in the kernels' order: elementwise math in
# float32 (float64 for float64 inputs) one rounding per op, every sum over
# rows in float64, the per-channel epilogue from the float64 sums. So with
# bf16 inputs a kernel and its plain version agree bit for bit.
# ---------------------------------------------------------------------------


def _acc(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def _rowsum(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float64).sum(0)


def bn_stats_reference(x2, scale, bias, eps):
    """(mean, var, rstd, a, b) of the (rows, C) input; var is biased and
    formed as E[x²] - E[x]², clamped at 0, as the JAX op forms it."""
    xf = x2.to(_acc(x2))
    return _finish_stats(_rowsum(xf), _rowsum(xf * xf), x2.shape[0], _acc(x2), scale, bias, eps)


def _finish_stats(sx, sq, n, acc, scale, bias, eps):
    """bn_stats' per-channel epilogue from the float64 sums over n rows."""
    mean = sx / n
    var = torch.clamp(sq / n - mean * mean, min=0.0)
    rstd = (1.0 / torch.sqrt(var + eps)).to(acc)
    mean, var = mean.to(acc), var.to(acc)
    a = scale.to(acc) * rstd
    b = bias.to(acc) - mean * a
    return mean, var, rstd, a, b


def bn_stats_sums_reference(x2):
    """(2C + 1,) float64: Σx, Σx² (each square rounded in the accumulation
    dtype) and the row count, bn_stats' sums before its epilogue."""
    xf = x2.to(_acc(x2))
    n = torch.tensor([float(x2.shape[0])], dtype=torch.float64, device=x2.device)
    return torch.cat([_rowsum(xf), _rowsum(xf * xf), n])


def bn_stats_finish_reference(sums, scale, bias, eps):
    """bn_stats' (mean, var, rstd, a, b), float32 (float64 for float64
    ``scale``), from (reduced) sums of :func:`bn_stats_sums_reference`'s
    layout."""
    c = scale.shape[0]
    return _finish_stats(sums[:c], sums[c:2 * c], float(sums[2 * c]), _acc(scale), scale, bias, eps)


def bn_apply_reference(x2, a, b, res2, relu):
    """y = act(x*a + b [+ res]) in the accumulation dtype, rounded to x's."""
    y = x2.to(_acc(x2)) * a + b
    if res2 is not None:
        y = y + res2.to(y.dtype)
    if relu:
        y = torch.relu(y)
    return y.to(x2.dtype)


def _masked_grad(g2, y2, relu):
    g = g2.to(_acc(g2))
    return torch.where(y2 > 0, g, torch.zeros_like(g)) if relu else g


def bn_bwd_reduce_reference(g2, y2, x2, mean, rstd, scale, relu, count=None, sums=False):
    """(dscale, dbias, scale*rstd, Σg'/N, Σg'x̂/N), the sums over every row
    and N = ``count`` (default: the rows). ``sums=True``: (dscale, dbias,
    scale*rstd, (2C,) float64 Σg', Σg'x̂) instead."""
    g = _masked_grad(g2, y2, relu)
    xhat = (x2.to(g.dtype) - mean) * rstd
    n = x2.shape[0] if count is None else count
    sg = _rowsum(g)
    sgx = _rowsum(g * xhat)
    head = (sgx.to(g.dtype), sg.to(g.dtype), scale.to(g.dtype) * rstd)
    if sums:
        return head + (torch.cat([sg, sgx]),)
    return head + ((sg / n).to(g.dtype), (sgx / n).to(g.dtype))


def bn_bwd_finish_reference(sums, count):
    """(Σg'/N, Σg'x̂/N), float32, from (reduced) sums of
    :func:`bn_bwd_reduce_reference`'s ``sums=True`` layout and the
    forward's sums (their last entry is N)."""
    c = sums.shape[0] // 2
    n = float(count[-1])
    return (sums[:c] / n).to(torch.float32), (sums[c:] / n).to(torch.float32)


def bn_bwd_dx_reference(g2, y2, x2, mean, rstd, k, mg, mgx, gmean, gvar, relu, want_dres,
                        stat_rows=None, count=None):
    """(dx, dres): dres is g' when ``want_dres`` (ReLU with a residual), else
    None. ``gmean``/``gvar`` are the cotangents of the returned statistics,
    or None, divided by ``count`` (default: the rows). Rows from
    ``stat_rows`` on (default: none) get k*g' alone."""
    g = _masked_grad(g2, y2, relu)
    xc = x2.to(g.dtype) - mean
    dx = k * (g - mg - xc * rstd * mgx)
    n = x2.shape[0] if count is None else count
    if gmean is not None:
        dx = dx + gmean.to(g.dtype) / n
    if gvar is not None:
        dx = dx + gvar.to(g.dtype) * 2.0 * xc / n
    if stat_rows is not None and stat_rows < x2.shape[0]:
        dx[stat_rows:] = k * g[stat_rows:]
    dres = g.to(g2.dtype) if want_dres else None
    return dx.to(x2.dtype), dres


# ---------------------------------------------------------------------------
# launch plan and library
# ---------------------------------------------------------------------------


def plan(
    rows: int, c: int, itemsize: int, n_sm: int, blocks_per_sm: int = _BLOCKS_PER_SM
) -> Tuple[int, int, int, int]:
    """Launch plan ``(lanes, chunk_rows, chunks, tiles)`` of a (rows, C) pass.

    A thread owns 16 bytes of channels; ``lanes`` threads (a power of two, at
    most 32) span a channel tile and the block's other threads walk rows.
    Rows are split into ``chunks`` so that about ``blocks_per_sm`` blocks per
    SM exist over all tiles, with at most ``MAX_CHUNK_ROWS`` rows per chunk.
    At the stem (802,816 x 64 bf16, 132 SMs, 8 blocks per SM): 8 lanes, 1
    tile, 1,046 chunks of 768 rows."""
    v = 16 // itemsize
    lanes = min(32, 1 << max(0, math.ceil(math.log2(math.ceil(c / v)))))
    rstep = _THREADS // lanes
    tiles = math.ceil(c / (lanes * v))
    want = max(1, math.ceil(blocks_per_sm * n_sm / tiles), math.ceil(rows / MAX_CHUNK_ROWS))
    chunks = max(1, min(want, math.ceil(rows / rstep)))
    chunk_rows = math.ceil(math.ceil(rows / chunks) / rstep) * rstep
    return lanes, chunk_rows, math.ceil(rows / chunk_rows), tiles


def plan_dx(rows: int, c: int, itemsize: int, n_sm: int) -> Tuple[int, int, int, int]:
    """Launch plan ``(lanes, chunk_rows, chunks, tiles)`` of bn_bwd_dx: one
    wave of persistent blocks.

    Lanes and tiles as :func:`plan`. ``chunks`` per tile is as many as fit
    one wave of ``BWD_DX_BLOCKS_PER_SM`` blocks per SM over all tiles (at
    least one), and ``chunk_rows`` a multiple of the rows one pass of the
    block covers (``BWD_DX_ROWS`` rows per thread), so that every thread
    walks the same number of rows. At the stem (802,816 x 64 bf16, 132
    SMs): 8 lanes, 1 tile, 392 chunks of 2,048 rows; at layer 4's
    downsample (3,136 x 2,048): 32 lanes, 8 tiles, 49 chunks of 64 rows."""
    v = 16 // itemsize
    lanes = min(32, 1 << max(0, math.ceil(math.log2(math.ceil(c / v)))))
    step = _THREADS // lanes * BWD_DX_ROWS
    tiles = math.ceil(c / (lanes * v))
    chunks = max(1, min(BWD_DX_BLOCKS_PER_SM * n_sm // tiles, math.ceil(rows / step)))
    chunk_rows = math.ceil(math.ceil(rows / chunks) / step) * step
    return lanes, chunk_rows, math.ceil(rows / chunk_rows), tiles


def plan_reduce(
    rows: int, c: int, itemsize: int, n_sm: int, blocks_per_sm: int
) -> Tuple[int, int, int, int, int]:
    """Launch plan ``(lanes, chunk_rows, chunks, tiles, groups)`` of a
    reduction (bn_stats, bn_bwd_reduce) over (rows, C).

    As :func:`plan`, with 128-thread blocks, at most 8 lanes (a channel tile
    of at most 64 bf16 or 32 f32 channels), and one wave of about
    ``blocks_per_sm`` blocks per SM over all tiles; the chunks' partials are
    summed in ``groups`` of 16. At the stem (802,816 x 64 bf16, 132 SMs, 4
    blocks per SM): 8 lanes, 1 tile, 523 chunks of 1,536 rows in 33 groups."""
    v = 16 // itemsize
    lanes = min(_REDUCE_MAX_LANES, 1 << max(0, math.ceil(math.log2(math.ceil(c / v)))))
    rstep = _REDUCE_THREADS // lanes
    tiles = math.ceil(c / (lanes * v))
    want = max(1, math.ceil(blocks_per_sm * n_sm / tiles), math.ceil(rows / MAX_CHUNK_ROWS))
    chunks = max(1, min(want, math.ceil(rows / rstep)))
    chunk_rows = math.ceil(math.ceil(rows / chunks) / rstep) * rstep
    chunks = math.ceil(rows / chunk_rows)
    return lanes, chunk_rows, chunks, tiles, math.ceil(chunks / REDUCE_GROUP)


@functools.cache
def _lib():
    from rot_mvgaze_tpu_torch.kernels.build import library

    lib = library()
    lib.mvgaze_bn_threads.argtypes = []
    lib.mvgaze_bn_threads.restype = ctypes.c_int
    if lib.mvgaze_bn_threads() != _THREADS:
        raise RuntimeError(
            f"csrc/batchnorm.cu runs {lib.mvgaze_bn_threads()} threads per block, "
            f"ops/batchnorm.py plans for {_THREADS}"
        )
    cfg = [ctypes.c_int() for _ in range(3)]
    lib.mvgaze_bn_reduce_config.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.mvgaze_bn_reduce_config.restype = ctypes.c_int
    lib.mvgaze_bn_reduce_config(*map(ctypes.byref, cfg))
    want = (_REDUCE_THREADS, _REDUCE_MAX_LANES, REDUCE_GROUP)
    if tuple(v.value for v in cfg) != want:
        raise RuntimeError(
            f"csrc/batchnorm.cu reductions {[v.value for v in cfg]} != ops/batchnorm.py's {want}"
        )
    dx_cfg = [ctypes.c_int() for _ in range(2)]
    lib.mvgaze_bn_bwd_dx_config.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.mvgaze_bn_bwd_dx_config.restype = ctypes.c_int
    lib.mvgaze_bn_bwd_dx_config(*map(ctypes.byref, dx_cfg))
    if tuple(v.value for v in dx_cfg) != (BWD_DX_BLOCKS_PER_SM, BWD_DX_ROWS):
        raise RuntimeError(
            f"csrc/batchnorm.cu bn_bwd_dx {[v.value for v in dx_cfg]} != ops/batchnorm.py's "
            f"{(BWD_DX_BLOCKS_PER_SM, BWD_DX_ROWS)}"
        )
    stats_fit = ctypes.c_int()
    lib.mvgaze_bn_stats_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.mvgaze_bn_stats_config.restype = ctypes.c_int
    lib.mvgaze_bn_stats_config(ctypes.byref(stats_fit))
    if STATS_BLOCKS_PER_SM > stats_fit.value:
        raise RuntimeError(
            f"ops/batchnorm.py plans {STATS_BLOCKS_PER_SM} bn_stats blocks per SM, "
            f"csrc/batchnorm.cu fits {stats_fit.value}"
        )
    p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    shape = [ll, i, i, ll, i, i]  # rows, C, lanes, chunk_rows, chunks, vec
    signatures = {
        "mvgaze_bn_stats": [i] + [p] * 11 + shape + [i, d, p],
        "mvgaze_bn_stats_finish": [p] * 8 + [i, d, p],
        "mvgaze_bn_apply": [i] + [p] * 5 + shape + [i, p],
        "mvgaze_bn_bwd_reduce": [i] + [p] * 14 + [d] + shape + [i, i, p],
        "mvgaze_bn_bwd_finish": [p] * 4 + [i, p],
        "mvgaze_bn_bwd_dx": [i] + [p] * 12 + [ll, d] + shape + [i, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(
            f"{name} must match x: {tuple(like.shape)} {like.dtype} on {like.device}; got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (rows, C) view")


def _check_vectors(x2: torch.Tensor, **vectors: Optional[torch.Tensor]) -> None:
    c = x2.shape[1]
    for name, v in vectors.items():
        if v is None:
            continue
        if v.shape != (c,) or v.dtype != torch.float32 or v.device != x2.device:
            raise ValueError(
                f"{name} must be float32 ({c},) on {x2.device}; got "
                f"{tuple(v.shape)} {v.dtype} on {v.device}"
            )
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_setup(x2: torch.Tensor, *rows: Optional[torch.Tensor], reduce: int = 0,
                  dx: bool = False):
    """Checks and launch arguments shared by the four wrappers: ``(shape,
    tiles, chunks, groups)`` (``groups`` 0 for the elementwise passes), or
    None for a CPU tensor (the caller then runs the plain version).
    ``reduce`` is a reduction's blocks per SM, 0 for an elementwise pass;
    ``dx`` takes bn_bwd_dx's one-wave plan (:func:`plan_dx`)."""
    if x2.dim() != 2 or x2.shape[0] == 0 or x2.shape[1] == 0:
        raise ValueError(f"x must be a non-empty (rows, C) view, got {tuple(x2.shape)}")
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x2.dtype}")
    if not x2.is_contiguous():
        raise ValueError("x must be a contiguous (rows, C) view")
    if x2.device.type == "cpu":
        return None
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    n_sm = torch.cuda.get_device_properties(x2.device).multi_processor_count
    rows_, c = x2.shape
    if reduce:
        lanes, chunk_rows, chunks, tiles, groups = plan_reduce(
            rows_, c, x2.element_size(), n_sm, reduce
        )
    else:
        planner = plan_dx if dx else plan
        lanes, chunk_rows, chunks, tiles = planner(rows_, c, x2.element_size(), n_sm)
        groups = 0
    v = 16 // x2.element_size()
    tensors = (x2,) + tuple(t for t in rows if t is not None)
    vec = int(c % v == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))
    shape = [rows_, c, lanes, chunk_rows, chunks, vec]
    return shape, tiles, chunks, groups


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


# ---------------------------------------------------------------------------
# wrappers: the kernel for a CUDA tensor, the plain version for a CPU one
# ---------------------------------------------------------------------------


def bn_stats(x2, scale, bias, eps, sums=False):
    """(mean, var, rstd, a, b), each float32 (C,), of the (rows, C) x; with
    ``sums=True`` instead the (2C + 1,) float64 sums Σx, Σx² and the row
    count (``bn_stats_sums_reference``'s layout), for
    :func:`bn_stats_finish` after an all-reduce."""
    _check_vectors(x2, scale=scale, bias=bias)
    setup = _launch_setup(x2, reduce=STATS_BLOCKS_PER_SM)
    if setup is None:
        if sums:
            return bn_stats_sums_reference(x2)
        return bn_stats_reference(x2, scale, bias, eps)
    shape, tiles, chunks, groups = setup
    c = x2.shape[1]
    if sums:
        outs = [None] * 5
        out_sums = torch.empty(2 * c + 1, dtype=torch.float64, device=x2.device)
    else:
        outs = [torch.empty(c, dtype=torch.float32, device=x2.device) for _ in range(5)]
        out_sums = None
    ws = torch.empty(2 * (chunks + groups) * c, dtype=torch.float64, device=x2.device)
    counters = tile_counters(x2.device, tiles * (groups + 1))
    with torch.cuda.device(x2.device):
        err = _lib().mvgaze_bn_stats(
            _DTYPE_CODES[x2.dtype], x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            ws.data_ptr(), counters.data_ptr(), *map(_ptr, outs), _ptr(out_sums), *shape, groups,
            float(eps), torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _raise_on(err, "bn_stats")
    bn_stats.launches += 1
    return out_sums if sums else tuple(outs)


def bn_stats_finish(sums, scale, bias, eps):
    """bn_stats' (mean, var, rstd, a, b), each float32 (C,), from (2C + 1,)
    float64 sums (Σx, Σx², rows; all-reduced over ranks), with the
    kernel's own epilogue. Counted in ``bn_stats.finish_launches``."""
    c = scale.shape[0]
    if sums.shape != (2 * c + 1,) or sums.dtype != torch.float64 or not sums.is_contiguous():
        raise ValueError(f"sums must be contiguous float64 ({2 * c + 1},), got "
                         f"{tuple(sums.shape)} {sums.dtype}")
    _check_vectors(sums.new_empty((1, c), dtype=torch.float32), scale=scale, bias=bias)
    if sums.device.type == "cpu":
        return bn_stats_finish_reference(sums, scale, bias, eps)
    if sums.device.type != "cuda":
        raise ValueError(f"unsupported device {sums.device}")
    outs = [torch.empty(c, dtype=torch.float32, device=sums.device) for _ in range(5)]
    with torch.cuda.device(sums.device):
        err = _lib().mvgaze_bn_stats_finish(
            sums.data_ptr(), scale.data_ptr(), bias.data_ptr(), *map(_ptr, outs), c, float(eps),
            torch.cuda.current_stream(sums.device).cuda_stream,
        )
    _raise_on(err, "bn_stats_finish")
    bn_stats.finish_launches += 1
    return tuple(outs)


def bn_apply(x2, a, b, res2, relu):
    """y = act(x*a + b [+ res]) over (rows, C), in x's dtype."""
    _check_vectors(x2, a=a, b=b)
    if res2 is not None:
        _check_rows("res", res2, x2)
    setup = _launch_setup(x2, res2)
    if setup is None:
        return bn_apply_reference(x2, a, b, res2, relu)
    shape = setup[0]
    y2 = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        err = _lib().mvgaze_bn_apply(
            _DTYPE_CODES[x2.dtype], x2.data_ptr(), _ptr(res2), a.data_ptr(), b.data_ptr(),
            y2.data_ptr(), *shape, int(relu),
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _raise_on(err, "bn_apply")
    bn_apply.launches += 1
    return y2


def bn_bwd_reduce(g2, y2, x2, mean, rstd, scale, relu, count=None, sums=False):
    """(dscale, dbias, scale*rstd, Σg'/N, Σg'x̂/N), each float32 (C,): the
    sums over every row, N = ``count`` (default: the rows; a prefix's rows
    under ``subsample``). ``sums=True``: (dscale, dbias, scale*rstd, (2C,)
    float64 Σg', Σg'x̂) for :func:`bn_bwd_finish` after an all-reduce.
    ``y2`` is read only when ``relu``."""
    _check_rows("g", g2, x2)
    if relu:
        _check_rows("y", y2, x2)
    _check_vectors(x2, mean=mean, rstd=rstd, scale=scale)
    count = x2.shape[0] if count is None else count
    if count <= 0:
        raise ValueError(f"count must be positive, got {count}")
    setup = _launch_setup(x2, g2, y2 if relu else None, reduce=BWD_REDUCE_BLOCKS_PER_SM)
    if setup is None:
        return bn_bwd_reduce_reference(g2, y2, x2, mean, rstd, scale, relu, count, sums)
    shape, tiles, chunks, groups = setup
    c = x2.shape[1]
    outs = [torch.empty(c, dtype=torch.float32, device=x2.device) for _ in range(3 if sums else 5)]
    out_sums = torch.empty(2 * c, dtype=torch.float64, device=x2.device) if sums else None
    ws = torch.empty(2 * (chunks + groups) * c, dtype=torch.float64, device=x2.device)
    counters = tile_counters(x2.device, tiles * (groups + 1))
    with torch.cuda.device(x2.device):
        err = _lib().mvgaze_bn_bwd_reduce(
            _DTYPE_CODES[x2.dtype], g2.data_ptr(), _ptr(y2) if relu else None, x2.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), *map(_ptr, outs + [None] * (5 - len(outs))), _ptr(out_sums),
            float(count), *shape, groups, int(relu),
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _raise_on(err, "bn_bwd_reduce")
    bn_bwd_reduce.launches += 1
    return tuple(outs) + ((out_sums,) if sums else ())


def bn_bwd_finish(sums, count):
    """(Σg'/N, Σg'x̂/N), each float32 (C,), from (2C,) float64 sums (Σg',
    Σg'x̂; all-reduced over ranks) and the forward's (2C + 1,) sums, whose
    last entry is N, with the kernel's own epilogue. Counted in
    ``bn_bwd_reduce.finish_launches``."""
    c = sums.shape[0] // 2
    for name, t, n in (("sums", sums, 2 * c), ("count", count, 2 * c + 1)):
        if t.shape != (n,) or t.dtype != torch.float64 or not t.is_contiguous() or t.device != sums.device:
            raise ValueError(f"{name} must be contiguous float64 ({n},) on {sums.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if sums.device.type == "cpu":
        return bn_bwd_finish_reference(sums, count)
    if sums.device.type != "cuda":
        raise ValueError(f"unsupported device {sums.device}")
    mg, mgx = (torch.empty(c, dtype=torch.float32, device=sums.device) for _ in range(2))
    with torch.cuda.device(sums.device):
        err = _lib().mvgaze_bn_bwd_finish(
            sums.data_ptr(), count[2 * c:].data_ptr(), mg.data_ptr(), mgx.data_ptr(), c,
            torch.cuda.current_stream(sums.device).cuda_stream,
        )
    _raise_on(err, "bn_bwd_finish")
    bn_bwd_reduce.finish_launches += 1
    return mg, mgx


def bn_bwd_dx(g2, y2, x2, mean, rstd, k, mg, mgx, gmean, gvar, relu, want_dres,
              stat_rows=None, count=None):
    """(dx, dres) over (rows, C) in x's dtype; dres (= g') only when
    ``want_dres``, which needs ``relu`` (without ReLU the residual's
    gradient is g itself). The statistics terms apply to rows below
    ``stat_rows`` (default: every row; the others get k*g'), gmean and gvar
    divided by ``count`` (default: the rows)."""
    if want_dres and not relu:
        raise ValueError("want_dres needs relu: without it dres is g")
    _check_rows("g", g2, x2)
    if relu:
        _check_rows("y", y2, x2)
    _check_vectors(x2, mean=mean, rstd=rstd, k=k, mg=mg, mgx=mgx, gmean=gmean, gvar=gvar)
    rows = x2.shape[0]
    stat_rows = rows if stat_rows is None else stat_rows
    count = rows if count is None else count
    if not 0 <= stat_rows <= rows or count <= 0:
        raise ValueError(f"need 0 <= stat_rows <= {rows} and count > 0, got {stat_rows}, {count}")
    setup = _launch_setup(x2, g2, y2 if relu else None, dx=True)
    if setup is None:
        return bn_bwd_dx_reference(
            g2, y2, x2, mean, rstd, k, mg, mgx, gmean, gvar, relu, want_dres, stat_rows, count
        )
    shape = setup[0]
    dx = torch.empty_like(x2)
    dres = torch.empty_like(g2) if want_dres else None
    with torch.cuda.device(x2.device):
        err = _lib().mvgaze_bn_bwd_dx(
            _DTYPE_CODES[x2.dtype], g2.data_ptr(), _ptr(y2) if relu else None, x2.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), k.data_ptr(), mg.data_ptr(), mgx.data_ptr(),
            _ptr(gmean), _ptr(gvar), dx.data_ptr(), _ptr(dres), stat_rows, float(count), *shape,
            int(relu), torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _raise_on(err, "bn_bwd_dx")
    bn_bwd_dx.launches += 1
    return dx, dres


bn_stats.launches = 0
bn_apply.launches = 0
bn_bwd_reduce.launches = 0
bn_bwd_dx.launches = 0
# the finish kernels of the statistics over several ranks (csrc/batchnorm.cu's
# bn_stats_finish and bn_bwd_finish), counted beside the kernel they finish
bn_stats.finish_launches = 0
bn_bwd_reduce.finish_launches = 0
KERNELS = (bn_stats, bn_apply, bn_bwd_reduce, bn_bwd_dx)


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------


def _channels_last(t: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """``t`` in channels_last layout, and whether that took a copy."""
    if t.is_contiguous(memory_format=torch.channels_last):
        return t, False
    return t.contiguous(memory_format=torch.channels_last), True


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) channels_last -> its (N*H*W, C) view (no copy)."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def stat_rows(n: int, hw: int, subsample: int = 1, group=None) -> Tuple[int, int]:
    """``(count, local)``: the rows the statistics cover over the whole
    (global) batch, and how many of them are this rank's, a prefix of its
    (n*hw, C) view. The batch is n images of hw rows on each rank of
    ``group`` (None: one process), concatenated in rank order; ``subsample``
    k keeps its first ``B // k`` images, so rank r holds ``clamp(B//k -
    r*n, 0, n)`` of them, which may be none. A batch of ``B < 2k`` images
    raises, as the JAX package's ``TorchBatchNorm`` does."""
    if subsample < 1:
        raise ValueError(f"subsample must be >= 1, got {subsample}")
    world, rank = (1, 0) if group is None else (group.size(), group.rank())
    total = world * n
    if subsample > 1 and total < 2 * subsample:
        raise ValueError(f"stat_subsample={subsample} leaves <2 of {total} batch rows")
    prefix = total // subsample
    return prefix * hw, min(max(prefix - rank * n, 0), n) * hw


class _FusedBatchNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, residual, eps, relu, subsample, group):
        # autocast off: the op sets its dtypes at its own boundary
        with torch.autocast(x.device.type, enabled=False):
            x = x.contiguous(memory_format=torch.channels_last)
            res2 = None
            if residual is not None:
                res2 = _rows(residual.contiguous(memory_format=torch.channels_last))
            x2 = _rows(x)
            count, local = stat_rows(x.shape[0], x.shape[2] * x.shape[3], subsample, group)
            xs = x2 if local == x2.shape[0] else x2[:local]
            sums = None
            if group is None:
                mean, var, rstd, a, b = bn_stats(xs, scale, bias, eps)
            else:
                if local:
                    sums = bn_stats(xs, scale, bias, eps, sums=True)
                else:  # none of the global prefix is this rank's
                    sums = x2.new_zeros(2 * x2.shape[1] + 1, dtype=torch.float64)
                torch.distributed.all_reduce(sums, group=group)
                mean, var, rstd, a, b = bn_stats_finish(sums, scale, bias, eps)
            y2 = bn_apply(x2, a, b, res2, relu)
        y = y2.reshape(x.shape[0], x.shape[2], x.shape[3], x.shape[1]).permute(0, 3, 1, 2)
        ctx.set_materialize_grads(False)
        ctx.relu = relu
        ctx.has_res = residual is not None
        ctx.count, ctx.local, ctx.group = count, local, group
        ctx.save_for_backward(x, scale, y if relu else None, mean, rstd, sums)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, gmean, gvar):
        x, scale, y, mean, rstd, sums = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            if g is None:
                g = torch.zeros_like(x, memory_format=torch.channels_last)
            g, copied = _channels_last(g)
            fused_batchnorm_act.grad_copies += int(copied)
            if g.dtype != x.dtype:
                raise TypeError(f"the gradient of y is {g.dtype}, y is {x.dtype}")
            x2, g2 = _rows(x), _rows(g)
            y2 = _rows(y) if ctx.relu else None
            if ctx.group is None:
                dscale, dbias, k, mg, mgx = bn_bwd_reduce(
                    g2, y2, x2, mean, rstd, scale, ctx.relu, count=ctx.count
                )
            else:
                # Σg' and Σg'x̂ of the global batch; dscale and dbias stay
                # this rank's (the gradient average adds them up)
                dscale, dbias, k, gsums = bn_bwd_reduce(
                    g2, y2, x2, mean, rstd, scale, ctx.relu, count=ctx.count, sums=True
                )
                torch.distributed.all_reduce(gsums, group=ctx.group)
                mg, mgx = bn_bwd_finish(gsums, sums)
                # each rank's cotangent of the global statistics reaches every rank's x
                gmean, gvar = (None if t is None else _all_reduced(t, ctx.group) for t in (gmean, gvar))
            want_dres = ctx.has_res and ctx.relu
            dx2, dres2 = bn_bwd_dx(
                g2, y2, x2, mean, rstd, k, mg, mgx, gmean, gvar, ctx.relu, want_dres,
                stat_rows=ctx.local, count=ctx.count,
            )
        n, c, h, w = x.shape
        dx = dx2.reshape(n, h, w, c).permute(0, 3, 1, 2)
        dres = None
        if ctx.has_res:
            dres = dres2.reshape(n, h, w, c).permute(0, 3, 1, 2) if want_dres else g
        return dx, dscale.to(scale.dtype), dbias, dres, None, None, None, None


def _all_reduced(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    torch.distributed.all_reduce(t, group=group)
    return t


def fused_batchnorm_act(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    relu: bool = True,
    subsample: int = 1,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BatchNorm over (N, H, W) of an (N, C, H, W) ``x``, with
    an optional residual added before an optional ReLU.

    Returns ``(y, batch_mean, batch_var)``: y in x's dtype and in
    channels_last layout, the statistics float32 with the variance biased.
    ``x`` and ``residual`` (same shape and dtype) should be channels_last;
    any other layout is copied into it, and so is a gradient that arrives in
    another layout, counted in ``.grad_copies``. ``scale``
    and ``bias`` are float32 (C,). Differentiable in x, scale, bias,
    residual, and through the returned statistics.

    ``subsample`` k takes the statistics from the batch's first ``B // k``
    images (:func:`stat_rows`). ``group``: a ``torch.distributed`` process
    group; the statistics are the global batch's (each rank passes its own
    x), through the kernels' sums, an all-reduce and the finish kernels,
    for a group of one rank too. None keeps them local (one launch each)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError(
            f"residual must match x ({tuple(x.shape)}, {x.dtype}); got "
            f"{tuple(residual.shape)}, {residual.dtype}"
        )
    return _FusedBatchNormAct.apply(x, scale, bias, residual, eps, relu, subsample, group)


fused_batchnorm_act.grad_copies = 0


def sharded_stat_rows(n: int, heights: Sequence[Sequence[int]], width: int, subsample: int = 1,
                      group=None) -> Tuple[int, List[List[int]]]:
    """``(count, local)`` of :func:`stat_rows` for a batch held as blocks:
    ``heights[d][s]`` is the height of data replica d's strip s, each
    replica ``n`` images of ``width`` columns. The global batch is the
    ranks' batches in rank order, each rank's its replicas' in order; the
    ``subsample`` prefix is its first ``B // k`` images, which on every
    strip are the same images' rows: ``local[d][s]`` rows of block (d, s),
    a prefix of its (n*h*w, C) view."""
    if subsample < 1:
        raise ValueError(f"subsample must be >= 1, got {subsample}")
    world, rank = (1, 0) if group is None else (group.size(), group.rank())
    reps = len(heights)
    total = world * reps * n
    if subsample > 1 and total < 2 * subsample:
        raise ValueError(f"stat_subsample={subsample} leaves <2 of {total} batch rows")
    prefix = total // subsample
    count = prefix * sum(heights[0]) * width
    local = [[min(max(prefix - (rank * reps + d) * n, 0), n) * h * width for h in hs]
             for d, hs in enumerate(heights)]
    return count, local


class _FusedBatchNormActBlocks(torch.autograd.Function):
    """:class:`_FusedBatchNormAct` over blocks on their own devices: each
    block's float64 sums, added on the first block's device (and all-reduced
    over ``group``), one finish, then each block's apply; the backward
    likewise through bn_bwd_reduce's sums, bn_bwd_finish and each block's
    bn_bwd_dx. ``tensors`` is the blocks' x, then their residuals."""

    @staticmethod
    def forward(ctx, spec, scale, bias, *tensors):
        m, has_res, eps, relu, local, count, group = spec
        with torch.autocast(scale.device.type, enabled=False):
            xs = [t.contiguous(memory_format=torch.channels_last) for t in tensors[:m]]
            res = ([_rows(t.contiguous(memory_format=torch.channels_last)) for t in tensors[m:]]
                   if has_res else [None] * m)
            c = scale.shape[0]
            total = None
            for x, rows in zip(xs, local):
                x2 = _rows(x)
                if rows:
                    part = bn_stats(x2 if rows == x2.shape[0] else x2[:rows], scale.to(x.device),
                                    bias.to(x.device), eps, sums=True)
                else:  # none of the prefix is this block's
                    part = x2.new_zeros(2 * c + 1, dtype=torch.float64)
                part = part.to(scale.device)
                total = part if total is None else total + part
            if group is not None:
                torch.distributed.all_reduce(total, group=group)
            mean, var, rstd, a, b = bn_stats_finish(total, scale, bias, eps)
            ys = []
            for x, r2 in zip(xs, res):
                n_, c_, h, w = x.shape
                y2 = bn_apply(_rows(x), a.to(x.device), b.to(x.device), r2, relu)
                ys.append(y2.reshape(n_, h, w, c_).permute(0, 3, 1, 2))
        ctx.set_materialize_grads(False)
        ctx.spec = spec
        ctx.save_for_backward(scale, mean, rstd, total, *xs, *(ys if relu else ()))
        return (*ys, mean, var)

    @staticmethod
    def backward(ctx, *grads):
        m, has_res, eps, relu, local, count, group = ctx.spec
        saved = ctx.saved_tensors  # unpacked once (remat's recompute hooks allow no more)
        scale, mean, rstd, total = saved[:4]
        xs = saved[4:4 + m]
        ys = saved[4 + m:] if relu else [None] * m
        gmean, gvar = grads[m], grads[m + 1]
        dev0 = scale.device
        with torch.autocast(dev0.type, enabled=False):
            gs, ks, parts = [], [], []
            for x, y, g in zip(xs, ys, grads[:m]):
                if g is None:
                    g = torch.zeros_like(x, memory_format=torch.channels_last)
                g, copied = _channels_last(g)
                fused_batchnorm_act.grad_copies += int(copied)
                if g.dtype != x.dtype:
                    raise TypeError(f"the gradient of y is {g.dtype}, y is {x.dtype}")
                gs.append(g)
                dev = x.device
                _, _, k, gsums = bn_bwd_reduce(_rows(g), _rows(y) if relu else None, _rows(x), mean.to(dev),
                                               rstd.to(dev), scale.to(dev), relu, count=count, sums=True)
                ks.append(k)
                parts.append(gsums.to(dev0))
            mine = functools.reduce(torch.add, parts)
            c = scale.shape[0]
            # dscale and dbias: this process's sums, as one launch over its rows forms them
            dscale, dbias = mine[c:].to(torch.float32), mine[:c].to(torch.float32)
            gtotal = mine
            if group is not None:
                gtotal = mine.clone()
                torch.distributed.all_reduce(gtotal, group=group)
                gmean, gvar = (None if t is None else _all_reduced(t, group) for t in (gmean, gvar))
            mg, mgx = bn_bwd_finish(gtotal, total)
            want_dres = has_res and relu
            dxs, dres = [], []
            for x, y, g, k, rows in zip(xs, ys, gs, ks, local):
                dev = x.device
                n_, c_, h, w = x.shape
                dx2, dres2 = bn_bwd_dx(
                    _rows(g), _rows(y) if relu else None, _rows(x), mean.to(dev), rstd.to(dev),
                    k, mg.to(dev), mgx.to(dev),
                    None if gmean is None else gmean.to(dev), None if gvar is None else gvar.to(dev),
                    relu, want_dres, stat_rows=rows, count=count,
                )
                dxs.append(dx2.reshape(n_, h, w, c_).permute(0, 3, 1, 2))
                if has_res:
                    dres.append(dres2.reshape(n_, h, w, c_).permute(0, 3, 1, 2) if want_dres else g)
        return (None, dscale.to(scale.dtype), dbias, *dxs, *dres)


def fused_batchnorm_act_blocks(
    xs: Sequence[Sequence[torch.Tensor]],
    scale: torch.Tensor,
    bias: torch.Tensor,
    residuals: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    eps: float = 1e-5,
    relu: bool = True,
    subsample: int = 1,
    group=None,
) -> Tuple[List[List[torch.Tensor]], torch.Tensor, torch.Tensor, int]:
    """:func:`fused_batchnorm_act` over a batch held as blocks:
    ``xs[d][s]`` (N, C, h, W) is data replica d's height strip s, on its own
    device (``parallel/spatial.py``); ``scale`` and ``bias`` live on the
    first block's device. The statistics are those of the whole batch (and
    of ``group``'s, with the ranks' batches): every block runs bn_stats'
    sums, added in-process on the first device, all-reduced over ``group``
    when there is one, then bn_stats_finish; bn_apply runs on each block.
    The backward runs bn_bwd_reduce's sums on each block, bn_bwd_finish and
    each block's bn_bwd_dx. ``subsample`` k: the first ``B // k`` images of
    the global batch (:func:`sharded_stat_rows`). A single block is the
    one-block path itself (:func:`fused_batchnorm_act`), bit for bit.

    Returns ``(ys, batch_mean, batch_var, count)``: ys in the blocks'
    layout, the statistics float32 on the first device, ``count`` the rows
    they cover."""
    heights = [[t.shape[2] for t in row] for row in xs]
    first = xs[0][0]
    count, local = sharded_stat_rows(first.shape[0], heights, first.shape[3], subsample, group)
    for row in xs:
        for t in row:
            if t.dim() != 4 or t.shape[0] != first.shape[0] or t.shape[1] != first.shape[1] \
                    or t.shape[3] != first.shape[3] or t.dtype != first.dtype:
                raise ValueError(f"blocks must share N, C, W and dtype: {tuple(t.shape)} {t.dtype} "
                                 f"against {tuple(first.shape)} {first.dtype}")
    flat = [t for row in xs for t in row]
    flat_res = None if residuals is None else [t for row in residuals for t in row]
    if len(flat) == 1:
        y, mean, var = fused_batchnorm_act(flat[0], scale, bias, None if flat_res is None else flat_res[0],
                                           eps, relu, subsample, group)
        return [[y]], mean, var, count
    if flat_res is not None:
        for x, r in zip(flat, flat_res):
            if r.shape != x.shape or r.dtype != x.dtype:
                raise ValueError(f"residual must match x ({tuple(x.shape)}, {x.dtype}); got "
                                 f"{tuple(r.shape)}, {r.dtype}")
    spec = (len(flat), flat_res is not None, eps, relu, [r for row in local for r in row], count, group)
    out = _FusedBatchNormActBlocks.apply(spec, scale, bias, *flat, *(flat_res or ()))
    ys, mean, var = out[:-2], out[-2], out[-1]
    it = iter(ys)
    return [[next(it) for _ in row] for row in xs], mean, var, count
