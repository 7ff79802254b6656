"""Height strips with halo rows (the port's counterpart of the halo
exchanges and gathers that GSPMD inserts for ``rot_mvgaze_tpu``'s 2-D
``(data, spatial)`` mesh).

A :class:`Sharded` activation is a grid of blocks: ``rows[d][s]`` is data
replica d's height strip s, on that strip's device (``parallel/mesh.py``).
The backbone's activations are NCHW views in channels_last layout, each
strip channels_last-contiguous; input images are NHWC (``hdim=1``). A
height axis of ``h`` rows is split as GSPMD splits it: ``ceil(h/n)`` rows
per strip, the remainder in the last (``mesh.split_sizes``).

Each op's output takes the split of its own output height. Output strip
``[o0, o1)`` of a convolution or pooling with kernel ``k``, stride ``s``
and padding ``p`` reads the input rows ``[o0·s − p, (o1−1)·s − p + k)``,
fetched by :func:`fetch_rows` from whichever strips hold them (``.to`` the
output strip's device: the halo copy) and padded past the image's top and
bottom only (zeros for a convolution, −inf for the max-pool); the width
padding is the op's own. Autograd carries the halos' gradients back. The
int8 convolution (:func:`int8_conv_accumulate`) fetches its halo rows
already quantized, one byte per element, with the scale of
:func:`abs_max` over every block.

:func:`floor_check` gathers every group's strips onto its first device
before a stage whose output would leave fewer than 2 rows in a strip (the
JAX backbone's ``spatial_unshard``), and :func:`mean_pool` is the global
average pool: the strips' sums over their first device's, divided by H·W.

Parameters stay where the model keeps them: :func:`on` gives a strip's
device a parameter, through ``.to`` where autograd must carry its gradient
back (training), else from a copy its module keeps per device and tensor
version (serving).
"""

from __future__ import annotations

import functools
import weakref
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from rot_mvgaze_tpu_torch.ops import quant
from rot_mvgaze_tpu_torch.parallel.mesh import min_spatial_shard_rows, split_sizes

_CL = torch.channels_last


class Sharded:
    """An activation held as blocks over a mesh: ``rows[d][s]`` is data
    replica d's height strip s. ``hdim`` is the height axis (2 for NCHW, 1
    for NHWC images). ``shape`` is the global shape: the replicas' batches
    and one replica's strips' heights added up."""

    __slots__ = ("rows", "hdim")

    def __init__(self, rows: Sequence[Sequence[torch.Tensor]], hdim: int = 2) -> None:
        self.rows = [list(r) for r in rows]
        self.hdim = hdim

    @property
    def shape(self) -> torch.Size:
        shape = list(self.rows[0][0].shape)
        shape[0] = sum(r[0].shape[0] for r in self.rows)
        shape[self.hdim] = sum(t.shape[self.hdim] for t in self.rows[0])
        return torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.rows[0][0].dtype

    @property
    def strips(self) -> int:
        return len(self.rows[0])

    def blocks(self) -> List[torch.Tensor]:
        return [t for row in self.rows for t in row]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor], hdim: Any = ...) -> "Sharded":
        return Sharded([[fn(t) for t in row] for row in self.rows], self.hdim if hdim is ... else hdim)

    def map2(self, other: Optional["Sharded"], fn: Callable[..., torch.Tensor]) -> "Sharded":
        """``fn(block, other's block)`` (None for a missing ``other``)."""
        if other is None:
            return self.map(lambda t: fn(t, None))
        return Sharded([[fn(a, b) for a, b in zip(ra, rb)] for ra, rb in zip(self.rows, other.rows)],
                       self.hdim)

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {len(self.rows)} x {self.strips}, "
                f"{[[tuple(t.shape) for t in r] for r in self.rows]})")


# ---------------------------------------------------------------------------
# parameters on a strip's device
# ---------------------------------------------------------------------------

def on(t: Optional[torch.Tensor], device: torch.device, owner: Any = None) -> Optional[torch.Tensor]:
    """``t`` on ``device``: itself where it already is; ``t.to(device)``
    where autograd must carry a gradient back, or without an ``owner``;
    otherwise a copy kept by ``owner`` (the module whose tensor it is), one
    per (tensor, device), refreshed when ``t`` changes in place."""
    if t is None or t.device == device:
        return t
    if owner is None or (torch.is_grad_enabled() and t.requires_grad):
        return t.to(device)
    copies = owner.__dict__.setdefault("_copies_by_device", {})
    key = (id(t), str(device))
    hit = copies.get(key)
    if hit is not None and hit[0]() is t and hit[1] == t._version:
        return hit[2]
    with torch.inference_mode(False), torch.no_grad():
        copy = t.detach().to(device, copy=True)
    copies[key] = (weakref.ref(t), t._version, copy)
    return copy


# ---------------------------------------------------------------------------
# cutting and gathering
# ---------------------------------------------------------------------------


def shard_rows(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x``'s rows (dim 0) split evenly over ``devices``, one block each."""
    d = len(devices)
    if x.shape[0] % d:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over {d} data replicas")
    n = x.shape[0] // d
    return [x[i * n:(i + 1) * n].to(dev) for i, dev in enumerate(devices)]


def shard_images(x: torch.Tensor, grid: Sequence[Sequence[torch.device]]) -> Sharded:
    """(B, H, W, C) images over a mesh grid: rows over the data replicas,
    each replica's height in strips over its group (NHWC blocks, each
    contiguous)."""
    out = []
    for rows, group in zip(shard_rows(x, [g[0] for g in grid]), grid):
        strips, h0 = [], 0
        for dev, h in zip(group, split_sizes(rows.shape[1], len(group))):
            strips.append(rows[:, h0:h0 + h].to(dev).contiguous())
            h0 += h
        out.append(strips)
    return Sharded(out, hdim=1)


def _fill(like: torch.Tensor, rows: int, value: float, device: torch.device) -> torch.Tensor:
    n, c, _, w = like.shape
    return torch.full((n, rows, w, c), value, dtype=like.dtype, device=device).permute(0, 3, 1, 2)


def fetch_rows(row: Sequence[torch.Tensor], lo: int, hi: int, device: torch.device,
               fill: float) -> torch.Tensor:
    """Rows ``[lo, hi)`` of one group's NCHW strips on ``device``
    (channels_last-contiguous): the strips' rows in range, copied from where
    they live, and ``fill`` rows past the top (lo < 0) and bottom (hi > H)."""
    total = sum(t.shape[2] for t in row)
    pieces = []
    if lo < 0:
        pieces.append(_fill(row[0], -lo, fill, device))
    start = 0
    for t in row:
        h = t.shape[2]
        a, b = max(lo, start), min(hi, start + h)
        if a < b:
            pieces.append(t[:, :, a - start:b - start].to(device))
        start += h
    if hi > total:
        pieces.append(_fill(row[0], hi - total, fill, device))
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=2)
    return out.contiguous(memory_format=_CL)


def _windowed(x: Sharded, k: int, s: int, p: int, fill: float,
              op: Callable[[torch.Tensor, torch.device, int], torch.Tensor]) -> Sharded:
    """A sliding-window op over each group's strips: output strip j (GSPMD's
    split of the output height, on input strip j's device) from the input
    rows it reads (the module docstring's range), by ``op(rows, device,
    0)``. A group of one map runs ``op(map, device, p)``, the unsharded op
    with its own height padding."""
    rows = []
    for row in x.rows:
        if len(row) == 1:
            rows.append([op(row[0], row[0].device, p)])
            continue
        total = sum(t.shape[2] for t in row)
        out_h = (total + 2 * p - k) // s + 1
        outs, o0 = [], 0
        for t, n in zip(row, split_sizes(out_h, len(row))):
            o1 = o0 + n
            outs.append(op(fetch_rows(row, o0 * s - p, (o1 - 1) * s - p + k, t.device, fill), t.device, 0))
            o0 = o1
        rows.append(outs)
    return Sharded(rows)


def _square(v: Any, name: str) -> int:
    v = tuple(v) if isinstance(v, (tuple, list)) else (v, v)
    if v[0] != v[1]:
        raise ValueError(f"strips take a square {name}, got {v}")
    return int(v[0])


def conv2d(x: Sharded, weight: torch.Tensor, bias: Optional[torch.Tensor], stride: Any, padding: Any,
           dilation: Any = 1, groups: int = 1, owner: Any = None) -> Sharded:
    """``F.conv2d`` over height strips: zeros above the image and below it,
    the halo rows between strips, the width padding the conv's own.
    ``owner``: the module whose parameters these are (:func:`on`)."""
    if _square(dilation, "dilation") != 1:
        raise ValueError("strips take dilation 1")
    k = _square(weight.shape[2:], "kernel")
    s, p = _square(stride, "stride"), _square(padding, "padding")
    return _windowed(x, k, s, p, 0.0, lambda rows, dev, hp: F.conv2d(
        rows, on(weight, dev, owner), on(bias, dev, owner), (s, s), (hp, p), 1, groups))


def abs_max(x: Sharded) -> torch.Tensor:
    """``max |x|`` over every block of every data replica, float32 on the
    first block's device: the whole array's abs-max (a max is exact, so the
    unsharded array gives the same value)."""
    first = x.rows[0][0].device
    return torch.stack([t.abs().amax().float().to(first) for t in x.blocks()]).amax()


def int8_conv_accumulate(x8: Sharded, w8: torch.Tensor, stride: Any, padding: Any, groups: int = 1,
                         owner: Any = None) -> Sharded:
    """``ops.quant.int8_conv_accumulate`` over height strips of int8
    values: the halo rows fetched as int8, zeros above and below the image
    (int8 zero is the code of 0.0 at any scale), the width padding the
    conv's own; int32 blocks out. ``owner``: as in :func:`conv2d`."""
    k = _square(w8.shape[2:], "kernel")
    s, p = _square(stride, "stride"), _square(padding, "padding")
    return _windowed(x8, k, s, p, 0, lambda rows, dev, hp: quant.int8_conv_accumulate(
        rows, on(w8, dev, owner), (s, s), (hp, p), groups))


def max_pool2d(x: Sharded, kernel_size: Any, stride: Any, padding: Any) -> Sharded:
    """``F.max_pool2d`` over height strips, −inf only above the image and
    below it."""
    k, s, p = _square(kernel_size, "kernel"), _square(stride, "stride"), _square(padding, "padding")
    return _windowed(x, k, s, p, float("-inf"), lambda rows, dev, hp: F.max_pool2d(rows, k, s, (hp, p)))


def gather(x: Sharded) -> Sharded:
    """Every group's strips as one map on the group's first device."""
    return Sharded([[row[0] if len(row) == 1 else torch.cat(
        [t.to(row[0].device) for t in row], dim=2).contiguous(memory_format=_CL)] for row in x.rows])


def _out_height(h: int, total_stride: int) -> int:
    while total_stride > 1:  # each stride-2 site of the backbone: (h - 1) // 2 + 1 rows
        h, total_stride = (h - 1) // 2 + 1, total_stride // 2
    return h


def floor_check(x: Sharded, total_stride: int, n_spatial: int) -> Sharded:
    """The spatial floor before a stage of ``total_stride``: gather the
    strips if its output would leave fewer than 2 rows in any strip, by the
    JAX backbone's measure (``H // total_stride`` over ``n_spatial`` strips)
    or by the stage's own output height (which differs from it only at odd
    heights)."""
    if x.strips == 1:
        return x
    if x.strips != n_spatial:
        raise ValueError(f"the backbone's floor is set for {n_spatial} strips, got {x.strips}")
    h = x.shape[2]
    if min(min_spatial_shard_rows(h // total_stride, n_spatial),
           min_spatial_shard_rows(_out_height(h, total_stride), n_spatial)) < 2:
        return gather(x)
    return x


def mean_pool(x: Sharded) -> torch.Tensor:
    """The (B, C) spatial mean on the mesh's first device: a group of one
    map takes its mean as the unsharded backbone does; strips add their sums
    (float32 at least) on their group's first device, divided by H·W."""
    outs = []
    for row in x.rows:
        if len(row) == 1:
            outs.append(row[0].mean(dim=(2, 3)))
            continue
        acc = torch.promote_types(row[0].dtype, torch.float32)
        dev = row[0].device
        total = functools.reduce(torch.add, [t.to(acc).sum(dim=(2, 3)).to(dev) for t in row])
        hw = sum(t.shape[2] for t in row) * row[0].shape[3]
        outs.append((total / hw).to(row[0].dtype))
    first = x.rows[0][0].device
    return outs[0] if len(outs) == 1 else torch.cat([o.to(first) for o in outs])


def cat_batch(parts: Sequence[Any]) -> Any:
    """``torch.cat(parts, 0)`` of tensors, or of :class:`Sharded` batches in
    the same order: with one data replica each strip concatenates on its
    device; with more, the replicas' rows follow one another (the global
    batch order, the blocks where they are)."""
    if not isinstance(parts[0], Sharded):
        return torch.cat(list(parts), dim=0)
    if all(len(p.rows) == 1 for p in parts):
        return Sharded([[torch.cat([p.rows[0][j] for p in parts], dim=0) for j in range(parts[0].strips)]],
                       parts[0].hdim)
    return Sharded([row for p in parts for row in p.rows], parts[0].hdim)
