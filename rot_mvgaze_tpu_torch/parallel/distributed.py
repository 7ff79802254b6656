"""Data parallelism over processes (counterpart of
``rot_mvgaze_tpu/parallel/distributed.py`` and of the parts of
``rot_mvgaze_tpu/parallel/mesh.py`` that training needs).

One process per card, started by ``torchrun``::

    torchrun --nproc_per_node 4 -m rot_mvgaze_tpu_torch --exp_name ... --dp true

:func:`initialize` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and joins the process
group: ``nccl`` for the card, ``gloo`` for the CPU, or the ``backend``
given (``gloo`` also carries CUDA tensors, which is how two ranks can share
one card). Without that environment it does nothing and the program runs as
one process; with it, a failed start raises, so that a job never degrades
into N independent runs. Device tensors go only through ``all_reduce``,
which both backends offer on CUDA tensors; host metadata goes through a CPU
``gloo`` group (:func:`host_group`).

With ``--spatial_partition sp`` each process drives a spatial group of
``sp`` cards, ``cuda:{LOCAL_RANK·sp}`` onwards (:func:`global_mesh`), and
the BatchNorm statistics' group is still every process: the strips' sums
are added in the process first (``ops/batchnorm.py``).

Each rank loads its strided shard of every epoch's order
(``data.pipeline.epoch_order``), and the global batch is the rank-ordered
concatenation of the local batches, as with JAX's
``make_array_from_process_local_data``.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_host_group: Any = None


def cluster_configured() -> bool:
    """Whether the environment asks for a process group (torchrun's
    variables, or any one of them: a partial set is a configuration
    error that :func:`initialize` raises on)."""
    return any(os.environ.get(k) for k in _ENV)


def configured_world_size() -> int:
    """``WORLD_SIZE`` from the environment (1 without it), readable before
    :func:`initialize`."""
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def initialize(device_type: str = "cuda", backend: Optional[str] = None,
               timeout_s: float = 600.0, spatial: int = 1) -> bool:
    """Join the process group that torchrun's environment describes.

    Returns False (and does nothing) when no cluster is configured or the
    group already exists. ``backend`` defaults to ``nccl`` for
    ``device_type`` ``cuda`` and ``gloo`` for ``cpu``. Under ``cuda`` the
    rank's device becomes :func:`rank_device`: ``cuda:{LOCAL_RANK}``, or
    with ``spatial`` cards per process the first of its group. Any failure
    to start a configured group raises ``RuntimeError``."""
    global _host_group
    if dist.is_available() and dist.is_initialized():
        return False
    if not cluster_configured():
        return False
    missing = [k for k in _ENV if not os.environ.get(k)]
    if missing:
        raise RuntimeError(f"a process group is configured, but {missing} are not set "
                           f"(start the program with torchrun)")
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this PyTorch build")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(spatial))
    try:
        dist.init_process_group(
            backend,
            init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
        )
        _host_group = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    except Exception as e:  # noqa: BLE001 (re-raised with the configuration)
        raise RuntimeError(
            f"torch.distributed start failed for rank {rank} of {world} ({backend}, "
            f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}): {e}"
        ) from e
    return True


def shutdown() -> None:
    """Leave the process group, if there is one."""
    global _host_group
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def process_index() -> int:
    """This process's rank (0 without a group): ``jax.process_index``."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a group): ``jax.process_count``."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_rank() -> int:
    """``LOCAL_RANK`` (0 without it): the card index of this process."""
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def rank_cards(spatial: int = 1) -> list:
    """This process's cards under torchrun with ``spatial`` cards per
    process (one spatial group each): ``cuda:{LOCAL_RANK·sp + j}``,
    ``j < sp``."""
    first = local_rank() * max(spatial, 1)
    return [torch.device("cuda", first + j) for j in range(max(spatial, 1))]


def rank_device(spatial: int = 1) -> torch.device:
    """The card this process keeps its state on: its group's first."""
    return rank_cards(spatial)[0]


def global_mesh(spatial: int = 1) -> Any:
    """This process's mesh (counterpart of the JAX package's
    ``global_mesh``, whose mesh spans every process): its spatial group of
    ``spatial`` cards (:func:`rank_cards`), ``(data 1, spatial sp)``; the
    data axis is the processes, over which training runs as above."""
    from rot_mvgaze_tpu_torch.parallel.mesh import make_mesh

    cards = rank_cards(spatial)
    if cards[-1].index >= torch.cuda.device_count():
        raise ValueError(f"local rank {local_rank()} needs cards {cards[0].index}..{cards[-1].index}, "
                         f"{torch.cuda.device_count()} visible")
    return make_mesh(cards, spatial=spatial)


def device_group() -> Any:
    """The group the training collectives run on: the default group under
    data parallelism (more than one process), else None."""
    return dist.group.WORLD if process_count() > 1 else None


def host_group() -> Any:
    """A ``gloo`` group over every process, for CPU tensors (metadata)."""
    if _host_group is None:
        raise RuntimeError("no process group: call initialize() first")
    return _host_group


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank (through the host
    group; CPU tensors inside are carried as bytes)."""
    if process_count() == 1:
        return obj
    box = [obj if process_index() == src else None]
    dist.broadcast_object_list(box, src=src, group=host_group())
    return box[0]


def all_gather_object(obj: Any) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` without a group)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=host_group())
    return out


def any_process(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank, the same answer on every rank
    (the preemption agreement: one flag exchange per call)."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return bool(t.item())


def set_batchnorm_group(model: torch.nn.Module, group: Any) -> None:
    """Every train-mode normaliser of ``model`` (``BatchNormAct``,
    ``IntensityBatchNorm``) takes its batch statistics over ``group``'s
    global batch (None: this process's batch)."""
    from rot_mvgaze_tpu_torch.models.norm import BatchNormAct, IntensityBatchNorm

    for m in model.modules():
        if isinstance(m, (BatchNormAct, IntensityBatchNorm)):
            m.group = group
