"""Device meshes in one process (counterpart of
``rot_mvgaze_tpu/parallel/mesh.py``).

A mesh is a grid of ``torch.device``s: the rows are the data replicas, and
each row's devices are a spatial group that splits the image height between
them (height strips with halo rows, ``parallel/spatial.py``), as the JAX
package's 2-D ``(data, spatial)`` mesh does through GSPMD. A list of devices
may repeat a device: ``make_mesh(["cuda:0"] * 4, spatial=2)`` is a logical
mesh on one card, and ``make_mesh(["cpu"] * 8, spatial=2)`` the CPU tests'
counterpart of JAX's 8 virtual CPU devices. A spatial group never spans
processes, as in JAX (``mesh.py:52-66``): data parallelism over processes
is ``parallel/distributed.py``'s, one spatial group per process.

``dp_size`` and ``spatial_size`` read the mesh as the JAX functions do, and
``min_spatial_shard_rows`` / :func:`split_sizes` split a height axis as
GSPMD does: ``ceil(h/n)`` rows per strip, the remainder in the last.
:func:`with_spatial_floor` sets the backbone's floor (the strips are
gathered before a stage whose output would leave fewer than 2 rows in a
strip) and refuses a model that has none. :func:`shard_batch` places a
batch on the mesh: NHWC images over (data, height), V-view images flattened
to their B·V views first, the rest whole on the first device.
:func:`visible_devices` reads a ``--device`` flag.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


def _device(d: Any) -> torch.device:
    """``torch.device(d)``, a card without an index as the current card's."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A ``(data, spatial)`` grid of ``torch.device``s: ``grid[d]`` is data
    replica d's spatial group. ``axis_names`` is ``("data",)`` for a 1-D
    mesh and ``("data", "spatial")`` for a 2-D one, as JAX names them."""

    def __init__(self, grid: Sequence[Sequence[Any]], spatial_axis: bool) -> None:
        self.grid: List[List[torch.device]] = [[_device(d) for d in row] for row in grid]
        if not self.grid or any(len(row) != len(self.grid[0]) or not row for row in self.grid):
            raise ValueError(f"a mesh is a non-empty rectangular grid of devices, got {grid}")
        self.axis_names = (DATA_AXIS, SPATIAL_AXIS) if spatial_axis else (DATA_AXIS,)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, (len(self.grid), len(self.grid[0]))))

    @property
    def devices(self) -> np.ndarray:
        """The grid as an object array, (data,) or (data, spatial)."""
        arr = np.empty((len(self.grid), len(self.grid[0])), dtype=object)
        for i, row in enumerate(self.grid):
            for j, d in enumerate(row):
                arr[i, j] = d
        return arr if len(self.axis_names) > 1 else arr[:, 0]

    @property
    def first_device(self) -> torch.device:
        """Where the model's state lives (the first group's first device)."""
        return self.grid[0][0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.grid]})"


def visible_devices(device: str = "cuda") -> List[torch.device]:
    """The devices a ``--device`` flag makes visible: the comma-separated
    list given (repeats allowed), every card in index order for ``cuda``
    (none without a card), or the one device named."""
    if "," in device:
        return [torch.device(d.strip()) for d in device.split(",")]
    if device == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device)]


def make_mesh(devices: Optional[Sequence[Any]] = None, spatial: int = 1) -> Mesh:
    """Data-parallel mesh over the given devices (default: every visible
    card; a list may repeat a device). ``spatial > 1`` folds them into a
    2-D ``(data, spatial)`` mesh: every ``spatial`` consecutive devices
    split each image's height, and data parallelism runs over the groups."""
    devices = list(devices) if devices is not None else visible_devices()
    if not devices:
        raise ValueError("no devices for a mesh (no card is visible; pass devices, e.g. ['cpu'] * 8)")
    if spatial <= 1:
        return Mesh([[d] for d in devices], spatial_axis=False)
    if len(devices) % spatial:
        raise ValueError(f"spatial={spatial} must divide the device count {len(devices)}")
    grid = [devices[i:i + spatial] for i in range(0, len(devices), spatial)]
    return Mesh(grid, spatial_axis=True)


def dp_size(mesh: Optional[Mesh]) -> int:
    """Number of ways the batch axis is split (1 without a mesh)."""
    return 1 if mesh is None else len(mesh.grid)


def spatial_size(mesh: Optional[Mesh]) -> int:
    """Number of ways the image height is split (1 without one)."""
    if mesh is None or SPATIAL_AXIS not in mesh.axis_names:
        return 1
    return len(mesh.grid[0])


def min_spatial_shard_rows(h: int, n_shards: int) -> int:
    """Rows of the smallest strip when a height-``h`` axis is split
    ``n_shards`` ways as GSPMD splits it: strips of ceil(h/n) rows, the last
    holding the remainder, which can be fewer (even <= 0)."""
    per_shard = -(-h // n_shards)
    return h - (n_shards - 1) * per_shard


def split_sizes(h: int, n: int) -> List[int]:
    """The strip heights of a height-``h`` axis over ``n`` strips, GSPMD's
    split (:func:`min_spatial_shard_rows`); every strip must hold a row."""
    per = -(-h // n)
    sizes = [per] * (n - 1) + [h - (n - 1) * per]
    if sizes[-1] < 1:
        raise ValueError(f"a height of {h} leaves an empty strip over {n} (strips {sizes})")
    return sizes


def with_spatial_floor(model: Any, mesh: Optional[Mesh]) -> Any:
    """``model`` with the backbone's spatial floor set for a 2-D mesh (its
    ``spatial_unshard``, the strip count): the strips are gathered onto
    their group's first device before a stage whose output would leave
    fewer than 2 rows in a strip, so that the pool and the heads run on
    whole maps. A model without the floor is refused, as in the JAX
    package. Set in place (a module is not cloned); no-op on a 1-D or
    absent mesh."""
    sp = spatial_size(mesh)
    if sp <= 1:
        return model
    if not hasattr(model, "spatial_unshard"):
        raise ValueError(
            f"{type(model).__name__} has no spatial_unshard field; training or serving it under a "
            f"spatial mesh needs the backbone's spatial floor. Use a 1-D data mesh."
        )
    model.spatial_unshard = sp
    return model


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """A batch dict placed on the mesh (the counterpart of JAX's
    ``shard_batch`` / ``pin_images``): each NHWC image leaf as
    ``spatial.Sharded`` blocks, its rows over the data replicas and each
    replica's height in strips over its group; every other leaf stays whole
    where it is, on the first device, where the pooled features meet it. A
    rank-4 leaf (B, H, W, C) is cut by rows; a V-view leaf (B, V, H, W, C)
    is flattened b-major to (B·V, H, W, C) first, so that each replica holds
    whole samples' views, as JAX shards B and reshapes on each device: its
    B samples must split evenly over the data replicas. A mesh of one
    device, or none, leaves the batch as it is."""
    if mesh is None or dp_size(mesh) * spatial_size(mesh) == 1:
        return dict(batch)
    from rot_mvgaze_tpu_torch.parallel.spatial import shard_images

    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if v.ndim == 5:
            if v.shape[0] % dp_size(mesh):
                raise ValueError(f"a batch of {v.shape[0]} samples ({k}: {v.shape[1]} views each) does not "
                                 f"split over {dp_size(mesh)} data replicas")
            v = v.reshape((v.shape[0] * v.shape[1],) + tuple(v.shape[2:]))
        out[k] = shard_images(v, mesh.grid) if v.ndim == 4 else v
    return out
