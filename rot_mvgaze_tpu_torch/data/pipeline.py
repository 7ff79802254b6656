"""Host-side batching and prefetch to the card (port of
``rot_mvgaze_tpu/data/pipeline.py``).

:class:`BatchLoader` assembles batches of stacked numpy arrays on a
background thread from a bounded thread pool (HDF5 reads release the GIL);
images stay uint8 until the train step's augmentation on the card.
:func:`device_prefetch` moves them to the card ahead of the consumer:
pinned host buffers, copied with ``non_blocking=True`` on a side stream, the
consumer's stream waiting on each batch's event.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from rot_mvgaze_tpu_torch.utils.device import resolve_device

_FLOAT_KEYS = ("gt_gaze", "gt_gaze_1", "head_pose_0", "head_pose_1",
               "gt_gazes", "head_poses")  # the last two: stacked V-view labels
_INT_KEYS = ("idx_0", "idx_1", "idxs")


def collate(samples: list) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into one batch dict: labels and poses
    float32, row indices int32 (V-view ``idxs`` (B, V)), the rest (uint8
    images) as they are."""
    batch: Dict[str, np.ndarray] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if k in _FLOAT_KEYS:
            batch[k] = np.stack(vals).astype(np.float32)
        elif k in _INT_KEYS:
            batch[k] = np.asarray(vals, dtype=np.int32)
        else:
            batch[k] = np.stack(vals)
    return batch


def sharded_num_samples(n: int, process_shard: "tuple | None") -> int:
    """Samples per epoch of one process under ``process_shard=(index,
    count)``."""
    if process_shard is not None:
        n = n // process_shard[1]
    return n


def epoch_order(
    n: int, shuffle: bool, seed: int, epoch: int, process_shard: "tuple | None"
) -> np.ndarray:
    """The order of one epoch: ``arange(n)``, shuffled by
    ``numpy.random.default_rng((seed, epoch))``; under ``process_shard`` the
    process's strided slice, cut to ``n // count`` so every process takes
    the same number of batches."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    if process_shard is not None:
        i, p = process_shard
        order = order[i::p][: n // p]
    return order


class BatchLoader:
    """Shuffling, thread-pooled batch iterator over an indexable dataset.

    One ``__iter__`` is one epoch, in :func:`epoch_order` for the loader's
    ``epoch``, which then advances by one. ``num_threads`` reads samples in
    parallel; ``prefetch`` batches are assembled ahead of the consumer.
    ``skip_batches`` is a one-shot fast-forward for a mid-epoch resume: the
    next ``__iter__`` starts at that batch of the epoch's order. After an
    iteration starts, ``last_epoch_order`` holds the dataset rows it yields,
    in order.
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        num_threads: int = 8,
        prefetch: int = 2,
        process_shard: Optional[tuple] = None,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.process_shard = process_shard
        self.epoch = 0
        self.skip_batches = 0

    def num_samples(self) -> int:
        """Samples this loader yields per epoch (before batching)."""
        return sharded_num_samples(len(self.dataset), self.process_shard)

    def __len__(self) -> int:
        n = self.num_samples()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> Iterator[np.ndarray]:
        order = epoch_order(
            len(self.dataset), self.shuffle, self.seed, self.epoch, self.process_shard
        )
        skip, self.skip_batches = int(self.skip_batches), 0
        first = skip * self.batch_size
        self.last_epoch_order = order[first:]
        n = len(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(first, stop, self.batch_size):
            yield order[start : start + self.batch_size]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        error: list = []

        def put(item) -> bool:
            # gives up once the consumer has stopped iterating (early break)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for idxs in self._batch_indices():
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, idxs))
                        if not put(collate(samples)):
                            return
            except BaseException as e:  # re-raised in the consumer
                error.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            try:  # drain, so that a blocked producer sees the stop flag
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5)
            self.epoch += 1
        if error:
            raise error[0]


class _PinnedSlot:
    """One batch's pinned host buffers, by key, and the event of the last
    copies out of them."""

    def __init__(self) -> None:
        self.buffers: Dict[str, torch.Tensor] = {}
        self.copied: Optional[torch.cuda.Event] = None

    def stage(self, batch: Dict[str, np.ndarray], device: torch.device,
              stream: torch.cuda.Stream) -> Dict[str, torch.Tensor]:
        """Copy ``batch`` into the buffers and enqueue their copies to the
        card on ``stream``. A buffer is refilled only after its previous
        copy has finished."""
        if self.copied is not None:
            self.copied.synchronize()
        out = {}
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                src = torch.from_numpy(np.ascontiguousarray(v))
                buf = self.buffers.get(k)
                if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                    buf = self.buffers[k] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                buf.copy_(src)
                out[k] = buf.to(device, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record(stream)
        return out


def device_prefetch(
    iterator: Iterable[Dict[str, np.ndarray]], device: Any = "cuda", size: int = 2
) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of numpy arrays -> batches of tensors on ``device``, staged
    ``size`` batches ahead of the consumer.

    On the card each batch goes through pinned host buffers (a ring of
    ``size + 1``) and ``non_blocking`` copies on a side stream; before a
    batch is yielded, the consumer's current stream waits on its copies'
    event, and each tensor is recorded on that stream, so the caching
    allocator does not hand its memory out while the consumer may still
    read it. On the CPU the arrays are wrapped as they are, without copies
    (CPU-only PyTorch cannot pin)."""
    device = resolve_device(device)
    it = iter(iterator)
    try:
        if device.type != "cuda":
            for batch in it:
                yield {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
            return
        stream = torch.cuda.Stream(device)
        slots = [_PinnedSlot() for _ in range(size + 1)]
        staged: list = []
        n = 0

        def stage_next() -> None:
            nonlocal n
            batch = next(it, None)
            if batch is not None:
                slot = slots[n % len(slots)]
                staged.append((slot.stage(batch, device, stream), slot.copied))
                n += 1

        for _ in range(size):
            stage_next()
        while staged:
            out, copied = staged.pop(0)
            stage_next()
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(copied)
            for t in out.values():
                t.record_stream(consumer)
            yield out
    finally:
        # a consumer that stops early ends the loader's epoch now
        close = getattr(it, "close", None)
        if close is not None:
            close()
