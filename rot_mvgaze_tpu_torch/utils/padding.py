"""Row padding for fixed micro-batches (port of
``rot_mvgaze_tpu/utils/padding.py``).

The predictor serves every request in micro-batches of one fixed size, so the
last, ragged micro-batch is padded by repeating its last row; the caller
trims the padded predictions.
"""

from __future__ import annotations

import numpy as np


def pad_rows(x: np.ndarray, target: int) -> np.ndarray:
    """Pad a (N>0, ...) array to ``target`` rows by repeating the last row."""
    x = np.asarray(x)
    pad = target - x.shape[0]
    if pad <= 0:
        return x
    if x.shape[0] == 0:
        # repeating the last row of nothing would silently return 0 rows
        raise ValueError(f"cannot pad an empty array to {target} rows")
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)


def iter_padded_microbatches(arrays, micro_batch: int):
    """Slice N-row arrays into fixed-size micro-batches, padding the last.

    Yields ``(padded_slices_tuple, real_rows)`` per micro-batch."""
    n = int(np.asarray(arrays[0]).shape[0])
    for start in range(0, n, micro_batch):
        end = min(start + micro_batch, n)
        yield (
            tuple(
                pad_rows(np.asarray(a[start:end]), micro_batch)
                for a in arrays
            ),
            end - start,
        )
