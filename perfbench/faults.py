"""Faults planted under the timed path, to show that ``correct`` catches
them. The benchmark's own runs plant nothing; the tests and
``perfbench.calibrate`` pass one of these as ``plant`` to
``perfbench.run.execute``.

Training (``plant(step, optimizer) -> step``):

- ``unchanged``: the step runs, but the update leaves the parameters as
  they were (the optimizer's step does nothing);
- ``half_batch``: the step sees the first half of each batch, so its loss
  and gradients are means over the rest.

Serving (``plant(predictor) -> predictor``):

- ``answer_altered``: the first answer of each micro-batch is moved by
  0.05 rad in pitch where the predictor produces it;
- ``rows_swapped``: the first two answers of each micro-batch change
  places, as a fault in the coalescing's row routing would;
- ``half_batch``: the predictor computes the first half of each
  micro-batch's rows, and answers the rest with their mean.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np


def unchanged(step: Callable, optimizer: Any) -> Callable:
    optimizer.step = lambda *args, **kwargs: None
    return step


def half_batch(train_step: Callable, optimizer: Any) -> Callable:
    def halved(batch, generator=None, *, step: int):
        rows = next(iter(batch.values())).shape[0] // 2
        return train_step({k: v[:rows] for k, v in batch.items()}, generator, step=step)

    return halved


class _Predictor:
    """The predictor with ``predict`` replaced; everything else its own."""

    def __init__(self, inner: Any, predict: Callable) -> None:
        self._inner, self._predict = inner, predict

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    def predict(self, *args: np.ndarray) -> np.ndarray:
        return self._predict(*args)


def answer_altered(predictor: Any) -> Any:
    def predict(*args):
        out = np.array(predictor.predict(*args))
        out[0, 0] += 0.05
        return out

    return _Predictor(predictor, predict)


def rows_swapped(predictor: Any) -> Any:
    def predict(*args):
        out = np.array(predictor.predict(*args))
        if len(out) >= 2:
            out[[0, 1]] = out[[1, 0]]
        return out

    return _Predictor(predictor, predict)


def serve_half_batch(predictor: Any) -> Any:
    def predict(*args):
        n = np.shape(args[0])[0]
        if n < 2:
            return predictor.predict(*args)
        part = predictor.predict(*(a[:n // 2] for a in args))
        return np.concatenate([part, np.repeat(part.mean(0, keepdims=True), n - n // 2, 0)])

    return _Predictor(predictor, predict)


TRAIN = {"unchanged": unchanged, "half_batch": half_batch}
SERVE = {"answer_altered": answer_altered, "rows_swapped": rows_swapped, "half_batch": serve_half_batch}
