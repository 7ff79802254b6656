"""Stereo pair index and camera splits (the port's own copy of the stereo
part of ``rot_mvgaze_tpu/data/pairing.py``; numpy and the standard library
only).

Rows of a subject's archive are frame-major over 18 cameras (``camera =
idx % 18``). Each in-split row is paired once, at construction, with a
partner among the other in-split cameras of the same frame. Two modes:

- ``build_pair_index_reference`` / ``reference_pair_indices``: the
  reference's frozen pairing bit for bit. Partners come from the standard
  library's Mersenne Twister ``Random.choice`` in the reference's loop order,
  and the reference builds the train dataset before the test dataset, so the
  test pairing depends on every draw the train pairing made first. The
  released checkpoints' eval numbers are means over this index.
- ``build_pair_index``: a dedicated ``numpy.random.Generator(seed)``; the
  same distribution, independent of other users of ``random``.

The V-view index (``build_multiview_index``) is not ported yet (ROADMAP A11).
"""

from __future__ import annotations

import random as _stdlib_random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NUM_CAMERAS = 18

# Camera splits: 'novel_test' holds out every third camera starting at 2;
# 'novel_train' is the complement.
CAMERA_TAGS: Dict[str, List[int]] = {
    "all": list(range(NUM_CAMERAS)),
    "novel_train": [c for c in range(NUM_CAMERAS) if c not in range(2, NUM_CAMERAS, 3)],
    "novel_test": list(range(2, NUM_CAMERAS, 3)),
}

PairIndex = List[Tuple[int, int, int]]  # (file_idx, idx, partner_idx)


def build_pair_index(
    file_sizes: Sequence[int],
    camera_tag: str = "all",
    seed: int = 0,
    num_cameras: int = NUM_CAMERAS,
) -> PairIndex:
    """The (file, idx, partner) stereo index for archives of
    ``file_sizes[i]`` rows: for every in-split row, one partner drawn
    uniformly from the other in-split cameras of its frame, by
    ``numpy.random.default_rng(seed)``."""
    cameras = set(CAMERA_TAGS[camera_tag])
    rng = np.random.default_rng(seed)
    index: PairIndex = []
    for file_i, n in enumerate(file_sizes):
        valid = {i for i in range(n) if (i % num_cameras) in cameras}
        for idx in sorted(valid):
            start = (idx // num_cameras) * num_cameras
            candidates = [i for i in range(start, start + num_cameras) if i in valid and i != idx]
            if candidates:
                index.append((file_i, idx, int(candidates[rng.integers(len(candidates))])))
    return index


def build_pair_index_reference(
    file_sizes: Sequence[int],
    camera_tag: str = "all",
    rng: Optional[_stdlib_random.Random] = None,
    seed: int = 0,
    num_cameras: int = NUM_CAMERAS,
) -> PairIndex:
    """The reference's pair index bit for bit: every partner drawn with
    ``Random.choice`` in the reference's iteration order, so that the
    variable number of ``getrandbits`` words each draw consumes is the same
    too. Pass a shared ``rng`` to replay a construction sequence over
    several datasets (:func:`reference_pair_indices`); otherwise a fresh
    ``Random(seed)``."""
    if rng is None:
        rng = _stdlib_random.Random(seed)
    cameras_idx = CAMERA_TAGS[camera_tag]
    index: PairIndex = []
    for file_i, n in enumerate(file_sizes):
        valid_indices = [i for i in range(0, n) if (i % num_cameras) in cameras_idx]
        valid_set = set(valid_indices)
        for idx in valid_indices:
            frame_start = (idx // num_cameras) * num_cameras
            frame_valid_indices = [
                i for i in range(frame_start, frame_start + num_cameras)
                if i in valid_set and i != idx
            ]
            if frame_valid_indices:
                index.append((file_i, idx, rng.choice(frame_valid_indices)))
    return index


def resolve_pair_index(
    file_sizes: Sequence[int],
    camera_tag: str,
    pairing: str = "reference",
    pair_rng: Optional[_stdlib_random.Random] = None,
    seed: int = 0,
    pair_index: Optional[PairIndex] = None,
    num_cameras: int = NUM_CAMERAS,
) -> PairIndex:
    """An explicit ``pair_index`` wins; else ``pairing`` selects
    ``"reference"`` (:func:`build_pair_index_reference`) or ``"rng"``
    (:func:`build_pair_index`)."""
    if pair_index is not None:
        return list(pair_index)
    if pairing == "reference":
        return build_pair_index_reference(
            file_sizes, camera_tag, rng=pair_rng, seed=seed, num_cameras=num_cameras
        )
    if pairing == "rng":
        return build_pair_index(file_sizes, camera_tag, seed=seed, num_cameras=num_cameras)
    raise ValueError(f"unknown pairing mode: {pairing!r}")


def reference_pair_indices(
    train_file_sizes: Sequence[int],
    train_camera_tag: str,
    test_file_sizes: Sequence[int],
    test_camera_tag: str,
    seed: int = 0,
    num_cameras: int = NUM_CAMERAS,
) -> Tuple[PairIndex, PairIndex]:
    """``(train_index, test_index)`` of one experiment under the reference's
    protocol: one ``Random(seed)``, the train dataset's draws first."""
    rng = _stdlib_random.Random(seed)
    train = build_pair_index_reference(
        train_file_sizes, train_camera_tag, rng=rng, num_cameras=num_cameras
    )
    test = build_pair_index_reference(
        test_file_sizes, test_camera_tag, rng=rng, num_cameras=num_cameras
    )
    return train, test
