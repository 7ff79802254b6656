"""The port's data tier (rot_mvgaze_tpu_torch.data) against the JAX
package's on the same files and seeds: pair indices, synthetic archives,
dataset samples and loader batches bit for bit, and prefetch on the CPU
returning the loader's arrays unchanged."""

import os
import random

import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.data import pairing as jax_pairing
from rot_mvgaze_tpu.data.hdf5 import GazeDataset as JaxGazeDataset
from rot_mvgaze_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from rot_mvgaze_tpu.data.synthetic import write_synthetic_dataset as jax_write_synthetic_dataset
from rot_mvgaze_tpu.data.synthetic import write_synthetic_h5 as jax_write_synthetic_h5
from rot_mvgaze_tpu_torch.data import (
    CAMERA_TAGS,
    BatchLoader,
    GazeDataset,
    InMemoryGazeDataset,
    build_pair_index,
    build_pair_index_reference,
    device_prefetch,
    reference_pair_indices,
    resolve_pair_index,
    synthetic_rows,
    write_synthetic_dataset,
    write_synthetic_h5,
)

SIZES = [[36], [54, 36], [40, 17, 18], [5]]


def test_camera_tags_match_jax():
    assert CAMERA_TAGS == jax_pairing.CAMERA_TAGS


@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("tag", ["all", "novel_train", "novel_test"])
@pytest.mark.parametrize("seed", [0, 7])
def test_pair_index_bit_for_bit(sizes, tag, seed):
    """Both modes, each size and split: the same (file, idx, partner) list."""
    assert build_pair_index(sizes, tag, seed=seed) == jax_pairing.build_pair_index(sizes, tag, seed=seed)
    assert build_pair_index_reference(sizes, tag, seed=seed) == (
        jax_pairing.build_pair_index_reference(sizes, tag, seed=seed)
    )


@pytest.mark.parametrize("pairing", ["reference", "rng"])
def test_resolve_pair_index_and_shared_rng_match_jax(pairing):
    """resolve_pair_index dispatches as JAX's; a shared Random replays the
    train-then-test construction sequence; an explicit index wins."""
    sizes = [36, 54]
    assert resolve_pair_index(sizes, "novel_train", pairing=pairing, seed=3) == (
        jax_pairing.resolve_pair_index(sizes, "novel_train", pairing=pairing, seed=3)
    )
    ours = resolve_pair_index(sizes, "all", pairing=pairing, pair_rng=random.Random(5))
    theirs = jax_pairing.resolve_pair_index(sizes, "all", pairing=pairing, pair_rng=random.Random(5))
    assert ours == theirs
    explicit = [(0, 1, 2)]
    assert resolve_pair_index(sizes, "all", pairing=pairing, pair_index=explicit) == explicit
    with pytest.raises(ValueError, match="unknown pairing"):
        resolve_pair_index(sizes, "all", pairing="other")


@pytest.mark.parametrize("seed", [0, 216])
def test_reference_pair_indices_match_jax(seed):
    got = reference_pair_indices([72, 36], "novel_train", [36], "novel_test", seed=seed)
    want = jax_pairing.reference_pair_indices([72, 36], "novel_train", [36], "novel_test", seed=seed)
    assert got == want


@pytest.mark.parametrize("learnable", [False, True], ids=["noise", "learnable"])
def test_synthetic_archives_bit_for_bit(tmp_path, learnable):
    """The port's archive, the JAX package's archive and synthetic_rows hold
    the same arrays."""
    import h5py

    ours = write_synthetic_h5(str(tmp_path / "ours.h5"), n_frames=2, image_size=24, seed=4,
                              learnable=learnable)
    theirs = jax_write_synthetic_h5(str(tmp_path / "theirs.h5"), n_frames=2, image_size=24, seed=4,
                                    learnable=learnable)
    rows = synthetic_rows(n_frames=2, image_size=24, seed=4, learnable=learnable)
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        for key, arr in zip(("face_patch", "face_gaze", "face_head_pose"), rows):
            assert a[key].dtype == b[key].dtype == arr.dtype
            np.testing.assert_array_equal(a[key][()], b[key][()])
            np.testing.assert_array_equal(a[key][()], arr)
    # several subjects: subject i from seed + i
    kw = dict(n_frames=1, image_size=8, seed=9, learnable=learnable)
    names = write_synthetic_dataset(str(tmp_path / "a"), ["x.h5", "y.h5"], **kw)
    assert jax_write_synthetic_dataset(str(tmp_path / "b"), ["x.h5", "y.h5"], **kw) == names
    for name in names:
        with h5py.File(tmp_path / "a" / name, "r") as a, h5py.File(tmp_path / "b" / name, "r") as b:
            for key in ("face_patch", "face_gaze", "face_head_pose"):
                np.testing.assert_array_equal(a[key][()], b[key][()])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two subjects written by the JAX package's writer."""
    root = tmp_path_factory.mktemp("corpus")
    names = jax_write_synthetic_dataset(str(root), ["s00.h5", "s01.h5"], n_frames=3, image_size=16)
    return str(root), names


def _assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize(
    "name, color, tag, pairing, stereo",
    [("xgaze", "bgr", "all", "reference", True), ("mpiinv", "rgb", "novel_test", "rng", True),
     ("xgaze", "rgb", "novel_train", "reference", False)],
    ids=["xgaze_bgr", "mpiinv_rgb", "single_view"],
)
def test_every_dataset_sample_bit_for_bit(corpus, name, color, tag, pairing, stereo):
    root, names = corpus
    ours = GazeDataset(name, root, color, names, camera_tag=tag, stereo=stereo, seed=2, pairing=pairing)
    theirs = JaxGazeDataset(name, root, color, names, camera_tag=tag, stereo=stereo, seed=2,
                            pairing=pairing)
    assert ours.idx_to_kv == theirs.idx_to_kv and ours.file_sizes == theirs.file_sizes
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        _assert_samples_equal(ours[i], theirs[i])
    ours.close()
    theirs.close()
    _assert_samples_equal(ours[0], theirs[0])  # a read after close reopens


@pytest.mark.parametrize("learnable", [False, True])
@pytest.mark.parametrize("tag", ["all", "novel_test"])
def test_in_memory_dataset_equals_gaze_dataset_over_the_same_corpus(tmp_path, learnable, tag):
    """The in-memory corpus yields GazeDataset's samples over the archives
    write_synthetic_dataset writes from the same arguments, bit for bit."""
    names = write_synthetic_dataset(str(tmp_path), ["s00.h5", "s01.h5"], n_frames=2,
                                    image_size=16, seed=5, learnable=learnable)
    ours = InMemoryGazeDataset(2, n_frames=2, image_size=16, seed=5, learnable=learnable,
                               camera_tag=tag)
    theirs = GazeDataset("xgaze", str(tmp_path), "rgb", names, camera_tag=tag, seed=5)
    assert ours.idx_to_kv == theirs.idx_to_kv and ours.file_sizes == theirs.file_sizes
    assert len(ours) > 0
    for i in range(len(ours)):
        _assert_samples_equal(ours[i], theirs[i])
    theirs.close()


def test_dataset_rejects_bad_names(corpus):
    root, names = corpus
    with pytest.raises(ValueError, match="dataset_name"):
        GazeDataset("other", root, "rgb", names)
    with pytest.raises(ValueError, match="color_type"):
        GazeDataset("xgaze", root, "hsv", names)


def _epoch(loader):
    return [dict(b) for b in loader]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("drop_last", [False, True], ids=["ragged", "drop_last"])
@pytest.mark.parametrize("shard", [None, (1, 2)], ids=["one_process", "shard_1_of_2"])
def test_loader_batches_bit_for_bit(corpus, seed, drop_last, shard):
    """Two epochs of shuffled batches, then an epoch fast-forwarded by
    skip_batches, the same batches in the same order as the JAX loader's."""
    root, names = corpus
    ds = GazeDataset("xgaze", root, "bgr", names)
    kw = dict(batch_size=10, shuffle=True, seed=seed, drop_last=drop_last, num_threads=3,
              process_shard=shard)
    ours, theirs = BatchLoader(ds, **kw), JaxBatchLoader(ds, **kw)
    assert len(ours) == len(theirs) and ours.num_samples() == theirs.num_samples()
    for _ in range(2):
        got, want = _epoch(ours), _epoch(theirs)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            _assert_samples_equal(g, w)
        np.testing.assert_array_equal(ours.last_epoch_order, theirs.last_epoch_order)
    ours.skip_batches = theirs.skip_batches = 2
    got, want = _epoch(ours), _epoch(theirs)
    assert len(got) == len(want) == len(ours) - 2
    for g, w in zip(got, want):
        _assert_samples_equal(g, w)
    assert ours.epoch == theirs.epoch == 3 and ours.skip_batches == 0


def test_loader_stops_early_and_raises_reader_errors(corpus):
    """An abandoned epoch still advances the epoch counter; an error in a
    reader thread reaches the consumer."""
    root, names = corpus
    loader = BatchLoader(GazeDataset("xgaze", root, "bgr", names), batch_size=4, shuffle=True)
    for _ in loader:
        break
    assert loader.epoch == 1

    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            raise KeyError(i)

    with pytest.raises(KeyError):
        _epoch(BatchLoader(Broken(), batch_size=4))


def test_prefetch_on_the_cpu_returns_the_loader_arrays(corpus):
    """device='cpu': tensors that wrap the loader's arrays, same values and
    dtypes, in order; an early stop closes the loader's epoch."""
    root, names = corpus
    ds = GazeDataset("mpiinv", root, "rgb", names)
    want = _epoch(BatchLoader(ds, batch_size=7))
    loader = BatchLoader(ds, batch_size=7)
    got = list(device_prefetch(iter(loader), device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert isinstance(g[key], torch.Tensor) and g[key].device.type == "cpu"
            np.testing.assert_array_equal(g[key].numpy(), w[key])
            assert g[key].numpy().dtype == w[key].dtype
    stream = device_prefetch(iter(loader), device="cpu")
    next(stream)
    stream.close()
    assert loader.epoch == 2


def test_prefetch_to_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(device_prefetch(iter([{"x": np.zeros(2)}])))


def test_h5py_is_imported_only_when_a_dataset_is_built():
    import subprocess
    import sys

    code = ("import sys, rot_mvgaze_tpu_torch.data, rot_mvgaze_tpu_torch.train; "
            "print('h5py' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
