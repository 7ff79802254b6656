"""The port's V-view data tier (data.pairing.build_multiview_index,
data.multiview.MultiViewGazeDataset, data.synthetic.
InMemoryMultiViewGazeDataset, the V-view keys of data.pipeline.collate)
against the JAX package's on the CPU, bit for bit, over synthetic HDF5
archives written by the JAX package's writer."""

import numpy as np
import pytest

from rot_mvgaze_tpu.data import BatchLoader as JaxBatchLoader
from rot_mvgaze_tpu.data import MultiViewGazeDataset as JaxMultiViewGazeDataset
from rot_mvgaze_tpu.data.pairing import build_multiview_index as jax_build_multiview_index
from rot_mvgaze_tpu.data.pairing import build_pair_index as jax_build_pair_index
from rot_mvgaze_tpu.data.synthetic import write_synthetic_dataset as jax_write_synthetic_dataset
from rot_mvgaze_tpu_torch.data import (
    BatchLoader,
    InMemoryMultiViewGazeDataset,
    MultiViewGazeDataset,
    build_multiview_index,
    build_pair_index,
)

INDEX_CASES = [
    ([36, 20], "all", 4, 0),
    ([54, 40, 18], "all", 3, 7),
    ([36], "novel_test", 3, 1),
    ([40], "novel_test", 6, 0),  # the truncated last frame is skipped
    ([72, 19], "novel_train", 12, 3),
    ([90], "all", 18, 2),
    ([36, 36], "all", 2, 5),
]


@pytest.mark.parametrize("sizes,tag,n_views,seed", INDEX_CASES)
def test_multiview_index_is_jax_bit_for_bit(sizes, tag, n_views, seed):
    got = build_multiview_index(sizes, tag, n_views=n_views, seed=seed)
    want = jax_build_multiview_index(sizes, tag, n_views=n_views, seed=seed)
    assert got == want and got
    for _, views in got:
        assert len(set(views)) == n_views and len({v // 18 for v in views}) == 1


def test_stereo_rng_index_unchanged_by_the_shared_scan():
    """build_pair_index now shares the frame scan with the V-view index:
    still JAX's bit for bit."""
    for sizes, tag, _, seed in INDEX_CASES:
        assert build_pair_index(sizes, tag, seed=seed) == jax_build_pair_index(sizes, tag, seed=seed)


@pytest.mark.parametrize("n_views,tag,match", [(1, "all", "n_views"), (8, "novel_test", "6 cameras"),
                                               (19, "all", "18 cameras")])
def test_impossible_n_views_raise_as_in_jax(n_views, tag, match):
    with pytest.raises(ValueError, match=match):
        jax_build_multiview_index([36], tag, n_views=n_views)
    with pytest.raises(ValueError, match=match):
        build_multiview_index([36], tag, n_views=n_views)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two subjects of 3 frames at 32x32, by JAX's writer."""
    root = tmp_path_factory.mktemp("mv_corpus")
    jax_write_synthetic_dataset(str(root), ["s00.h5", "s01.h5"], n_frames=3, image_size=32)
    return str(root)


@pytest.mark.parametrize("name,color,tag,n_views", [("xgaze", "bgr", "all", 3),
                                                    ("mpiinv", "rgb", "novel_test", 4)])
def test_samples_and_batches_are_jax_bit_for_bit(corpus, name, color, tag, n_views):
    """Every sample (imgs, gt_gazes, head_poses, idxs: values and dtypes)
    and every batch of both loaders, shuffled, equal JAX's."""
    args = (name, corpus, color, ["s00.h5", "s01.h5"])
    got = MultiViewGazeDataset(*args, n_views=n_views, camera_tag=tag, seed=4)
    want = JaxMultiViewGazeDataset(*args, n_views=n_views, camera_tag=tag, seed=4)
    assert got.idx_to_kv == want.idx_to_kv and len(got) == len(want) > 0
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert set(a) == set(b) == {"imgs", "gt_gazes", "head_poses", "idxs"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)
        assert a["imgs"].shape == (n_views, 32, 32, 3)
    batches = list(BatchLoader(got, 5, shuffle=True, seed=2, num_threads=2))
    jax_batches = list(JaxBatchLoader(want, 5, shuffle=True, seed=2, num_threads=2))
    assert len(batches) == len(jax_batches)
    for a, b in zip(batches, jax_batches):
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert batches[0]["gt_gazes"].dtype == np.float32 and batches[0]["idxs"].dtype == np.int32
    assert batches[0]["idxs"].shape == (5, n_views)
    got.close()
    want.close()


def test_in_memory_corpus_equals_the_hdf5_dataset(tmp_path):
    """InMemoryMultiViewGazeDataset (the card has no h5py) yields what
    MultiViewGazeDataset yields over the archives of the same subjects."""
    from rot_mvgaze_tpu_torch.data import write_synthetic_dataset

    names = write_synthetic_dataset(str(tmp_path), ["a.h5", "b.h5"], n_frames=2, image_size=16, seed=3,
                                    learnable=True)
    want = MultiViewGazeDataset("xgaze", str(tmp_path), "rgb", names, n_views=3, seed=3)
    got = InMemoryMultiViewGazeDataset(2, n_views=3, n_frames=2, image_size=16, seed=3, learnable=True)
    assert got.idx_to_kv == want.idx_to_kv
    for i in range(len(got)):
        a, b = got[i], want[i]
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)
    want.close()


def test_no_usable_frame_raises(tmp_path):
    from rot_mvgaze_tpu_torch.data import write_synthetic_h5

    write_synthetic_h5(str(tmp_path / "short.h5"), n_frames=1, n_cameras=2, image_size=8)
    with pytest.raises(ValueError, match="no usable frame"):
        MultiViewGazeDataset("xgaze", str(tmp_path), "rgb", ["short.h5"], n_views=3)
