"""The port's packed cache and C++ loader (rot_mvgaze_tpu_torch.data.packed,
rot_mvgaze_tpu_torch.data.native) against the JAX package's: packs byte for
byte from the same HDF5 archives, batches bit for bit over the same packs,
and the guards of tests/test_native_loader.py."""

import filecmp
import os

import numpy as np
import pytest

import rot_mvgaze_tpu.data.native as jax_native
import rot_mvgaze_tpu.data.packed as jax_packed
from rot_mvgaze_tpu_torch.data import BatchLoader, GazeDataset, write_synthetic_dataset, write_synthetic_h5
from rot_mvgaze_tpu_torch.data import native, packed

SUBJECTS = ["a.h5", "b.h5", "c.h5"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three subjects of 3 frames x 18 cameras, 16x16."""
    root = str(tmp_path_factory.mktemp("packed_corpus"))
    write_synthetic_dataset(root, SUBJECTS, n_frames=3, image_size=16)
    return root


@pytest.mark.parametrize("dataset_name,color", [("xgaze", "bgr"), ("mpiinv", "rgb")])
def test_packs_are_the_jax_packages_byte_for_byte(corpus, tmp_path, dataset_name, color):
    """pack_dataset's files equal the JAX package's, BGR->RGB and MPII-NV's
    pitch flip included; the numpy map reads the archive's rows back."""
    import h5py

    ours = packed.pack_dataset(corpus, SUBJECTS, str(tmp_path / "port"), dataset_name, color)
    theirs = jax_packed.pack_dataset(corpus, SUBJECTS, str(tmp_path / "jax"), dataset_name, color)
    for a, b in zip(ours, theirs):
        assert filecmp.cmp(a, b, shallow=False), (a, b)
        assert packed.read_header(a) == jax_packed.read_header(b)
        assert packed.expected_size(a) == os.path.getsize(a)
    pf = packed.PackedFile(ours[0])
    with h5py.File(os.path.join(corpus, SUBJECTS[0])) as f:
        img, pose = np.asarray(f["face_patch"]), np.asarray(f["face_head_pose"])
    np.testing.assert_array_equal(pf.images, img[..., ::-1] if color == "bgr" else img)
    flip = -1.0 if dataset_name == "mpiinv" else 1.0
    np.testing.assert_array_equal(pf.head_pose[:, 0], flip * pose[:, 0])
    np.testing.assert_array_equal(pf.head_pose[:, 1], pose[:, 1])


def test_a_current_pack_is_used_without_its_archive(tmp_path, monkeypatch):
    """A valid pack no older than its archive is used as it is (the archive,
    here an empty file, is never opened); a newer archive or a truncated
    pack is repacked."""
    src = str(tmp_path / "s.h5")
    write_synthetic_h5(src, n_frames=1, image_size=8)
    cache = str(tmp_path / "cache")
    (path,) = packed.pack_dataset(str(tmp_path), ["s.h5"], cache, "xgaze", "bgr")
    before = open(path, "rb").read()
    os.replace(src, str(tmp_path / "moved.h5"))
    open(src, "wb").close()  # an empty "archive", older than the pack
    os.utime(src, (os.path.getmtime(path) - 10,) * 2)
    calls = []
    monkeypatch.setattr(packed, "pack_hdf5", lambda *a, **k: calls.append(a))
    assert packed.pack_dataset(str(tmp_path), ["s.h5"], cache, "xgaze", "bgr") == [path]
    assert calls == [] and open(path, "rb").read() == before
    os.utime(src, (os.path.getmtime(path) + 10,) * 2)  # the archive is newer: repack
    packed.pack_dataset(str(tmp_path), ["s.h5"], cache, "xgaze", "bgr")
    assert len(calls) == 1
    os.utime(src, (os.path.getmtime(path) - 10,) * 2)
    with open(path, "r+b") as f:  # truncated, with a fresh mtime: repack
        f.truncate(os.path.getsize(path) // 2)
    assert not packed.is_valid_pack(path)
    packed.pack_dataset(str(tmp_path), ["s.h5"], cache, "xgaze", "bgr")
    assert len(calls) == 2


def test_a_whole_pack_serves_without_any_archive(tmp_path, monkeypatch):
    """A corpus kept as packs only (write_synthetic_corpus): each whole pack
    is used as it is, with nothing to open; a subject with neither archive
    nor whole pack raises, naming both."""
    from rot_mvgaze_tpu_torch.data import write_synthetic_corpus

    root, cache = str(tmp_path), str(tmp_path / "_rmgpack" / "xgaze")
    names = write_synthetic_corpus(root, ["a.h5", "b.h5"], n_frames=1, image_size=8)
    monkeypatch.setattr(packed, "pack_hdf5", lambda *a, **k: pytest.fail("packed an archive"))
    paths = packed.pack_dataset(root, names, cache, "xgaze", "bgr")
    assert paths == [os.path.join(cache, n + ".rmgpack") for n in names]
    assert [packed.PackedFile(p).n for p in paths] == [18, 18]
    with open(paths[1], "r+b") as f:
        f.truncate(os.path.getsize(paths[1]) // 2)
    with pytest.raises(FileNotFoundError, match="no archive, and .*b.h5.rmgpack is not a whole pack"):
        packed.pack_dataset(root, names, cache, "xgaze", "bgr")


def test_the_packer_command_line(corpus, tmp_path):
    out = str(tmp_path / "packs")
    assert packed._main([corpus, "--dataset", "mpiinv", "--cache_dir", out]) == 0
    assert sorted(os.listdir(out)) == [s + ".rmgpack" for s in SUBJECTS]
    assert packed._main([str(tmp_path / "empty"), "--dataset", "xgaze"]) == 1


def _datasets(corpus, tmp_path, **kw):
    ours = native.PackedGazeDataset("xgaze", corpus, "bgr", SUBJECTS, seed=0,
                                    cache_dir=str(tmp_path / "port"), **kw)
    theirs = jax_native.PackedGazeDataset("xgaze", corpus, "bgr", SUBJECTS, seed=0,
                                          cache_dir=str(tmp_path / "jax"), **kw)
    return ours, theirs


def _assert_same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


LOADER_CASES = {
    "eval_order": dict(batch_size=10),
    "shuffled_drop_last": dict(batch_size=7, shuffle=True, seed=3, drop_last=True),
    "shuffled_ragged": dict(batch_size=25, shuffle=True, seed=1),
    "novel_split": dict(batch_size=8, shuffle=True, camera_tag="novel_test"),
    "rng_pairing": dict(batch_size=8, shuffle=True, pairing="rng"),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_native_batches_are_the_jax_loaders_bit_for_bit(corpus, tmp_path, case):
    """Three epochs, then a resumed epoch (skip_batches), each batch equal
    in keys, dtypes and values; len() and last_epoch_order agree too."""
    kw = dict(LOADER_CASES[case])
    ds_kw = {k: kw.pop(k) for k in ("camera_tag", "pairing") if k in kw}
    ours_ds, theirs_ds = _datasets(corpus, tmp_path, **ds_kw)
    assert ours_ds.pool is not None and ours_ds.idx_to_kv == theirs_ds.idx_to_kv
    ours = native.NativeBatchLoader(ours_ds, **kw)
    theirs = jax_native.NativeBatchLoader(theirs_ds, **kw)
    assert len(ours) == len(theirs) and ours.num_samples() == theirs.num_samples()
    for _ in range(3):
        _assert_same_batches(ours, theirs)
        np.testing.assert_array_equal(ours.last_epoch_order, theirs.last_epoch_order)
    ours.skip_batches = theirs.skip_batches = 2
    _assert_same_batches(ours, theirs)
    assert ours.epoch == theirs.epoch == 4 and ours.skip_batches == 0


def test_numpy_gathers_serve_the_same_batches(corpus, tmp_path):
    """Without the pool (use_native=False, as without g++) the samples are
    GazeDataset's, and BatchLoader over them yields the native batches."""
    ours, _ = _datasets(corpus, tmp_path)
    numpy_ds = native.PackedGazeDataset("xgaze", corpus, "bgr", SUBJECTS, seed=0,
                                        cache_dir=str(tmp_path / "port"), use_native=False)
    assert numpy_ds.pool is None
    h5 = GazeDataset("xgaze", corpus, "bgr", SUBJECTS, seed=0)
    assert numpy_ds.idx_to_kv == h5.idx_to_kv
    for i in (0, 17, len(h5) - 1):
        a, b = numpy_ds[i], h5[i]
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    kw = dict(batch_size=9, shuffle=True, seed=5, drop_last=True)
    _assert_same_batches(BatchLoader(numpy_ds, num_threads=2, **kw),
                         native.NativeBatchLoader(ours, **kw))


def test_the_loader_source_differs_from_the_repositorys_only_in_comments():
    """The port's copy of the gather engine is the repository's
    native/loader.cpp line for line once comments and blank lines are
    dropped, so a fix made to one copy and not the other fails here."""

    def code(path):
        with open(path) as f:
            return [ln for ln in (raw.split("//", 1)[0].rstrip() for raw in f) if ln]

    ours, theirs = code(native.SRC), code(os.path.join(REPO, "native", "loader.cpp"))
    assert len(ours) > 200
    assert ours == theirs


def test_async_gathers_complete_out_of_order(tmp_path):
    """wait(ticket) returns only once that ticket's buffers are written, even
    when later, smaller gathers finish first."""
    src = str(tmp_path / "s.h5")
    write_synthetic_h5(src, n_frames=6, image_size=32)
    dst = packed.pack_hdf5(src, str(tmp_path / "s.pack"), "xgaze", "rgb")
    pool, pf = native.NativePool([dst], n_threads=4), packed.PackedFile(dst)
    rng = np.random.default_rng(7)
    for _ in range(5):
        rows = rng.integers(0, pf.n, 512)
        big = (np.zeros((512, 32, 32, 3), np.uint8), np.zeros((512, 2), np.float32),
               np.zeros((512, 2), np.float32))
        t_big = pool.gather_async(np.zeros(512, np.int32), rows, *big)
        smalls = []
        for _ in range(8):
            r = rng.integers(0, pf.n, 2)
            bufs = (np.zeros((2, 32, 32, 3), np.uint8), np.zeros((2, 2), np.float32),
                    np.zeros((2, 2), np.float32))
            smalls.append((pool.gather_async(np.zeros(2, np.int32), r, *bufs), r, bufs))
        pool.wait(t_big)
        np.testing.assert_array_equal(big[0], pf.images[rows])
        np.testing.assert_array_equal(big[1], pf.gaze[rows])
        np.testing.assert_array_equal(big[2], pf.head_pose[rows])
        for t, r, bufs in smalls:
            pool.wait(t)
            np.testing.assert_array_equal(bufs[0], pf.images[r])
    out = pool.gather(np.array([0, 0], np.int32), np.array([5, 1]))
    np.testing.assert_array_equal(out["img"], pf.images[[5, 1]])


def _pack(tmp_path, name="s", size=16):
    src = str(tmp_path / f"{name}.h5")
    write_synthetic_h5(src, n_frames=2, image_size=size)
    return packed.pack_hdf5(src, str(tmp_path / f"{name}.pack"), "xgaze", "bgr")


def _truncated(tmp_path):
    dst = _pack(tmp_path)
    with open(dst, "r+b") as f:
        f.truncate(os.path.getsize(dst) // 2)
    return native.NativePool([dst])


def _short_header(tmp_path):
    bad = str(tmp_path / "bad.pack")
    with open(bad, "wb") as f:
        f.write(b"RMGPACK1XX")
    return native.NativePool([bad])


def _mixed_resolution(tmp_path):
    return native.NativePool([_pack(tmp_path, "s16", 16), _pack(tmp_path, "s32", 32)])


def _stale_pack_bounds(tmp_path):
    write_synthetic_dataset(str(tmp_path), ["a.h5"], n_frames=2)
    return native.PackedGazeDataset("xgaze", str(tmp_path), "bgr", ["a.h5"], seed=0,
                                    pair_index=[(0, 10_000, 0)])


def _bad_file_key(tmp_path):
    write_synthetic_dataset(str(tmp_path), ["a.h5"], n_frames=2)
    return native.PackedGazeDataset("xgaze", str(tmp_path), "bgr", ["a.h5"], seed=0,
                                    pair_index=[(3, 0, 0)])


def _empty_index(tmp_path):
    write_synthetic_dataset(str(tmp_path), ["a.h5"], n_frames=2)
    ds = native.PackedGazeDataset("xgaze", str(tmp_path), "bgr", ["a.h5"], seed=0, pair_index=[])
    return native.NativeBatchLoader(ds, batch_size=4)


GUARDS = {
    "truncated_pack": (_truncated, IOError, "inconsistent extents"),
    "short_header": (_short_header, IOError, "bad magic or truncated header"),
    "mixed_resolution": (_mixed_resolution, IOError, "geometry"),
    "stale_pack_bounds": (_stale_pack_bounds, ValueError, "stale"),
    "bad_file_key": (_bad_file_key, ValueError, "packed files"),
    "empty_index": (_empty_index, ValueError, "empty"),
}


@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_bad_packs_and_indices_raise_before_any_gather(tmp_path, guard):
    build, error, match = GUARDS[guard]
    with pytest.raises(error, match=match):
        build(tmp_path)


def test_numpy_map_and_validity_refuse_truncated_packs(tmp_path):
    dst = _pack(tmp_path)
    assert packed.is_valid_pack(dst)
    with open(dst, "r+b") as f:
        f.truncate(os.path.getsize(dst) - 1)
    assert not packed.is_valid_pack(dst)
    with pytest.raises(ValueError, match="truncated"):
        packed.PackedFile(dst)
    bad = tmp_path / "not_a_pack"
    bad.write_bytes(b"HDF" * 30)
    assert not packed.is_valid_pack(str(bad))
    with pytest.raises(ValueError, match="not a pack"):
        packed.read_header(str(bad))
