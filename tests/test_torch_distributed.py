"""Data parallelism in the port (rot_mvgaze_tpu_torch.parallel) on the CPU:
``gloo`` ranks in subprocesses (tests/_torch_dp_worker.py, started with
torchrun's environment variables) against one process at the concatenated
batch, which is the semantics of JAX's global batch
(``make_array_from_process_local_data``, tests/test_parallel.py's sharded
step against one device, tests/test_multiprocess.py's two processes).

- The BN op over 3 ranks: the global batch's statistics, the subsample's
  global prefix (which here covers all of rank 0, part of rank 1 and none
  of rank 2), dx, dres, and dscale / dbias as rank sums, at the BN bars
  (forward 1e-5; gradients atol 5e-4 / rtol 1e-3).
- Two updates of R18 x 1 with augmentation on, over 2 ranks: default,
  ``bn_stat_subsample 2``, ``share_feature`` (IntensityBatchNorm), and
  ``grad_accum 2`` with ``remat``: losses at rtol 1e-4, parameters within
  2e-5 and BN buffers within 1e-4 of one process (the trajectory bars of
  tests/test_torch_train.py), the same on both ranks.
- The Trainer through the command line over 2 ranks: batch rounding,
  sharded loaders, rank 0's output directory, the evaluation's global mean,
  the aggregated breakdown, the preemption agreement (a signal on rank 1
  alone stops both at the same step) and rank 0 alone writing.

Each launch has its own timeout, so that a hang fails fast.
"""

import glob
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from rot_mvgaze_tpu_torch import parallel
from rot_mvgaze_tpu_torch.data import write_synthetic_dataset
from rot_mvgaze_tpu_torch.utils.config import load_yaml

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dp_worker as worker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(scenario, world, out_dir, *args, timeout=240):
    """Run the worker's ``scenario`` on ``world`` gloo ranks; every rank's
    saved result, in rank order. A rank that fails or hangs fails the
    launch (the others are killed)."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_torch_dp_worker.py"), scenario,
             str(out_dir), *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank} of {scenario} failed:\n{out[-4000:]}"
    results = []
    for r in range(world):
        path = os.path.join(out_dir, f"{scenario}_rank{r}.pt")
        results.append(torch.load(path, weights_only=False))
        os.remove(path)
    return results, outputs


# ---------------------------------------------------------------------------
# the BN op over 3 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def op_results(tmp_path_factory):
    world = 3
    ranks, _ = launch("ops", world, tmp_path_factory.mktemp("dp_ops"))
    x, res, g, scale, bias = worker.op_inputs(world)
    single = [worker.op_case(x, res, g, scale, bias, *case) for case in worker.OP_CASES]
    return ranks, single


@pytest.mark.parametrize("case", range(len(worker.OP_CASES)),
                         ids=[f"k{k}{'_res' if r else ''}{'_relu' if a else ''}"
                              for k, r, a in worker.OP_CASES])
def test_bn_op_takes_the_global_batch_statistics(op_results, case):
    ranks, single = op_results
    want = single[case]
    for key in ("y", "dx", "dres"):
        if want[key] is None:
            continue
        got = torch.cat([r[case][key] for r in ranks])
        bar = dict(atol=1e-5, rtol=1e-5) if key == "y" else dict(atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(got.numpy(), want[key].numpy(), err_msg=key, **bar)
    for r in ranks:
        for key in ("mean", "var"):
            np.testing.assert_allclose(r[case][key].numpy(), want[key].numpy(), atol=1e-5, rtol=1e-5)
    for key in ("dscale", "dbias"):  # each rank's own sum; the ranks' sum is the batch's
        got = sum(r[case][key] for r in ranks)
        np.testing.assert_allclose(got.numpy(), want[key].numpy(), atol=5e-4, rtol=1e-3, err_msg=key)


def test_subsample_prefix_spans_ranks():
    """k=2 over 3 ranks of 3 images: the global prefix is images 0-3, all of
    rank 0's and the first of rank 1's; rank 2's rows get scale*rstd*g'
    alone, and its x moves no statistic (the op test above holds the
    values)."""
    from rot_mvgaze_tpu_torch.ops.batchnorm import stat_rows

    class Group:
        def __init__(self, rank):
            self._rank = rank

        def rank(self):
            return self._rank

        def size(self):
            return 3

    hw = worker.OP_HW ** 2
    assert [stat_rows(3, hw, 2, Group(r)) for r in range(3)] == [(4 * hw, 3 * hw), (4 * hw, hw), (4 * hw, 0)]
    assert stat_rows(3, hw, 4, Group(0)) == (2 * hw, 2 * hw)
    with pytest.raises(ValueError, match="leaves <2"):
        stat_rows(3, hw, 5, Group(0))


# ---------------------------------------------------------------------------
# train steps over 2 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    ranks, _ = launch("steps", 2, tmp_path_factory.mktemp("dp_steps"), timeout=420)
    return ranks[0]


# Adam moves an element by about lr whatever the size of its gradient, so an
# element whose gradient is at float32 noise level (an exact cancellation in
# one summation order and not in another) can move +lr in one run and -lr in
# the other. share_feature's fuser has a few hundred such elements among its
# 9.4M (gradients below 1e-9, measured on the CPU), and they move 2 x 3.4e-5
# apart; its parameters are held through its gradients instead, with its
# losses and running statistics. The other cases have none.
ADAM_SIGN_NOISE = {"share_feature"}


@pytest.mark.parametrize("name", sorted(worker.STEP_CASES))
def test_two_ranks_train_as_one_process(step_results, name):
    """Each update's loss and error (global means) at rtol 1e-4; the first
    update's gradients, averaged over the ranks, within 3e-5 of each
    tensor's largest |gradient| (10x the largest difference measured on the
    CPU, 2.7e-6); after two Adam updates every parameter within 2e-5 (but
    see ADAM_SIGN_NOISE) and every BN buffer within 1e-4 of the one-process
    run (rank 0 runs it and compares); the two ranks' states are the same
    bits."""
    r = step_results[name]
    np.testing.assert_allclose(np.asarray(r["stats"]), np.asarray(r["single_stats"]), rtol=1e-4)
    assert r["same_grad_keys"] and r["tracked_equal"] and r["ranks_equal"]
    worst_grad = max(r["grad_rel"].values())
    assert worst_grad <= 3e-5, {k: v for k, v in r["grad_rel"].items() if v > 3e-5}
    buffers = {k: v for k, v in r["diffs"].items() if "running" in k}
    params = {k: v for k, v in r["diffs"].items() if "running" not in k}
    assert max(buffers.values()) <= 1e-4, {k: v for k, v in buffers.items() if v > 1e-4}
    if name not in ADAM_SIGN_NOISE:
        assert max(params.values()) <= 2e-5, {k: v for k, v in params.items() if v > 2e-5}
    print(f"{name}: two ranks vs one process: gradients {worst_grad:.3e} of their scale, "
          f"parameters {max(params.values()):.3e}")


def test_the_runs_trained(step_results):
    """The updates moved the weights, and the share_feature case carried
    IntensityBatchNorm's running std away from its initial ones."""
    assert step_results["default"]["moved"] > 1e-5
    assert step_results["share_feature"]["intensity_moved"] > 1e-3


# ---------------------------------------------------------------------------
# the Trainer through the command line over 2 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trainer_results(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_trainer")
    subjects = load_yaml(os.path.join(REPO, "configs", "subject", "mpiinv.yaml"))["subject"]
    write_synthetic_dataset(str(root / "mpiinv"), subjects, n_frames=1, image_size=32, learnable=True)
    data_path = root / "data_path.yaml"
    data_path.write_text(f"xgaze: '{root / 'xgaze'}'\nmpiinv: '{root / 'mpiinv'}'\n")
    ranks, outputs = launch("trainer", 2, root, str(data_path), timeout=420)
    # one process over the whole test set, from the same initial weights
    from rot_mvgaze_tpu_torch.cli import main as cli

    args = cli.get_parser().parse_args([
        "--exp_name", "mpiinv_known", "--data_path", str(data_path), "-out", str(root / "single"),
        "--device", "cpu", "--backbone_depth", "18", "--num_iter", "1", "--image_size", "32",
        "--test_batch_size", "24", "--native_loader", "false", "--num_workers", "1"])
    single_error = cli.build_experiment(args).test(-1)
    yield ranks, outputs, single_error, root
    shutil.rmtree(root, ignore_errors=True)  # the preemption checkpoint: a few hundred MB


def test_trainer_evaluation_is_the_global_mean(trainer_results):
    """Both ranks report the mean over all 270 test pairs, the one-process
    evaluation's within 1e-4 deg; the breakdown counts every pair."""
    ranks, _, single_error, _ = trainer_results
    for r in ranks:
        assert abs(r["error"] - single_error) < 1e-4, (r["error"], single_error)
        assert r["n_samples"] == r["per_camera_n"] == 270
    assert ranks[0]["error"] == ranks[1]["error"]


def test_trainer_batches_split_over_the_ranks(trainer_results):
    ranks, outputs, _, _ = trainer_results
    for r, out in zip(ranks, outputs):
        assert r["batch_size"] == 6 and r["local_batch"] == 3
        assert "batch_size 7 -> 6 (multiple of 2)" in out and "test_batch_size 25 -> 24" in out
        assert "data-parallel: 2 processes" in out
    assert ranks[0]["output_dir"] == ranks[1]["output_dir"]  # rank 0's, adopted


def test_preemption_is_agreed_and_rank_0_alone_writes(trainer_results):
    """A SIGTERM on rank 1 alone stops both ranks after the same update;
    the preemption checkpoint, the TensorBoard file and test_results.txt
    exist once, all written by rank 0 into its directory; rank 1 wrote no
    file. The two ranks end with the same weights."""
    ranks, outputs, _, root = trainer_results
    assert ranks[0]["step"] == ranks[1]["step"] == 1
    assert all("preempted: state saved" in out for out in outputs)
    written = ranks[0]["written"]
    assert sum(f.endswith("preempt_epoch_00.pth.tar") for f in written) == 1
    assert sum("tfevents" in f for f in written) == 1
    assert sum(f.endswith("test_results.txt") for f in written) == 1
    assert ranks[1]["written"] == []
    assert not glob.glob(str(root / "logs_rank1" / "**" / "*"), recursive=True)
    assert ranks[0]["digest"] == ranks[1]["digest"]


def test_initialize_without_a_cluster_does_nothing(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert parallel.initialize("cpu") is False
    assert (parallel.process_index(), parallel.process_count(), parallel.device_group()) == (0, 1, None)


def test_a_configured_cluster_that_cannot_start_raises(monkeypatch):
    """JAX's rule: a configured cluster that fails to start never degrades
    into independent runs. Here WORLD_SIZE is set without the rest, and
    then the rest point at a port nobody listens on with a short timeout."""
    for key in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="not set"):
        parallel.initialize("cpu")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises(RuntimeError, match="start failed"):
        parallel.initialize("cpu", timeout_s=3.0)
    assert parallel.process_count() == 1
