"""Spatial partitioning under data parallelism over processes on the CPU:
two ``gloo`` ranks (tests/_torch_dp_worker.py's ``spatial_steps``), each
with its views in two height strips on a ``(data 1, spatial 2)`` CPU mesh,
so that every BatchNorm adds its strips' sums in the process and then over
the ranks, against one process unsharded on the concatenated batch, at the
bars of tests/test_torch_distributed.py: two updates of R18 x 1 at 32x32
with augmentation on (layer3's 2 rows fall under the spatial floor), the
default step, ``bn_stat_subsample 2`` and ``grad_accum 2`` with ``remat``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dp_worker as worker  # noqa: E402
from test_torch_distributed import launch  # noqa: E402


@pytest.fixture(scope="module")
def spatial_results(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ranks, _ = launch("spatial_steps", 2, tmp_path_factory.mktemp("dp_spatial"), timeout=420)
    finally:
        torch.set_num_threads(threads)
    return ranks[0]


@pytest.mark.parametrize("name", worker.SPATIAL_CASES)
def test_two_ranks_on_strips_train_as_one_process(spatial_results, name):
    """Losses and errors at rtol 1e-4; the first update's gradients within
    3e-5 of each tensor's largest |gradient|; after two Adam updates every
    parameter within 2e-5 and every BN buffer within 1e-4; num_batches_tracked
    equal; the ranks' states the same bits."""
    r = spatial_results[name]
    np.testing.assert_allclose(np.asarray(r["stats"]), np.asarray(r["single_stats"]), rtol=1e-4)
    assert r["same_grad_keys"] and r["tracked_equal"] and r["ranks_equal"]
    worst_grad = max(r["grad_rel"].values())
    assert worst_grad <= 3e-5, {k: v for k, v in r["grad_rel"].items() if v > 3e-5}
    buffers = {k: v for k, v in r["diffs"].items() if "running" in k}
    params = {k: v for k, v in r["diffs"].items() if "running" not in k}
    assert max(buffers.values()) <= 1e-4, {k: v for k, v in buffers.items() if v > 1e-4}
    assert max(params.values()) <= 2e-5, {k: v for k, v in params.items() if v > 2e-5}
    print(f"{name}: two ranks on strips vs one process: gradients {worst_grad:.3e} of their scale, "
          f"parameters {max(params.values()):.3e}")
