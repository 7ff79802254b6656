"""The port's evaluation (rot_mvgaze_tpu_torch.evaluate) against the JAX
package's on the CPU: the same weights (state_dict_from_jax), the same
synthetic corpus, loaders of both packages over it. R18, 2 fusion
iterations, 32x32, float32; the JAX model runs its default (plain XLA)
path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.data import BatchLoader as JaxBatchLoader
from rot_mvgaze_tpu.data import GazeDataset as JaxGazeDataset
from rot_mvgaze_tpu.evaluate import breakdown_from_errors as jax_breakdown_from_errors
from rot_mvgaze_tpu.evaluate import evaluate_gaze_detailed as jax_evaluate_gaze_detailed
from rot_mvgaze_tpu.evaluate import format_breakdown as jax_format_breakdown
from rot_mvgaze_tpu.data.synthetic import write_synthetic_dataset
from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu_torch.compat import state_dict_from_jax
from rot_mvgaze_tpu_torch.data import BatchLoader, GazeDataset
from rot_mvgaze_tpu_torch.evaluate import (
    breakdown_from_errors,
    evaluate_gaze,
    evaluate_gaze_detailed,
    format_breakdown,
)
from rot_mvgaze_tpu_torch.models import FeatRotationSymm

CFG = {"backbone_depth": 18, "num_iter": 2}
SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; two intra-op threads
    each keep torch from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two subjects (72 pairs), and JAX variables whose BatchNorm running
    statistics come from one train-mode forward, so that eval BN is not the
    identity."""
    root = str(tmp_path_factory.mktemp("eval_corpus"))
    names = write_synthetic_dataset(root, ["s00.h5", "s01.h5"], n_frames=2, image_size=SIZE,
                                    learnable=True)
    model = JaxFeatRotationSymm(**CFG)
    rng = np.random.default_rng(0)
    data = {
        "img_0": jnp.asarray(rng.normal(size=(4, SIZE, SIZE, 3)), jnp.float32),
        "img_1": jnp.asarray(rng.normal(size=(4, SIZE, SIZE, 3)), jnp.float32),
        "rot_0": jnp.broadcast_to(jnp.eye(3), (4, 3, 3)),
        "rot_1": jnp.broadcast_to(jnp.eye(3), (4, 3, 3)),
    }
    variables = model.init(jax.random.PRNGKey(0), data)
    _, updates = model.apply(variables, data, train=True, mutable=["batch_stats"])
    variables = jax.tree.map(np.asarray, {"params": variables["params"],
                                          "batch_stats": updates["batch_stats"]})
    return root, names, model, variables


def _port_model(variables):
    model = FeatRotationSymm(**CFG)
    model.load_state_dict(state_dict_from_jax(variables, **CFG), strict=True)
    return model


@pytest.mark.parametrize("batch_size", [10, 72], ids=["ragged_last_batch", "one_batch"])
def test_evaluate_gaze_detailed_matches_jax(setup, batch_size):
    """Mean error within 1e-4 deg; per-camera and per-subject keys and
    counts equal, each group's error within 1e-4 deg."""
    root, names, jax_model, variables = setup
    jax_ds = JaxGazeDataset("mpiinv", root, "rgb", names)
    ds = GazeDataset("mpiinv", root, "rgb", names)
    want = jax_evaluate_gaze_detailed(
        jax_model, variables, JaxBatchLoader(jax_ds, batch_size), dataset=jax_ds, image_size=SIZE
    )
    got = evaluate_gaze_detailed(_port_model(variables), BatchLoader(ds, batch_size), dataset=ds,
                                 image_size=SIZE)
    assert got["n"] == want["n"] == len(ds)
    assert abs(got["mean_error"] - want["mean_error"]) < 1e-4, (got["mean_error"], want["mean_error"])
    for group in ("per_camera", "per_subject"):
        assert got[group] is not None and list(got[group]) == list(want[group])
        for key, stats in want[group].items():
            assert got[group][key]["n"] == stats["n"]
            assert abs(got[group][key]["error"] - stats["error"]) < 1e-4, (group, key)
    print(f"evaluate: port {got['mean_error']:.8f} deg, JAX {want['mean_error']:.8f} deg")


def test_evaluate_gaze_with_replacement_params(setup):
    """evaluate_gaze is the detailed mean; params= scores other weights
    (by named_parameters name) without touching the module's."""
    root, names, _, variables = setup
    ds = GazeDataset("xgaze", root, "bgr", names)
    model = _port_model(variables)
    mean = evaluate_gaze(model, BatchLoader(ds, 16), image_size=SIZE)
    assert mean == evaluate_gaze_detailed(model, BatchLoader(ds, 16), image_size=SIZE)["mean_error"]
    other = {n: p.detach() * 0.5 for n, p in model.named_parameters()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    halved = evaluate_gaze(model, BatchLoader(ds, 16), image_size=SIZE, params=other)
    twin = _port_model(variables)
    with torch.no_grad():
        for p in twin.parameters():
            p.mul_(0.5)
    assert halved == evaluate_gaze(twin, BatchLoader(ds, 16), image_size=SIZE)
    assert halved != mean
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


class _Subjects:
    """A dataset stand-in: only the pair index is read."""

    def __init__(self, n):
        self.idx_to_kv = [(i % 3, i, i + 1) for i in range(n)]


@pytest.mark.parametrize("with_rows", [False, True], ids=["dataset_order", "rows"])
def test_breakdown_from_errors_bit_for_bit(with_rows):
    rng = np.random.default_rng(1)
    n = 50
    errors = rng.uniform(0, 20, n)
    idx_0 = rng.integers(0, 180, n)
    ds = _Subjects(n if not with_rows else 80)
    rows = rng.permutation(80)[:n] if with_rows else None
    got = breakdown_from_errors(errors, idx_0=idx_0, dataset=ds, rows=rows)
    want = jax_breakdown_from_errors(errors, idx_0=idx_0, dataset=ds, rows=rows)
    assert got == want
    assert got["per_subject"] is not None and got["per_camera"] is not None
    assert format_breakdown(got) == jax_format_breakdown(want)
    bare = breakdown_from_errors(errors)
    assert bare == jax_breakdown_from_errors(errors) and bare["per_camera"] is None


def test_empty_loader_raises(setup):
    _, _, _, variables = setup
    with pytest.raises(ValueError, match="no batches"):
        evaluate_gaze(_port_model(variables), [], image_size=SIZE)
