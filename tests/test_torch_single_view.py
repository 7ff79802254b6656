"""The port's single-view baseline (rot_mvgaze_tpu_torch.models.single.
SingleViewGazeNet and evaluate.evaluate_gaze(single_view=True)) against
the JAX package's on the CPU: the same variables (state_dict_from_jax with
single_view=True, loaded strictly) and the same seeded inputs, R18 at
32x32 (64x64 in train mode), float32. Bars: outputs atol 2e-4 / rtol 1e-3
(tests/test_model_parity.py:120), the train-mode loss rtol 1e-4 and
running statistics atol 1e-4 (tests/test_torch_train.py), the
evaluation's mean error within 1e-4 deg."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.data import BatchLoader as JaxBatchLoader
from rot_mvgaze_tpu.data import GazeDataset as JaxGazeDataset
from rot_mvgaze_tpu.evaluate import evaluate_gaze as jax_evaluate_gaze
from rot_mvgaze_tpu.losses import gaze_angular_loss as jax_gaze_angular_loss
from rot_mvgaze_tpu.models import SingleViewGazeNet as JaxSingleViewGazeNet
from rot_mvgaze_tpu_torch.compat import state_dict_from_jax
from rot_mvgaze_tpu_torch.data import BatchLoader, GazeDataset, write_synthetic_dataset
from rot_mvgaze_tpu_torch.evaluate import evaluate_gaze, evaluate_gaze_detailed
from rot_mvgaze_tpu_torch.losses import gaze_angular_loss
from rot_mvgaze_tpu_torch.models import SingleViewGazeNet

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def variables():
    """JAX variables as numpy; BN running statistics from one train-mode
    forward, so that eval BN is not the identity."""
    model = JaxSingleViewGazeNet(backbone_depth=18)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(6, SIZE, SIZE, 3)), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), x)
    _, updates = model.apply(variables, x, train=True, mutable=["batch_stats"])
    return jax.tree.map(np.asarray, {"params": variables["params"], "batch_stats": updates["batch_stats"]})


def _port(variables):
    model = SingleViewGazeNet(backbone_depth=18)
    model.load_state_dict(state_dict_from_jax(variables, backbone_depth=18, single_view=True), strict=True)
    return model


def test_state_dict_loads_strictly_and_names_the_tree(variables):
    sd = state_dict_from_jax(variables, backbone_depth=18, single_view=True)
    model = SingleViewGazeNet(backbone_depth=18)
    assert set(sd) == set(model.state_dict())
    assert "_gaze_estimator.blocks.1.0.weight" in sd and "_feat_extractor.0.layer4.1.bn2.running_var" in sd
    np.testing.assert_array_equal(sd["_gaze_estimator.blocks.0.0.weight"].numpy(),
                                  variables["params"]["gaze_estimator"]["dense_0"]["kernel"].T)


def test_raw_and_dict_interfaces_match_jax(variables):
    x = np.random.default_rng(1).normal(size=(4, SIZE, SIZE, 3)).astype(np.float32)
    model = JaxSingleViewGazeNet(backbone_depth=18)
    want_raw = model.apply(variables, jnp.asarray(x))
    want = model.apply(variables, {"img_0": jnp.asarray(x), "gt_gaze": jnp.zeros((4, 2))})
    port = _port(variables).eval()
    with torch.inference_mode():
        got_raw = port(torch.from_numpy(x))
        got = port({"img_0": torch.from_numpy(x), "gt_gaze": torch.zeros(4, 2)})
    assert got_raw.shape == (4, 2) and got["img_feat_0"].shape == (4, 512) and "gt_gaze" in got
    np.testing.assert_allclose(got_raw.numpy(), np.asarray(want_raw), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got["pred_gaze"].numpy(), np.asarray(want["pred_gaze"]), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got["img_feat_0"].numpy(), np.asarray(want["img_feat_0"]), atol=1e-4, rtol=0)


def test_train_forward_matches_jax(variables):
    """Train mode (BN on batch statistics): the angular loss and the
    updated running statistics; the backward reaches every parameter."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    y = rng.uniform(-0.5, 0.5, (8, 2)).astype(np.float32)
    model = JaxSingleViewGazeNet(backbone_depth=18)

    def loss_fn(params):
        pred, updates = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jax_gaze_angular_loss(pred, jnp.asarray(y)), updates["batch_stats"]

    want_loss, stats = loss_fn(jax.tree.map(jnp.asarray, variables["params"]))
    port = _port(variables).train()
    loss = gaze_angular_loss(port(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    new = state_dict_from_jax({"params": variables["params"], "batch_stats": jax.tree.map(np.asarray, stats)},
                              backbone_depth=18, single_view=True)
    state = port.state_dict()
    for key, value in new.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[key].numpy(), value.numpy(), atol=1e-4, rtol=0, err_msg=key)
    missing = [k for k, p in port.named_parameters() if p.grad is None and ".fc." not in k]
    assert missing == []


def test_evaluate_gaze_single_view_matches_jax(variables, tmp_path):
    """evaluate_gaze(single_view=True) over GazeDataset(stereo=False)
    batches (a ragged last batch) within 1e-4 deg of JAX's; the breakdown
    groups by camera."""
    names = write_synthetic_dataset(str(tmp_path), ["s00.h5", "s01.h5"], n_frames=2, image_size=SIZE,
                                    learnable=True)
    ds = GazeDataset("xgaze", str(tmp_path), "bgr", names, stereo=False)
    jds = JaxGazeDataset("xgaze", str(tmp_path), "bgr", names, stereo=False)
    assert "img_1" not in ds[0]
    port = _port(variables)
    got = evaluate_gaze(port, BatchLoader(ds, 20, num_threads=2), image_size=SIZE, single_view=True)
    want = jax_evaluate_gaze(JaxSingleViewGazeNet(backbone_depth=18), variables,
                             JaxBatchLoader(jds, 20, num_threads=2), image_size=SIZE, single_view=True)
    assert abs(got - want) < 1e-4, (got, want)
    detail = evaluate_gaze_detailed(port, BatchLoader(ds, 20, num_threads=2), dataset=ds, image_size=SIZE,
                                    single_view=True)
    assert detail["n"] == len(ds) and len(detail["per_camera"]) == 18 and detail["per_subject"]
    assert detail["mean_error"] == pytest.approx(got, abs=1e-9)
    ds.close()
    jds.close()
