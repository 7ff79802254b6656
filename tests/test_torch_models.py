"""The port's models (rot_mvgaze_tpu_torch.models) against the JAX package's
in eval mode: the same variables (converted with state_dict_from_jax and
loaded strictly) and the same numpy inputs through both. Bars are the JAX
suite's own (tests/test_model_parity.py): atol 2e-4 / rtol 1e-3 on the
model's outputs, 1e-4 on pooled backbone features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.compat import flax_to_torch_state_dict
from rot_mvgaze_tpu.geometry import rotation_matrix_2d as jax_rotation_matrix_2d
from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu_torch.compat import state_dict_from_jax
from rot_mvgaze_tpu_torch.models import FeatRotationSymm


def _data(batch=2, size=32, seed=0):
    rng = np.random.default_rng(seed)
    hp = rng.uniform(-0.6, 0.6, (2, batch, 2)).astype(np.float32)
    return {
        "img_0": rng.normal(size=(batch, size, size, 3)).astype(np.float32),
        "img_1": rng.normal(size=(batch, size, size, 3)).astype(np.float32),
        "rot_0": np.array(jax_rotation_matrix_2d(jnp.asarray(hp[0]))),
        "rot_1": np.array(jax_rotation_matrix_2d(jnp.asarray(hp[1]))),
    }


def _jax_variables(cfg, data, seed=0):
    """Initialised JAX variables as numpy, with non-trivial BN running
    statistics so that the eval BN affine is exercised."""
    model = JaxFeatRotationSymm(**cfg)
    variables = model.init(jax.random.PRNGKey(seed), jax.tree.map(jnp.asarray, data))
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed + 1)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return leaf

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    return variables


def _port_model(cfg, variables):
    model = FeatRotationSymm(**cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, **cfg), strict=True)
    return model


def _run_both(cfg, data, variables, use_pallas_fusion=False):
    want = JaxFeatRotationSymm(**cfg, use_pallas_fusion=use_pallas_fusion).apply(
        variables, jax.tree.map(jnp.asarray, data)
    )
    with torch.inference_mode():
        got = _port_model(cfg, variables)({k: torch.from_numpy(v) for k, v in data.items()})
    return got, want


def _assert_outputs_close(got, want, num_iter):
    for i in range(num_iter):
        for key in ("feat_0", "feat_1", "pred_gaze_0", "pred_gaze_1"):
            np.testing.assert_allclose(
                got[f"iter_{i}"][key].numpy(), np.asarray(want[f"iter_{i}"][key]),
                atol=2e-4, rtol=1e-3, err_msg=f"iter_{i}.{key}",
            )
    np.testing.assert_allclose(
        got["pred_gaze"].numpy(), np.asarray(want["pred_gaze"]), atol=2e-4, rtol=1e-3
    )


R18 = {"backbone_depth": 18, "num_iter": 2}


@pytest.fixture(scope="module")
def r18():
    data = _data()
    return data, _jax_variables(R18, data)


def test_r18_backbone_features_match_jax(r18):
    data, variables = r18
    got, want = _run_both(R18, data, variables)
    for key in ("img_feat_0", "img_feat_1"):
        assert got[key].shape == (2, 512)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0)
    for key in ("initial_rot_feat_0", "initial_rot_feat_1"):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]), atol=2e-4, rtol=1e-3
        )


@pytest.mark.parametrize("use_pallas_fusion", [False, True], ids=["xla", "pallas"])
def test_r18_outputs_match_jax(r18, use_pallas_fusion):
    """Both JAX fuser paths: plain XLA, and the Pallas kernel in interpret mode."""
    data, variables = r18
    got, want = _run_both(R18, data, variables, use_pallas_fusion)
    assert got["num_iter"] == 2 and got["pred_gaze"].shape == (2, 2)
    _assert_outputs_close(got, want, 2)


def test_r50_three_iterations_match_jax():
    cfg = {"backbone_depth": 50, "num_iter": 3}
    data = _data(seed=1)
    got, want = _run_both(cfg, data, _jax_variables(cfg, data))
    assert got["img_feat_0"].shape == (2, 2048)
    _assert_outputs_close(got, want, 3)


def test_share_weights_matches_jax_and_aliases():
    cfg = {"backbone_depth": 18, "num_iter": 3, "share_weights": True}
    data = _data(seed=2)
    variables = _jax_variables(cfg, data)
    got, want = _run_both(cfg, data, variables)
    _assert_outputs_close(got, want, 3)
    model = _port_model(cfg, variables)
    assert model._img_fusers[0] is model._img_fusers[2]
    assert model._gaze_estimators[0] is model._gaze_estimators[1]


@pytest.mark.parametrize(
    "cfg", [R18, {"backbone_depth": 18, "num_iter": 3, "share_weights": True}],
    ids=["r18", "share_weights"],
)
def test_state_dict_from_jax_equals_jax_converter(r18, cfg):
    """Key for key and value for value, the JAX package's own exporter with
    strict_compatible=True; the port's model then loads it strictly."""
    _, variables = r18
    if cfg.get("share_weights"):
        variables = _jax_variables(cfg, _data(seed=2))
    got = state_dict_from_jax(variables, **cfg)
    want = flax_to_torch_state_dict(variables, strict_compatible=True, **cfg)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    model = FeatRotationSymm(**cfg)
    assert set(model.state_dict()) == set(got)
    model.load_state_dict(got, strict=True)


# each ablation with the flag the JAX model refuses beside it
REFUSED_WITH = {"encode_rotmat": "ignore_rotmat", "share_feature": "share_weights",
                "ignore_rotmat": "encode_rotmat"}


@pytest.mark.parametrize("ablation", ["encode_rotmat", "share_feature", "ignore_rotmat"])
def test_unported_ablations_raise(ablation):
    """The ablations are ported (tests/test_torch_ablations.py); what still
    raises is each one in a combination the JAX model refuses."""
    FeatRotationSymm(backbone_depth=18, num_iter=1, **{ablation: True})
    with pytest.raises(ValueError, match="cannot be combined"):
        FeatRotationSymm(backbone_depth=18, num_iter=1, **{ablation: True, REFUSED_WITH[ablation]: True})


def test_train_mode_forward_raises():
    """One 32x32 image per view in train mode: the train forward runs each
    view alone, so layer 4's BatchNorms see one value per channel. The port
    follows the JAX package there (batch variance 0, output act(bias [+
    residual]), running variance blended with 0 by ``n / max(n - 1, 1)``)
    and raises nothing: outputs at atol 2e-4 / rtol 1e-3, running statistics
    at 1e-4."""
    data = _data(batch=1, seed=3)
    variables = _jax_variables(R18, data, seed=3)
    want, updates = JaxFeatRotationSymm(**R18).apply(
        variables, jax.tree.map(jnp.asarray, data), train=True, mutable=["batch_stats"]
    )
    model = _port_model(R18, variables).train()
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in data.items()})
    assert model._feat_extractor[0].layer4[1].bn2.num_batches_tracked == 2  # once per view
    for key in ("img_feat_0", "img_feat_1", "initial_rot_feat_0", "initial_rot_feat_1"):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]), atol=2e-4, rtol=1e-3, err_msg=key
        )
    _assert_outputs_close(got, want, R18["num_iter"])
    new_vars = {**variables, "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])}
    state = model.state_dict()
    for key, value in state_dict_from_jax(new_vars, **R18).items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[key].numpy(), value.numpy(), atol=1e-4, rtol=0, err_msg=key)
