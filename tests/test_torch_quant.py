"""The port's int8 eval path (rot_mvgaze_tpu_torch.ops.quant,
models.resnet.QuantConv2d) against the JAX package's (rot_mvgaze_tpu.ops.quant,
models.resnet.QuantConv) on the CPU, on the same seeded numpy inputs.

Bars: quantize_symmetric's q bit for bit and its scale equal; int8_conv and
int8_dense equal in float32 (both sum int8 products exactly and rescale in
the same order); the int8 model's pred_gaze at the model bar, atol 2e-4 /
rtol 1e-3 (tests/test_model_parity.py:120), dynamic and static. The plain
int32 product and its im2col lowering are held to a float64 convolution of
the int8 values bit for bit.

Why the model tests fold every BatchNorm to the identity (running mean 0,
running variance 0.99999, so that var + eps is 1.0 exactly, scale 1, bias
0): each quantizer turns a float32 difference of one ulp at its input into
a whole int8 step when the value sits at a rounding boundary, and XLA's
eval BatchNorm on the CPU rounds otherwise than PyTorch's (its rsqrt is
not 1/sqrt correctly rounded: at random variances about 40% of channels
differ by an ulp). With the identity fold every float operation between two
quantizers (the rescale, the residual add, ReLU, max-pool) is the same
IEEE operation in both packages, so the backbone is bit for bit and the
model bar holds. With random BN statistics a flipped step moves a row's
pred_gaze by up to 7.4e-3 (measured over 8 batches); that case is held to
the int8 path's own accuracy budget instead (:data:`FLIP_BAR`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.compat import flax_to_torch_state_dict
from rot_mvgaze_tpu.geometry import rotation_matrix_2d as jax_rotation_matrix_2d
from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu.ops import quant as jax_quant
from rot_mvgaze_tpu.train.checkpoints import save_state as jax_save_state
from rot_mvgaze_tpu_torch.models import FeatRotationSymm
from rot_mvgaze_tpu_torch.models.resnet import QuantConv2d, calibrating
from rot_mvgaze_tpu_torch.ops import quant

CFG = {"backbone_depth": 18, "num_iter": 2}
SIZE = 32
MODEL_BAR = dict(atol=2e-4, rtol=1e-3)
# port int8 against JAX int8 with random BN statistics, where a float32 ulp
# can flip one int8 step in one package only: the JAX suite's own bar for
# int8 against float32 pred_gaze (tests/test_quant.py: 0.3 rad), cut
# tenfold
FLIP_BAR = 0.03


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize(
    "shape, reduce_dims",
    [((5, 7), None), ((5, 7), (0,)), ((3, 3, 4, 6), (0, 1, 2)), ((2, 8, 8, 4), None)],
    ids=["per-tensor", "per-column", "per-output-channel", "activation"],
)
def test_quantize_symmetric_equals_jax(shape, reduce_dims):
    """tests/test_quant.py's cases (and the conv's two uses): q bit for bit,
    the scale equal, rounding half to even as jnp.round."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    # values that land on .5 steps after scaling exercise the rounding mode
    x.flat[0] = np.abs(x).max()
    x.flat[1] = x.flat[0] * (2.5 / 127.0)
    q, s = quant.quantize_symmetric(_t(x), reduce_dims)
    jq, js = jax_quant.quantize_symmetric(jnp.asarray(x), reduce_dims)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_rounds_half_to_even():
    q = quant.quantize_with_scale(torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0]), torch.tensor(1.0))
    assert q.tolist() == [0, 2, 2, 0, -2, 127]


CONV_CASES = {
    "3x3": ((2, 8, 8, 4), (3, 3, 4, 6), 1, 1, 1),
    "3x3_s2": ((2, 9, 9, 16), (3, 3, 16, 32), 2, 1, 1),
    "stem_7x7_s2": ((2, 16, 16, 3), (7, 7, 3, 8), 2, 3, 1),
    "1x1": ((2, 6, 6, 16), (1, 1, 16, 24), 1, 0, 1),
    "1x1_s2": ((2, 7, 7, 16), (1, 1, 16, 24), 2, 0, 1),
    "grouped": ((2, 8, 8, 16), (3, 3, 4, 32), 1, 1, 4),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "act_scale"])
def test_int8_conv_equals_jax(case, static):
    xs, ks, stride, pad, groups = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal(xs).astype(np.float32)
    k = (rng.standard_normal(ks) * 0.1).astype(np.float32)
    act = np.float32(np.abs(x).max() * 0.8 / 127.0) if static else None
    want = np.asarray(jax_quant.int8_conv(
        jnp.asarray(x), jnp.asarray(k), (stride, stride), [(pad, pad), (pad, pad)],
        feature_group_count=groups, act_scale=None if act is None else jnp.asarray(act)))
    got = quant.int8_conv(
        _t(x).permute(0, 3, 1, 2), _t(k).permute(3, 2, 0, 1), stride, pad, groups,
        act_scale=None if act is None else torch.tensor(act))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_im2col_product_equals_float64_conv(case):
    """The card's lowering (im2col rows through int8_matmul, here its plain
    version) is bit for bit the plain float64 convolution of the int8
    values, at full-range int8 inputs."""
    xs, ks, stride, pad, groups = CONV_CASES[case]
    g = torch.Generator().manual_seed(3)
    x8 = torch.randint(-127, 128, (xs[0], xs[3], xs[1], xs[2]), generator=g, dtype=torch.int8)
    x8 = x8.to(memory_format=torch.channels_last)
    w8 = torch.randint(-127, 128, (ks[3], ks[2], ks[0], ks[1]), generator=g, dtype=torch.int8)
    got = quant.int8_conv_accumulate_im2col(x8, w8, stride, pad, groups)
    want = quant.int8_conv_accumulate_reference(x8, w8, stride, pad, groups)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)


def test_int8_matmul_reference_is_exact_at_the_widest_sum():
    """127^2 * 4608 (R50's widest K) is summed exactly."""
    a = torch.full((3, 4608), 127, dtype=torch.int8)
    b = torch.full((4608, 2), -127, dtype=torch.int8)
    assert quant.int8_matmul(a, b).tolist() == [[-127 * 127 * 4608] * 2] * 3


def test_int8_matmul_rejects_bad_inputs():
    with pytest.raises(TypeError):
        quant.int8_matmul(torch.zeros(4, 4), torch.zeros(4, 4, dtype=torch.int8))
    with pytest.raises(ValueError):
        quant.int8_matmul(torch.zeros(4, 3, dtype=torch.int8), torch.zeros(4, 4, dtype=torch.int8))


def test_int8_dense_equals_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    want = np.asarray(jax_quant.int8_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = quant.int8_dense(_t(x), _t(w.T), _t(b))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- model


def _init(model):
    s = jnp.zeros((1, SIZE, SIZE, 3))
    eye = jnp.broadcast_to(jnp.eye(3), (1, 3, 3))
    return model.init(jax.random.PRNGKey(0), {"img_0": s, "img_1": s, "rot_0": eye, "rot_1": eye})


def _identity_bn(v):
    """``v`` with every backbone BatchNorm folded to the identity (see the
    module docstring)."""
    v = jax.tree.map(np.array, v)

    def fold(path, a):
        name = jax.tree_util.keystr(path)
        if "'backbone'" not in name:
            return a
        for key, value in (("'mean'", 0.0), ("'var'", 0.99999), ("'scale'", 1.0), ("'bias'", 0.0)):
            if key in name:
                return np.full_like(a, value)
        return a

    bn = lambda tree: jax.tree_util.tree_map_with_path(  # noqa: E731
        lambda p, a: fold(p, a) if ("'bn" in jax.tree_util.keystr(p) or "'downsample'" in
                                    jax.tree_util.keystr(p)) else a, tree)
    return {"params": bn(v["params"]), "batch_stats": bn(v["batch_stats"])}


@pytest.fixture(scope="module")
def random_stats():
    """JAX R18 variables with non-trivial BN running statistics."""
    v = jax.tree.map(np.asarray, _init(JaxFeatRotationSymm(**CFG)))
    rng = np.random.default_rng(1)

    def stats(path, a):
        name = jax.tree_util.keystr(path)
        if "'mean'" in name:
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    v["batch_stats"] = jax.tree_util.tree_map_with_path(stats, v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def variables(random_stats):
    """The same variables with every backbone BatchNorm the identity."""
    return _identity_bn(random_stats)


def _data(seed, n=4):
    rng = np.random.default_rng(seed)
    hp = rng.uniform(-0.5, 0.5, (2, n, 2)).astype(np.float32)
    return {
        "img_0": rng.normal(size=(n, SIZE, SIZE, 3)).astype(np.float32),
        "img_1": rng.normal(size=(n, SIZE, SIZE, 3)).astype(np.float32),
        "rot_0": np.asarray(jax_rotation_matrix_2d(jnp.asarray(hp[0]))),
        "rot_1": np.asarray(jax_rotation_matrix_2d(jnp.asarray(hp[1]))),
    }


def _port_model(variables, int8):
    model = FeatRotationSymm(**CFG, int8_backbone=int8)
    sd = flax_to_torch_state_dict(variables, strict_compatible=True, **CFG)
    model.load_state_dict({k: _t(np.array(v)) for k, v in sd.items()}, strict=True)
    return model.eval()


def test_int8_model_state_dict_is_the_float_models(variables):
    float_keys = FeatRotationSymm(**CFG).state_dict().keys()
    for int8 in (True, "static"):
        model = _port_model(variables, int8)
        assert model.state_dict().keys() == float_keys
        convs = [m for m in model.modules() if isinstance(m, QuantConv2d)]
        assert len(convs) == 20 and all(m.int8 == int8 for m in convs)
        assert all(("act_amax" in dict(m.named_buffers())) == (int8 == "static") for m in convs)


def test_int8_model_loads_a_jax_msgpack_strictly(variables):
    import tempfile

    from rot_mvgaze_tpu_torch.compat import load_checkpoint

    with tempfile.TemporaryDirectory() as root:  # ~100 MB: not left behind
        path = f"{root}/v.msgpack"
        jax_save_state(path, variables)
        for int8 in (True, "static"):
            model = FeatRotationSymm(**CFG, int8_backbone=int8)
            model.load_state_dict(load_checkpoint(path, **CFG), strict=True)


def test_int8_dynamic_model_matches_jax(variables):
    data = _data(5)
    want = JaxFeatRotationSymm(**CFG, int8_backbone=True).apply(
        variables, jax.tree.map(jnp.asarray, data), train=False)
    with torch.no_grad():
        got = _port_model(variables, True)({k: _t(v) for k, v in data.items()})
    np.testing.assert_allclose(got["img_feat_0"].numpy(), np.asarray(want["img_feat_0"]), **MODEL_BAR)
    np.testing.assert_allclose(got["pred_gaze"].numpy(), np.asarray(want["pred_gaze"]), **MODEL_BAR)


def test_int8_static_model_matches_jax(variables):
    """Calibrate on one batch (quantizing dynamically while the ranges are
    recorded), then a frozen pass on another: ranges rtol 1e-6, both
    passes' pred_gaze at the model bar."""
    jax_model = JaxFeatRotationSymm(**CFG, int8_backbone="static")
    quant0 = _init(jax_model)["quant"]
    calib, frozen = _data(6), _data(7)
    want_c, upd = jax_model.apply({**variables, "quant": quant0}, jax.tree.map(jnp.asarray, calib),
                                  train=False, mutable=["quant"])
    want_f = jax_model.apply({**variables, "quant": upd["quant"]}, jax.tree.map(jnp.asarray, frozen),
                             train=False)
    model = _port_model(variables, "static")
    with torch.no_grad():
        with calibrating(model):
            got_c = model({k: _t(v) for k, v in calib.items()})
        got_f = model({k: _t(v) for k, v in frozen.items()})
    from rot_mvgaze_tpu_torch.compat.convert import conv_entries

    for e in conv_entries(18):
        jax_amax = upd["quant"]
        for p in e.jax_path:
            jax_amax = jax_amax[p]
        np.testing.assert_allclose(model.get_submodule(e.torch_key).act_amax.item(),
                                   float(jax_amax["act_amax"]), rtol=1e-6)
    np.testing.assert_allclose(got_c["pred_gaze"].numpy(), np.asarray(want_c["pred_gaze"]), **MODEL_BAR)
    np.testing.assert_allclose(got_f["pred_gaze"].numpy(), np.asarray(want_f["pred_gaze"]), **MODEL_BAR)


def test_identity_bn_is_exact_in_both_packages(variables):
    """The folded BatchNorm is the identity in JAX too (rsqrt(1.0) = 1)."""
    from rot_mvgaze_tpu.models.norm import TorchBatchNorm

    x = np.random.default_rng(0).normal(size=(2, 4, 4, 64)).astype(np.float32)
    bn = variables["params"]["backbone"]["bn1"], variables["batch_stats"]["backbone"]["bn1"]
    y = TorchBatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5).apply(
        {"params": bn[0], "batch_stats": bn[1]}, jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(y), x)


@pytest.mark.parametrize("int8", [True, "static"], ids=["dynamic", "static"])
def test_int8_model_with_random_bn_statistics_tracks_jax(random_stats, int8):
    """Random BN statistics, four batches: every row within FLIP_BAR of
    JAX's."""
    jax_model = JaxFeatRotationSymm(**CFG, int8_backbone=int8)
    model = _port_model(random_stats, int8)
    variables = dict(random_stats)
    if int8 == "static":
        calib = _data(20)
        _, upd = jax_model.apply({**variables, "quant": _init(jax_model)["quant"]},
                                 jax.tree.map(jnp.asarray, calib), train=False, mutable=["quant"])
        variables["quant"] = upd["quant"]
        with torch.no_grad(), calibrating(model):
            model({k: _t(v) for k, v in calib.items()})
    deltas = []
    for seed in range(21, 25):
        data = _data(seed)
        want = np.asarray(jax_model.apply(variables, jax.tree.map(jnp.asarray, data), train=False)["pred_gaze"])
        with torch.no_grad():
            got = model({k: _t(v) for k, v in data.items()})["pred_gaze"].numpy()
        deltas.append(np.abs(got - want).max(axis=1))
    deltas = np.concatenate(deltas)
    assert deltas.max() <= FLIP_BAR, deltas


def test_uncalibrated_static_model_uses_the_guard_range(variables):
    """act_amax 0 freezes |x| <= 8 (JAX's guard): the same as JAX's
    never-calibrated frozen pass."""
    jax_model = JaxFeatRotationSymm(**CFG, int8_backbone="static")
    data = _data(8)
    want = jax_model.apply({**variables, "quant": _init(jax_model)["quant"]},
                           jax.tree.map(jnp.asarray, data), train=False)
    with torch.no_grad():
        got = _port_model(variables, "static")({k: _t(v) for k, v in data.items()})
    np.testing.assert_allclose(got["pred_gaze"].numpy(), np.asarray(want["pred_gaze"]), **MODEL_BAR)


def test_int8_train_mode_is_the_float_model(variables):
    """Training stays exact: in train mode the int8 model is the float one."""
    data = {k: _t(v) for k, v in _data(9).items()}
    torch.manual_seed(0)
    a = _port_model(variables, True).train()(data)["pred_gaze"]
    b = _port_model(variables, False).train()(data)["pred_gaze"]
    assert torch.equal(a, b)


def test_act_amax_stays_float32_under_a_dtype_cast(variables):
    model = _port_model(variables, "static").to(torch.bfloat16)
    convs = [m for m in model.modules() if isinstance(m, QuantConv2d)]
    assert all(m.act_amax.dtype == torch.float32 for m in convs)
    assert all(m.weight.dtype == torch.bfloat16 for m in convs)


def test_quantized_weight_cache_follows_the_weight(variables):
    model = _port_model(variables, True)
    conv = model._feat_extractor[0].conv1
    first = conv._quantized_weight()
    assert conv._quantized_weight() is first
    with torch.no_grad():
        conv.weight.mul_(2.0)
    w8, sw = conv._quantized_weight()
    want8, want_s = quant.quantize_conv_weight(conv.weight)
    assert torch.equal(w8, want8) and torch.equal(sw, want_s)
