"""The port's train-mode BatchNorm (rot_mvgaze_tpu_torch.ops.batchnorm and
models.norm.BatchNormAct) against the JAX package's ``fused_batchnorm_act``
and ``PallasBatchNormAct``, whose Pallas kernels run in interpret mode on the
CPU. Bars are the JAX suite's (tests/test_pallas_bn.py): forward 1e-5,
gradients atol 5e-4 / rtol 1e-3, statistics cotangents 1e-5, running
statistics 1e-4. The port takes (N, C, H, W) channels_last, which is JAX's
NHWC array seen through a permute. The CUDA kernels themselves are held
against the plain versions in tests/test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.models.norm import PallasBatchNormAct
from rot_mvgaze_tpu.ops.batchnorm import fused_batchnorm_act as jax_fused_batchnorm_act
from rot_mvgaze_tpu_torch.models.norm import BatchNormAct
from rot_mvgaze_tpu_torch.ops import batchnorm


def _inputs(shape=(16, 8, 8, 128), seed=0):
    """NHWC numpy x, residual, and f32 scale / bias, as the JAX suite makes them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    c = shape[-1]
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    res = (rng.randn(*shape) * 0.5).astype(np.float32)
    return x, scale, bias, res


def _nchw(a: np.ndarray, grad=False) -> torch.Tensor:
    """NHWC numpy -> (N, C, H, W) channels_last view."""
    return torch.from_numpy(a.copy()).permute(0, 3, 1, 2).requires_grad_(grad)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


VARIANTS = pytest.mark.parametrize(
    "relu, with_res",
    [(False, False), (True, False), (False, True), (True, True)],
    ids=["linear", "relu", "res", "res_relu"],
)
SHAPES = pytest.mark.parametrize(
    "shape", [(16, 8, 8, 128), (4, 5, 7, 72)], ids=["c128", "ragged_c72"]
)


@VARIANTS
@SHAPES
def test_forward_matches_jax(relu, with_res, shape):
    x, scale, bias, res = _inputs(shape)
    res_in = res if with_res else None
    want = jax_fused_batchnorm_act(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        None if res_in is None else jnp.asarray(res_in), 1e-5, relu,
    )
    y, mean, var = batchnorm.fused_batchnorm_act(
        _nchw(x), torch.from_numpy(scale), torch.from_numpy(bias),
        None if res_in is None else _nchw(res_in), 1e-5, relu,
    )
    assert y.is_contiguous(memory_format=torch.channels_last) and y.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(y), np.asarray(want[0]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want[1]), atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(want[2]), atol=1e-5)


@VARIANTS
@SHAPES
def test_gradients_match_jax(relu, with_res, shape):
    """d/d(x, scale, bias, residual) of sum(y^2), the JAX suite's loss."""
    x, scale, bias, res = _inputs(shape, seed=1)
    res_in = res if with_res else None

    def jax_loss(args):
        x_, s_, b_, r_ = args
        y, _, _ = jax_fused_batchnorm_act(x_, s_, b_, r_, 1e-5, relu)
        return jnp.sum(y.astype(jnp.float32) ** 2)

    want = jax.grad(jax_loss)(
        (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
         None if res_in is None else jnp.asarray(res_in))
    )
    tx = _nchw(x, grad=True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    tr = None if res_in is None else _nchw(res_in, grad=True)
    y, _, _ = batchnorm.fused_batchnorm_act(tx, ts, tb, tr, 1e-5, relu)
    (y**2).sum().backward()
    got = [_nhwc(tx.grad), ts.grad.numpy(), tb.grad.numpy(), None if tr is None else _nhwc(tr.grad)]
    for name, a, b in zip(["x", "scale", "bias", "res"], got, want):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-4, rtol=1e-3, err_msg=f"grad {name}")


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
def test_statistics_cotangents_match_jax(relu):
    """Differentiating through the returned mean and var gives the true
    gradient, alone and beside y's."""
    x, scale, bias, _ = _inputs((2, 4, 4, 3), seed=2)

    def jax_loss(x_):
        y, mean, var = jax_fused_batchnorm_act(
            x_, jnp.asarray(scale), jnp.asarray(bias), None, 1e-5, relu
        )
        return jnp.sum(mean * 3.0) + jnp.sum(var * 0.5) + 0.25 * jnp.sum(y)

    want = jax.grad(jax_loss)(jnp.asarray(x))
    tx = _nchw(x, grad=True)
    y, mean, var = batchnorm.fused_batchnorm_act(
        tx, torch.from_numpy(scale), torch.from_numpy(bias), None, 1e-5, relu
    )
    ((mean * 3.0).sum() + (var * 0.5).sum() + 0.25 * y.sum()).backward()
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("with_res", [False, True], ids=["nores", "res"])
def test_batchnorm_act_running_statistics_match_jax(relu, with_res):
    """Train forward of the module: output, and torch-style running
    statistics (unbiased variance, momentum 0.1) after two calls, against
    PallasBatchNormAct's."""
    x, scale, bias, res = _inputs((4, 2, 2, 128), seed=3)
    x2 = x * 0.5 + 0.2
    res_in = res if with_res else None
    mod = PallasBatchNormAct(relu=relu, momentum=0.9)
    vs = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    vs = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
          "batch_stats": vs["batch_stats"]}
    jres = None if res_in is None else jnp.asarray(res_in)
    want_y, upd = mod.apply(vs, jnp.asarray(x), train=True, residual=jres, mutable=["batch_stats"])
    _, upd = mod.apply({**vs, **upd}, jnp.asarray(x2), train=True, residual=jres,
                       mutable=["batch_stats"])

    bn = BatchNormAct(128, relu=relu).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    tres = None if res_in is None else _nchw(res_in)
    got_y = bn(_nchw(x), tres)
    bn(_nchw(x2), tres)
    np.testing.assert_allclose(_nhwc(got_y), np.asarray(want_y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=1e-4)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), atol=1e-4)
    assert int(bn.num_batches_tracked) == 2


def test_batchnorm_act_eval_is_batchnorm2d_then_add_then_relu():
    x, scale, bias, res = _inputs((2, 3, 3, 16), seed=4)
    bn = BatchNormAct(16, relu=True).eval()
    plain = torch.nn.BatchNorm2d(16).eval()
    with torch.no_grad():
        for m in (bn, plain):
            m.weight.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(bias))
            m.running_mean.fill_(0.3)
            m.running_var.fill_(2.0)
        got = bn(_nchw(x), _nchw(res))
        want = torch.relu(plain(_nchw(x)) + _nchw(res))
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_batchnorm_act_keeps_batchnorm2d_keys():
    assert set(BatchNormAct(8).state_dict()) == set(torch.nn.BatchNorm2d(8).state_dict())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_versions_against_float64_two_pass(dtype):
    """The plain versions (the card's oracle) against a float64 two-pass
    formula, including a channel whose mean dwarfs its spread."""
    rng = np.random.RandomState(5)
    x = rng.randn(4096, 12)
    x[:, 3] = 100.0 + 0.01 * x[:, 3]
    scale, bias = rng.rand(12).astype(np.float32) + 0.5, rng.randn(12).astype(np.float32)
    mean, var, rstd, a, b = batchnorm.bn_stats_reference(
        torch.from_numpy(x).to(dtype), torch.from_numpy(scale), torch.from_numpy(bias), 1e-5
    )
    want_mean, want_var = x.mean(0), ((x - x.mean(0)) ** 2).mean(0)
    # float32 sums of 4,096 values: about 1e-5 relative; float64: 1e-12.
    # E[x^2]-E[x]^2 cancels 1e4 against 1e-4 in channel 3 (8 digits), which
    # only float64 survives: that is why the card's oracle runs in float64.
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    var_tol = 1e-4 if dtype == torch.float32 else 1e-7
    good = np.arange(12) != 3 if dtype == torch.float32 else np.arange(12) >= 0
    np.testing.assert_allclose(mean.double().numpy(), want_mean, atol=tol, rtol=tol)
    np.testing.assert_allclose(var.double().numpy()[good], want_var[good], rtol=var_tol)
    np.testing.assert_allclose(
        a.double().numpy(), scale / np.sqrt(var.double().numpy() + 1e-5), rtol=1e-6
    )
    np.testing.assert_allclose(
        b.double().numpy(), bias - mean.double().numpy() * a.double().numpy(), rtol=1e-6, atol=1e-6
    )


def test_cpu_calls_count_no_launches(monkeypatch):
    for k in batchnorm.KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    x, scale, bias, res = _inputs((2, 2, 2, 8))
    tx = _nchw(x, grad=True)
    y, _, _ = batchnorm.fused_batchnorm_act(
        tx, torch.from_numpy(scale), torch.from_numpy(bias), _nchw(res), 1e-5, True
    )
    y.sum().backward()
    assert [k.launches for k in batchnorm.KERNELS] == [0, 0, 0, 0]


def test_layout_copies_are_counted(monkeypatch):
    monkeypatch.setattr(batchnorm.fused_batchnorm_act, "grad_copies", 0)
    x, scale, bias, _ = _inputs((2, 3, 3, 8))
    contiguous = _nchw(x).contiguous().requires_grad_(True)  # NCHW, not channels_last
    y, _, _ = batchnorm.fused_batchnorm_act(
        contiguous, torch.from_numpy(scale), torch.from_numpy(bias), None, 1e-5, True
    )
    y.backward(torch.ones(y.shape))  # an NCHW-contiguous gradient
    assert batchnorm.fused_batchnorm_act.grad_copies == 1
    want, _, _ = batchnorm.fused_batchnorm_act(
        _nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), None, 1e-5, True
    )
    torch.testing.assert_close(y, want, atol=0, rtol=0)


@pytest.mark.parametrize(
    "mutate, error",
    [
        (lambda a: (a[0].double(),) + a[1:], TypeError),
        (lambda a: (a[0], a[1].double(), a[2]), ValueError),
        (lambda a: (a[0], a[1][:-1], a[2]), ValueError),
        (lambda a: (a[0][:, :-1],) + a[1:], ValueError),
    ],
    ids=["f64-x", "f64-scale", "short-scale", "non-contiguous"],
)
def test_wrappers_reject_bad_inputs(mutate, error):
    x = torch.randn(32, 8)
    args = (x, torch.ones(8), torch.zeros(8))
    with pytest.raises(error):
        batchnorm.bn_stats(*mutate(args), 1e-5)


@pytest.mark.parametrize(
    "rows, c, itemsize, per_sm, want",
    [
        (802_816, 64, 2, 8, (8, 768, 1046, 1)),  # stem, bf16, 132 SMs, elementwise
        (802_816, 64, 2, 3, (8, 2048, 392, 1)),  # stem, reduction
        (200_704, 256, 2, 8, (32, 192, 1046, 1)),  # layer-1 tail
        (3_136, 2_048, 2, 8, (32, 24, 131, 8)),  # layer-4 downsample
        (3_136, 2_048, 2, 3, (32, 64, 49, 8)),
        (2_450, 72, 2, 8, (16, 16, 154, 1)),  # ragged
        (3, 5, 4, 8, (2, 128, 1, 1)),  # tiny
    ],
)
def test_plan(rows, c, itemsize, per_sm, want):
    lanes, chunk_rows, chunks, tiles = batchnorm.plan(rows, c, itemsize, 132, per_sm)
    assert (lanes, chunk_rows, chunks, tiles) == want
    v = 16 // itemsize
    assert tiles * lanes * v >= c > (tiles - 1) * lanes * v
    assert chunk_rows <= batchnorm.MAX_CHUNK_ROWS and chunk_rows % (256 // lanes) == 0
    assert (chunks - 1) * chunk_rows < rows <= chunks * chunk_rows


@pytest.mark.parametrize(
    "rows, c, itemsize, per_sm, want",
    [
        (802_816, 64, 2, 4, (8, 1536, 523, 1, 33)),  # stem, bf16, bn_bwd_reduce's plan
        (802_816, 64, 2, 6, (8, 1024, 784, 1, 49)),  # stem, bn_stats' plan
        (200_704, 256, 2, 4, (8, 1536, 131, 4, 9)),  # layer-1 tail: 4 channel tiles
        (3_136, 2_048, 2, 4, (8, 192, 17, 32, 2)),  # layer-4 downsample
        (2_450, 72, 2, 4, (8, 16, 154, 2, 10)),  # ragged
        (802_816, 64, 4, 6, (8, 2032, 396, 2, 25)),  # stem, f32
        (3, 5, 4, 6, (2, 64, 1, 1, 1)),  # tiny
    ],
)
def test_plan_reduce(rows, c, itemsize, per_sm, want):
    """The reductions' plan: at most 8 lanes of 128 threads, one wave of
    ``per_sm`` blocks per SM, chunk partials summed in groups of 16."""
    lanes, chunk_rows, chunks, tiles, groups = batchnorm.plan_reduce(rows, c, itemsize, 132, per_sm)
    assert (lanes, chunk_rows, chunks, tiles, groups) == want
    v = 16 // itemsize
    assert lanes <= 8 and tiles * lanes * v >= c > (tiles - 1) * lanes * v
    assert chunk_rows <= batchnorm.MAX_CHUNK_ROWS and chunk_rows % (128 // lanes) == 0
    assert (chunks - 1) * chunk_rows < rows <= chunks * chunk_rows
    assert groups == -(-chunks // batchnorm.REDUCE_GROUP)
