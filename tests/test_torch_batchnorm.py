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
        (12_544, 1_024, 2, 6, (8, 256, 49, 16, 4)),  # layer-3 tail, bn_stats
        (3_136, 512, 2, 6, (8, 32, 98, 8, 7)),  # layer-4 block, bn_stats
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


def _finite_bf16_bits() -> np.ndarray:
    bits = np.arange(1 << 16, dtype=np.uint64)
    return bits[((bits >> 7) & 0xFF) != 0xFF]


def _square_exact_in_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns whose square is a normal f32 or 0: |v| in
    [2^-63, 2^64) (|bits| in [0x2000, 0x5F80)), or v = 0."""
    a = bits & 0x7FFF
    return (a == 0) | ((a >= 0x2000) & (a < 0x5F80))


def test_bf16_square_widened_once_equals_the_f32_square():
    """The identity bn_stats' one widening per element rests on
    (csrc/batchnorm.cu::stats_add): over every finite bf16 pattern whose
    square is a normal f32 or 0, v.double() * v.double() equals
    (v.float() * v.float()).double() bit for bit. Outside that range the f32
    square overflows or underflows and the two differ, so the kernel sends
    a row holding such a value to the f32 product."""
    bits = _finite_bf16_bits()
    v = torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(torch.bfloat16)
    wide = (v.double() * v.double()).view(torch.int64).numpy()
    f32 = (v.float() * v.float()).double().view(torch.int64).numpy()
    in_range = _square_exact_in_f32(bits)
    assert in_range.sum() == 2 * (1 + 0x5F80 - 0x2000)  # ±0 and the range, both signs
    assert (wide[in_range] == f32[in_range]).all()
    big = (bits & 0x7FFF) >= 0x5F80
    assert np.isinf(f32.view(np.float64)[big]).all() and np.isfinite(wide.view(np.float64)[big]).all()
    assert (wide != f32).sum() > big.sum()  # tiny values too


def _squares_exact_in_f32_words(words: np.ndarray) -> np.ndarray:
    """csrc/batchnorm.cu::squares_exact_in_f32 on 32-bit words of two bf16
    each (uint64 arithmetic: no sum below reaches 2^32)."""
    h = words & 0x7FFF7FFF
    bad = ((h + 0x7FFF7FFF) & ~(h + 0x60006000)) | (h + 0x20802080)
    return (bad & 0x80008000) == 0


@pytest.mark.parametrize("half", ["low", "high"])
def test_squares_exact_test_takes_two_bf16_per_word(half):
    """The kernel's range test of two bf16 at a time in one 32-bit word is
    the range test of each: every bf16 pattern in one half, beside the
    edges of the range, specials and seeded patterns in the other."""
    every = np.arange(1 << 16, dtype=np.uint64)
    edges = [0, 0x8000, 0x0001, 0x1FFF, 0x2000, 0x9FFF, 0xA000, 0x5F7F, 0x5F80, 0xDF7F, 0xDF80,
             0x3F80, 0x7F80, 0x7FC0, 0x7FFF, 0xFFFF]
    others = np.concatenate([np.array(edges, np.uint64),
                             np.random.RandomState(0).randint(0, 1 << 16, 48).astype(np.uint64)])
    for o in others:
        words = every | (o << 16) if half == "low" else o | (every << 16)
        want = _square_exact_in_f32(every) & _square_exact_in_f32(np.array([o]))[0]
        assert (_squares_exact_in_f32_words(words) == want).all(), hex(int(o))


# the distinct (rows, C) of bn_bwd_dx's 106 calls in one R50 step at 64
# pairs, and a ragged one
DX_STEP_SHAPES = [
    (802_816, 64), (200_704, 64), (200_704, 128), (200_704, 256), (50_176, 128), (50_176, 256),
    (50_176, 512), (12_544, 256), (12_544, 512), (12_544, 1024), (3_136, 512), (3_136, 2_048),
    (2_450, 72),
]


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("rows, c", DX_STEP_SHAPES, ids=[f"{r}x{c}" for r, c in DX_STEP_SHAPES])
def test_dx_plan_covers_every_row_once(rows, c, itemsize):
    """bn_bwd_dx's one-wave plan on 132 SMs: thread t of a block walks rows
    chunk*chunk_rows + t//lanes + j*(256//lanes) of its chunk (coords in
    csrc/batchnorm.cu); over all chunks every row is walked exactly once,
    the channel tiles cover C, the blocks fit one wave of
    BWD_DX_BLOCKS_PER_SM per SM, and a chunk is whole passes of
    BWD_DX_ROWS rows per thread."""
    lanes, chunk_rows, chunks, tiles = batchnorm.plan_dx(rows, c, itemsize, 132)
    rstep = batchnorm._THREADS // lanes
    walked = np.zeros(rows, np.int64)
    for chunk in range(chunks):
        lo, hi = chunk * chunk_rows, min(rows, (chunk + 1) * chunk_rows)
        for t in range(rstep):
            walked[lo + t:hi:rstep] += 1
    assert (walked == 1).all()
    v = 16 // itemsize
    assert tiles * lanes * v >= c > (tiles - 1) * lanes * v
    assert chunks * tiles <= batchnorm.BWD_DX_BLOCKS_PER_SM * 132
    assert chunk_rows % (rstep * batchnorm.BWD_DX_ROWS) == 0
