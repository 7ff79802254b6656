"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on the same inputs. They skip without a card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies; ``tests/conftest.py`` imports JAX,
hence ``--noconftest``:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from rot_mvgaze_tpu_torch.geometry import rotation_matrix_2d
from rot_mvgaze_tpu_torch.ops import batchnorm, conv_bn, fusion


@pytest.fixture
def cuda():
    """Skips without a card; turns TF32 off so float32 means float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fusion_inputs(b, d, v, h, dtype, device, seed=3):
    rng = np.random.RandomState(seed)
    t = lambda a, dt=dtype: torch.from_numpy(a.astype(np.float32)).to(device, dt)  # noqa: E731
    rot = rotation_matrix_2d(torch.from_numpy(rng.uniform(-0.8, 0.8, (b, 2)).astype(np.float32)))
    return (
        t(rng.randn(b, d) * 0.1),
        t(rng.randn(b, 3, v) * 0.1),
        rot.to(device).contiguous(),
        t(rng.randn(h, d + 3 * v) * 0.02),
        t(rng.randn(h) * 0.01, torch.float32),
    )


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b, d, v, h",
    [(64, 2048, 512, 3584), (1, 2048, 512, 3584), (50, 2048, 512, 3584),
     (64, 2048, 512, 1000), (7, 100, 36, 90), (200, 2048, 512, 3584), (64, 512, 512, 2048),
     (16, 200, 40, 96)],
    ids=["serving", "b1", "b50", "h1000", "unaligned", "b200", "r18", "d200_v40"],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fusion_kernel_matches_reference(cuda, b, d, v, h, dtype):
    """f32 with TF32 off: atol/rtol 1e-4. bf16, compared in f32: atol/rtol
    2e-2 (one bf16 ulp is 2^-8 and K reaches 3584). bf16 with D and V
    multiples of 64 runs the wgmma variant, everything else the generic one;
    two calls agree bit for bit."""
    args = _fusion_inputs(b, d, v, h, dtype, cuda)
    want_variant = "wgmma" if dtype == torch.bfloat16 and d % 64 == 0 and v % 64 == 0 else "generic"
    before = fusion.rotate_concat_matmul_relu.launches
    by_variant = dict(fusion.rotate_concat_matmul_relu.launches_by_variant)
    got = fusion.rotate_concat_matmul_relu(*args)
    torch.cuda.synchronize()
    assert fusion.rotate_concat_matmul_relu.launches == before + 1
    by_variant[want_variant] += 1
    assert fusion.rotate_concat_matmul_relu.launches_by_variant == by_variant
    assert got.dtype == dtype and got.shape == (b, h)
    want = fusion.rotate_concat_matmul_relu_reference(*args)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(fusion.rotate_concat_matmul_relu(*args), got)


@pytest.mark.gpu
def test_fusion_misaligned_bf16_takes_generic_variant(cuda):
    """A bf16 image feature that starts 2 bytes past a 16-byte boundary
    (contiguous, D and V multiples of 64) is routed to the generic variant,
    as choose_variant documents, and still matches the plain version."""
    img, feat, rot, w1, b1 = _fusion_inputs(64, 2048, 512, 3584, torch.bfloat16, cuda)
    shifted = torch.empty(img.numel() + 1, dtype=img.dtype, device=cuda)[1:].view_as(img)
    shifted.copy_(img)
    assert shifted.data_ptr() % 16 != 0
    assert fusion.choose_variant(shifted, feat, w1) == "generic"
    before = fusion.rotate_concat_matmul_relu.launches_by_variant["generic"]
    got = fusion.rotate_concat_matmul_relu(shifted, feat, rot, w1, b1)
    torch.cuda.synchronize()
    assert fusion.rotate_concat_matmul_relu.launches_by_variant["generic"] == before + 1
    want = fusion.rotate_concat_matmul_relu_reference(img, feat, rot, w1, b1)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_fusion_kernel_rejects_non_contiguous(cuda):
    args = _fusion_inputs(8, 64, 16, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        fusion.rotate_concat_matmul_relu(args[0], args[1], args[2], args[3].T.contiguous().T, args[4])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fusion_gradients_match_autograd_through_plain(cuda, dtype):
    """The Function (kernel forward, plain-product backward) against autograd
    through the plain version at the serving shape. f32: atol 5e-4 / rtol
    1e-3, the JAX suite's gradient bar. bf16: norm-relative 2e-2, since h is
    rounded to bf16 on both sides and an h within rounding of 0 may take the
    ReLU mask either way."""
    args = _fusion_inputs(64, 2048, 512, 3584, dtype, cuda)
    grad_out = torch.randn(64, 3584, device=cuda, generator=torch.Generator(cuda).manual_seed(0)).to(dtype)

    def grads(fn):
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        fn(*leaves).backward(grad_out)
        return [t.grad.float() for t in leaves]

    got = grads(fusion.RotateConcatMatmulRelu.apply)
    want = grads(fusion.rotate_concat_matmul_relu_reference)
    for name, a, b in zip(["img", "feat", "rot", "w1", "b1"], got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=5e-4, rtol=1e-3, msg=name)
        else:
            assert float((a - b).norm() / b.norm()) < 2e-2, name


BN_CASES = [  # rows, C, relu, residual: the shapes of the R50 step at 64 pairs
    (802_816, 64, True, False),  # stem
    (200_704, 256, True, True),  # a layer-1 block tail
    (3_136, 2_048, False, False),  # layer-4 downsample
    (2_450, 72, True, True),  # ragged rows and channels
]


def _bn_inputs(rows, c, dtype, device, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    x = (torch.randn(rows, c, device=device, generator=g) * 2 + 0.5).to(dtype)
    res = torch.randn(rows, c, device=device, generator=g).to(dtype)
    gy = torch.randn(rows, c, device=device, generator=g).to(dtype)
    scale = torch.rand(c, device=device, generator=g) + 0.5
    bias = torch.randn(c, device=device, generator=g) * 0.1
    return x, res, gy, scale, bias


@pytest.mark.gpu
@pytest.mark.parametrize("case", BN_CASES, ids=["stem", "l1_tail", "l4_down", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bn_kernels_match_float64_plain(cuda, case, dtype):
    """The four kernels against their plain versions run in float64 on the
    same inputs. Per-channel results (mean, var, dscale, dbias): forward
    1e-5, gradients atol 5e-4 / rtol 1e-3 (tests/test_pallas_bn.py), in both
    dtypes, since the kernels read the same values and sum in f32 and f64.
    Per-element outputs (y, dx): the same bars in f32; in bf16 each is
    rounded once (half an ulp is 2^-9 of its value), so atol / rtol 1e-2.
    dres (= g masked by y > 0) is exact. The plain backward takes the
    kernel's y, so both use one ReLU mask. The reductions repeat bit for
    bit."""
    rows, c, relu, with_res = case
    x, res, gy, scale, bias = _bn_inputs(rows, c, dtype, cuda)
    res = res if with_res else None
    launches = [k.launches for k in batchnorm.KERNELS]
    mean, var, rstd, a, b = batchnorm.bn_stats(x, scale, bias, 1e-5)
    y = batchnorm.bn_apply(x, a, b, res, relu)
    dscale, dbias, k, mg, mgx = batchnorm.bn_bwd_reduce(gy, y, x, mean, rstd, scale, relu)
    gmean, gvar = torch.randn(c, device=cuda), torch.randn(c, device=cuda)
    dx, dres = batchnorm.bn_bwd_dx(gy, y, x, mean, rstd, k, mg, mgx, gmean, gvar, relu, relu and with_res)
    torch.cuda.synchronize()
    assert [k.launches for k in batchnorm.KERNELS] == [n + 1 for n in launches]
    # the reductions are deterministic: a second call agrees bit for bit
    for got_t, again_t in zip(
        (mean, var, rstd, a, b, dscale, dbias, k, mg, mgx),
        (*batchnorm.bn_stats(x, scale, bias, 1e-5),
         *batchnorm.bn_bwd_reduce(gy, y, x, mean, rstd, scale, relu)),
    ):
        assert torch.equal(got_t, again_t)

    d = lambda t: None if t is None else t.double()  # noqa: E731
    x64, s64, b64 = d(x), d(scale), d(bias)
    p_mean, p_var, p_rstd, p_a, p_b = batchnorm.bn_stats_reference(x64, s64, b64, 1e-5)
    p_y = batchnorm.bn_apply_reference(x64, p_a, p_b, d(res), relu)
    p_ds, p_db, p_k, p_mg, p_mgx = batchnorm.bn_bwd_reduce_reference(d(gy), d(y), x64, p_mean, p_rstd, s64, relu)
    p_dx, p_dres = batchnorm.bn_bwd_dx_reference(
        d(gy), d(y), x64, p_mean, p_rstd, p_k, p_mg, p_mgx, d(gmean), d(gvar), relu, relu and with_res
    )
    close = lambda a_, b_, tol: torch.testing.assert_close(a_.double(), b_, atol=tol[0], rtol=tol[1])  # noqa: E731
    f32 = dtype == torch.float32
    close(mean, p_mean, (1e-5, 1e-5))
    close(var, p_var, (1e-5, 1e-5))
    close(y, p_y, (1e-5, 1e-5) if f32 else (1e-2, 1e-2))
    close(dscale, p_ds, (5e-4, 1e-3))
    close(dbias, p_db, (5e-4, 1e-3))
    close(dx, p_dx, (5e-4, 1e-3) if f32 else (1e-2, 1e-2))
    if dres is not None:
        torch.testing.assert_close(dres.double(), p_dres, atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bn_kernels_one_value_per_channel(cuda, dtype):
    """A (1, C) view: one value per channel, as in R18's layer 4 with one
    32x32 image per view in train mode. The kernels agree with their plain
    versions in the same dtype (the plain versions take the kernels' steps,
    so atol/rtol 1e-6); the batch variance is 0 up to the rounding of x²
    (exactly 0 in bf16), dx is exactly 0, and y = relu(bias + res) up to the
    rounding of x*a near 316*|x| (atol 2e-3 in f32, 2e-2 in bf16)."""
    x, res, gy, scale, bias = _bn_inputs(1, 64, dtype, cuda, seed=5)
    mean, var, rstd, a, b = batchnorm.bn_stats(x, scale, bias, 1e-5)
    y = batchnorm.bn_apply(x, a, b, res, True)
    got_bwd = batchnorm.bn_bwd_reduce(gy, y, x, mean, rstd, scale, True)
    dx, dres = batchnorm.bn_bwd_dx(gy, y, x, mean, rstd, *got_bwd[2:], None, None, True, True)
    torch.cuda.synchronize()
    want = batchnorm.bn_stats_reference(x, scale, bias, 1e-5)
    want_y = batchnorm.bn_apply_reference(x, want[3], want[4], res, True)
    want_bwd = batchnorm.bn_bwd_reduce_reference(gy, y, x, want[0], want[2], scale, True)
    want_dx, _ = batchnorm.bn_bwd_dx_reference(gy, y, x, want[0], want[2], *want_bwd[2:], None, None, True, True)
    for got_t, want_t in zip((mean, var, rstd, a, b, y, *got_bwd, dx), (*want, want_y, *want_bwd, want_dx)):
        torch.testing.assert_close(got_t, want_t, atol=1e-6, rtol=1e-6)
    assert float(var.abs().max()) <= (0.0 if dtype == torch.bfloat16 else 1e-6 * float((x.float() ** 2).max()))
    assert torch.count_nonzero(dx) == 0
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), torch.relu(bias + res.float()), atol=tol, rtol=0)


@pytest.mark.gpu
def test_bn_op_backward_launches_each_kernel_once(cuda):
    """fused_batchnorm_act through autograd: 2 launches forward, 2 backward,
    and a channels_last gradient needs no copy."""
    x = torch.randn(8, 64, 14, 14, device=cuda).to(memory_format=torch.channels_last).requires_grad_(True)
    scale = torch.ones(64, device=cuda, requires_grad=True)
    bias = torch.zeros(64, device=cuda, requires_grad=True)
    before = [k.launches for k in batchnorm.KERNELS]
    copies = batchnorm.fused_batchnorm_act.grad_copies
    y, _, _ = batchnorm.fused_batchnorm_act(x, scale, bias, None, 1e-5, True)
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    assert [k.launches for k in batchnorm.KERNELS] == [n + 1 for n in before]
    assert batchnorm.fused_batchnorm_act.grad_copies == copies
    assert x.grad.shape == x.shape and torch.isfinite(x.grad).all()


@pytest.mark.gpu
def test_bn_wrapper_rejects_non_contiguous(cuda):
    x = torch.randn(64, 16, device=cuda)
    with pytest.raises(ValueError):
        batchnorm.bn_stats(x.T.contiguous().T, torch.ones(16, device=cuda), torch.zeros(16, device=cuda), 1e-5)


def _every_finite_bf16_pattern(rows=65_536, c=64, seed=0):
    """(rows, C) bf16 bits holding every finite bf16 pattern: column j holds
    each finite pattern whose exponent field is one of 4j..4j+3 (both signs,
    every mantissa), then seeded draws of its positive ones. A column spans
    4 binades, so every value is k units of its least step with |k| < 2^12:
    each sum of 65,536 values (under 2^28 units), of their squares (under
    2^40) and of their f32 squares is exact in f64 whatever the order, and
    the kernel and the plain version sum the same values: equal bits, or
    both inf."""
    rng = np.random.RandomState(seed)
    bits = np.arange(1 << 16, dtype=np.uint32)
    exp = (bits >> 7) & 0xFF
    cols = []
    for j in range(c):
        pats = bits[(exp >= 4 * j) & (exp < 4 * j + 4) & (exp != 0xFF)]
        fill = rng.choice(pats[pats < 0x8000], rows - len(pats))
        cols.append(np.concatenate([pats, fill]))
    out = np.stack(cols, axis=1).astype(np.uint16)
    assert set(np.unique(out)) == set(bits[exp != 0xFF].tolist())
    return out


@pytest.mark.gpu
def test_bn_stats_every_finite_bf16_pattern_bit_for_bit(cuda):
    """bn_stats on a bf16 x that holds every finite bf16 pattern: all five
    outputs equal the plain version's bit for bit, and a second call the
    first. Columns 16-46 square exactly into normal f32 (one widening per
    element); the others hold zeros, f32-subnormal or overflowing squares
    (the two-conversion path), some of them beside in-range columns in one
    16-byte row."""
    x = torch.from_numpy(_every_finite_bf16_pattern().view(np.int16)).to(cuda).view(torch.bfloat16)
    g = torch.Generator(cuda).manual_seed(1)
    scale = torch.rand(64, device=cuda, generator=g) + 0.5
    bias = torch.randn(64, device=cuda, generator=g) * 0.1
    got = batchnorm.bn_stats(x, scale, bias, 1e-5)
    again = batchnorm.bn_stats(x, scale, bias, 1e-5)
    want = batchnorm.bn_stats_reference(x, scale, bias, 1e-5)
    torch.cuda.synchronize()
    for name, got_t, again_t, want_t in zip(("mean", "var", "rstd", "a", "b"), got, again, want):
        assert torch.equal(got_t, again_t), name
        assert torch.equal(got_t, want_t), (name, got_t, want_t)


STEP_SHAPES = [  # the distinct (rows, C) of the BN calls of one R50 step at 64 pairs, and a ragged one
    (802_816, 64), (200_704, 64), (200_704, 128), (200_704, 256), (50_176, 128), (50_176, 256),
    (50_176, 512), (12_544, 256), (12_544, 512), (12_544, 1024), (3_136, 512), (3_136, 2_048),
    (2_450, 72),
]
# and those of a grad_accum=2 micro-batch (32 pairs) and of the command line's
# batch (50 pairs): bn_stats' plan depends on the rows
STATS_SHAPES = (STEP_SHAPES + [(r // 2, c) for r, c in STEP_SHAPES[:-1]]
                + [(r * 50 // 64, c) for r, c in STEP_SHAPES[:-1]])


@pytest.mark.gpu
@pytest.mark.parametrize("rows, c", STATS_SHAPES, ids=[f"{r}x{c}" for r, c in STATS_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bn_stats_at_every_step_shape(cuda, rows, c, dtype):
    """bn_stats at each distinct shape of the step, of a grad_accum=2
    micro-batch and of a 50-pair step (rows in flight, and the ragged shape's masked scalar path): in bf16 all five outputs equal the
    plain version's on the card bit for bit; in f32 they lie within 1e-5 of
    the plain version in float64 (the forward bar); two calls agree bit for
    bit."""
    x, _, _, scale, bias = _bn_inputs(rows, c, dtype, cuda, seed=rows + c)
    got = batchnorm.bn_stats(x, scale, bias, 1e-5)
    again = batchnorm.bn_stats(x, scale, bias, 1e-5)
    torch.cuda.synchronize()
    names = ("mean", "var", "rstd", "a", "b")
    for name, got_t, again_t in zip(names, got, again):
        assert torch.equal(got_t, again_t), name
    if dtype == torch.bfloat16:
        for name, got_t, want_t in zip(names, got, batchnorm.bn_stats_reference(x, scale, bias, 1e-5)):
            assert torch.equal(got_t, want_t), name
    else:
        want = batchnorm.bn_stats_reference(x.double(), scale.double(), bias.double(), 1e-5)
        for name, got_t, want_t in zip(names, got, want):
            torch.testing.assert_close(got_t.double(), want_t, atol=1e-5, rtol=1e-5, msg=name)


CONV_CASES = [  # B, H, W, C, Cout, x dtype
    (64, 56, 56, 64, 64, torch.bfloat16),  # R50 layer 1's 3x3 at 64 images
    (64, 28, 28, 128, 128, torch.bfloat16),  # layer 2
    (64, 14, 14, 256, 256, torch.bfloat16),  # layer 3
    (64, 7, 7, 512, 512, torch.bfloat16),  # layer 4
    (3, 5, 7, 72, 40, torch.bfloat16),  # ragged rows, Cout != C
    (2, 9, 11, 13, 20, torch.float32),  # C and Cout not multiples of 8: scalar loads
    (5, 6, 6, 128, 64, torch.float32),  # f32 x and w rounded to bf16 in the tile load
]


def _conv_inputs(b, h, w, c, cout, dtype, device, seed=0):
    """x standard normal, w scaled by 1/sqrt(9C) so that |out| stays near 1."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c), dtype=np.float32)).to(device, dtype)
    wt = rng.standard_normal((3, 3, c, cout), dtype=np.float32) / np.sqrt(9 * c)
    return x, torch.from_numpy(wt.astype(np.float32)).to(device, dtype)


def _assert_conv_close(got, want):
    """The kernel's output against the plain version's float32 accumulator
    (the plain version run on x in float32: the inputs are rounded to bf16
    either way) at atol 3e-2, the JAX suite's bar: a bf16 output is off by
    its one rounding, at most 2^-6 for |out| < 4. Stats at rtol 5e-3 /
    atol 1.0 (tests/test_conv_bn.py)."""
    (out, stats), (acc, want_stats) = got, want
    torch.testing.assert_close(out.float(), acc, atol=3e-2, rtol=0)
    torch.testing.assert_close(stats, want_stats, atol=1.0, rtol=5e-3)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case", CONV_CASES, ids=["l1", "l2", "l3", "l4", "ragged", "scalar", "f32"]
)
def test_conv_kernel_matches_plain(cuda, case):
    *shape, dtype = case
    x, w = _conv_inputs(*shape, dtype, cuda)
    before = conv_bn.conv3x3_bn_stats.launches
    got = conv_bn.conv3x3_bn_stats(x, w)
    torch.cuda.synchronize()
    assert conv_bn.conv3x3_bn_stats.launches == before + 1
    assert got[0].dtype == dtype and got[0].shape == (*shape[:3], shape[4])
    assert got[1].dtype == torch.float32 and got[1].shape == (2, shape[4])
    _assert_conv_close(got, conv_bn.conv3x3_bn_stats_plain(x.float(), w))
    # deterministic: no float atomics, a fixed order of partial sums
    again = conv_bn.conv3x3_bn_stats(x, w)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.gpu
def test_conv_kernel_zero_padding_at_borders(cuda):
    """Mass only at each image's corner: taps past the border read zeros,
    never the neighbouring row or image of the flattened rows."""
    x = torch.zeros(4, 5, 6, 128, device=cuda, dtype=torch.bfloat16)
    x[:, 0, 0, :] = 1.0
    x[:, -1, -1, :] = -2.0
    _, w = _conv_inputs(1, 1, 1, 128, 96, torch.bfloat16, cuda, seed=4)
    got = conv_bn.conv3x3_bn_stats(x, w)
    _assert_conv_close(got, conv_bn.conv3x3_bn_stats_plain(x.float(), w))
    assert torch.count_nonzero(got[0][:, 2].float()) == 0  # the row two away from both corners


@pytest.mark.gpu
def test_conv_kernel_rejects_bad_inputs(cuda):
    x, w = _conv_inputs(2, 4, 4, 16, 16, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="w must be"):
        conv_bn.conv3x3_bn_stats(x, w[:2])
    with pytest.raises(ValueError, match="contiguous"):
        conv_bn.conv3x3_bn_stats(x.transpose(1, 2), w)


WGMMA_CONV_CASES = [  # B, H, W, C, Cout: shapes the wgmma variant takes
    (1, 14, 14, 256, 256),  # one image: 2 row tiles, so 64-wide channel tiles
    (3, 13, 11, 128, 192),  # M = 429, not a multiple of 128; Cout 192: 64-wide tiles
    (16, 14, 14, 256, 128),  # Cout = 128 != C = 256
    (64, 7, 7, 512, 512),  # R50 layer 4: 100 tiles 128 wide, one block per SM
    (256, 14, 14, 256, 256),  # the probe's shape: 128 x 256 tiles
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_CONV_CASES, ids=["b1", "m429", "cout128", "l4", "probe"])
def test_conv_wgmma_matches_plain_and_repeats(cuda, case):
    """The wgmma variant against the plain version (bars of
    _assert_conv_close), and two calls bit for bit equal."""
    x, w = _conv_inputs(*case, torch.bfloat16, cuda)
    assert conv_bn.choose_variant(x, w) == "wgmma"
    before = dict(conv_bn.conv3x3_bn_stats.launches_by_variant)
    got = conv_bn.conv3x3_bn_stats(x, w)
    again = conv_bn.conv3x3_bn_stats(x, w)
    torch.cuda.synchronize()
    assert conv_bn.conv3x3_bn_stats.launches_by_variant["wgmma"] == before["wgmma"] + 2
    assert conv_bn.conv3x3_bn_stats.launches_by_variant["generic"] == before["generic"]
    _assert_conv_close(got, conv_bn.conv3x3_bn_stats_plain(x.float(), w))
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.gpu
def test_conv_misaligned_bf16_takes_generic(cuda):
    """A bf16 x that starts 2 bytes past a 16-byte boundary (C and Cout
    multiples of 64) runs the generic variant and matches the plain version."""
    x, w = _conv_inputs(4, 14, 14, 128, 128, torch.bfloat16, cuda)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view_as(x).copy_(x)
    assert shifted.data_ptr() % 16 != 0
    assert conv_bn.choose_variant(shifted, w) == "generic"
    before = conv_bn.conv3x3_bn_stats.launches_by_variant["generic"]
    got = conv_bn.conv3x3_bn_stats(shifted, w)
    torch.cuda.synchronize()
    assert conv_bn.conv3x3_bn_stats.launches_by_variant["generic"] == before + 1
    _assert_conv_close(got, conv_bn.conv3x3_bn_stats_plain(x.float(), w))


@pytest.mark.gpu
@pytest.mark.parametrize("gstats", [False, True], ids=["no_gstats", "gstats"])
@pytest.mark.parametrize("case", BN_CASES, ids=["stem", "l1_tail", "l4_down", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bn_bwd_dx_matches_plain_and_repeats(cuda, case, dtype, gstats):
    """bn_bwd_dx (its one-wave plan, rows in flight, constants in shared
    memory; the ragged case takes the masked scalar path) against its plain
    version in the same dtype on the same inputs: bit for bit in bf16 (one
    rounding of the same f32 steps), within 1e-6 in f32, with and without
    the statistics cotangents; dres exact; two calls bit for bit."""
    rows, c, relu, with_res = case
    x, res, gy, scale, bias = _bn_inputs(rows, c, dtype, cuda, seed=3)
    res = res if with_res else None
    mean, _, rstd, a, b = batchnorm.bn_stats(x, scale, bias, 1e-5)
    y = batchnorm.bn_apply(x, a, b, res, relu)
    _, _, k, mg, mgx = batchnorm.bn_bwd_reduce(gy, y, x, mean, rstd, scale, relu)
    g = torch.Generator(cuda).manual_seed(7)
    gmean, gvar = (torch.randn(c, device=cuda, generator=g), torch.randn(c, device=cuda, generator=g)) \
        if gstats else (None, None)
    want_dres = relu and with_res
    args = (gy, y, x, mean, rstd, k, mg, mgx, gmean, gvar, relu, want_dres)
    before = batchnorm.bn_bwd_dx.launches
    dx, dres = batchnorm.bn_bwd_dx(*args)
    dx2, dres2 = batchnorm.bn_bwd_dx(*args)
    torch.cuda.synchronize()
    assert batchnorm.bn_bwd_dx.launches == before + 2
    want_dx, want_dres_t = batchnorm.bn_bwd_dx_reference(*args)
    assert torch.equal(dx, dx2)
    if dtype == torch.bfloat16:
        assert torch.equal(dx, want_dx)
    else:
        torch.testing.assert_close(dx, want_dx, atol=1e-6, rtol=1e-6)
    if want_dres:
        assert torch.equal(dres, want_dres_t) and torch.equal(dres, dres2)
    else:
        assert dres is None


@pytest.mark.gpu
@pytest.mark.parametrize("case", BN_CASES, ids=["stem", "l1_tail", "l4_down", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bn_prefix_kernels_match_float64_plain(cuda, case, dtype):
    """--bn_stat_subsample's path (the first half of the rows): bn_stats on
    the prefix view, bn_bwd_reduce over every row divided by the prefix's
    count, bn_bwd_dx with the statistics terms on the prefix rows only,
    against the plain versions in float64 at test_bn_kernels_match_float64_
    plain's bars; bn_bwd_dx also against its plain version in the same dtype
    (bit for bit in bf16, 1e-6 in f32), the rows past the prefix exactly
    k*g'."""
    rows, c, relu, with_res = case
    x, res, gy, scale, bias = _bn_inputs(rows, c, dtype, cuda, seed=11)
    res = res if with_res else None
    n = rows // 2
    mean, var, rstd, a, b = batchnorm.bn_stats(x[:n], scale, bias, 1e-5)
    y = batchnorm.bn_apply(x, a, b, res, relu)
    dscale, dbias, k, mg, mgx = batchnorm.bn_bwd_reduce(gy, y, x, mean, rstd, scale, relu, count=n)
    gmean, gvar = torch.randn(c, device=cuda), torch.randn(c, device=cuda)
    args = (gy, y, x, mean, rstd, k, mg, mgx, gmean, gvar, relu, relu and with_res)
    dx, dres = batchnorm.bn_bwd_dx(*args, stat_rows=n, count=n)
    torch.cuda.synchronize()
    want_dx, _ = batchnorm.bn_bwd_dx_reference(*args, stat_rows=n, count=n)
    if dtype == torch.bfloat16:
        assert torch.equal(dx, want_dx)
    else:
        torch.testing.assert_close(dx, want_dx, atol=1e-6, rtol=1e-6)
    g_masked = torch.where(y > 0, gy.float(), 0.0) if relu else gy.float()
    assert torch.equal(dx[n:], (k * g_masked[n:]).to(dtype))

    d = lambda t: None if t is None else t.double()  # noqa: E731
    x64, s64, b64 = d(x), d(scale), d(bias)
    p_mean, p_var, p_rstd, p_a, p_b = batchnorm.bn_stats_reference(x64[:n], s64, b64, 1e-5)
    p_ds, p_db, p_k, p_mg, p_mgx = batchnorm.bn_bwd_reduce_reference(
        d(gy), d(y), x64, p_mean, p_rstd, s64, relu, count=n)
    p_dx, _ = batchnorm.bn_bwd_dx_reference(d(gy), d(y), x64, p_mean, p_rstd, p_k, p_mg, p_mgx, d(gmean),
                                            d(gvar), relu, False, stat_rows=n, count=n)
    close = lambda a_, b_, tol: torch.testing.assert_close(a_.double(), b_, atol=tol[0], rtol=tol[1])  # noqa: E731
    f32 = dtype == torch.float32
    close(mean, p_mean, (1e-5, 1e-5))
    close(var, p_var, (1e-5, 1e-5))
    close(dscale, p_ds, (5e-4, 1e-3))
    close(dbias, p_db, (5e-4, 1e-3))
    close(mg, p_mg, (5e-4, 1e-3))
    close(mgx, p_mgx, (5e-4, 1e-3))
    close(dx, p_dx, (5e-4, 1e-3) if f32 else (1e-2, 1e-2))


@pytest.mark.gpu
@pytest.mark.parametrize("case", BN_CASES, ids=["stem", "l1_tail", "l4_down", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bn_dp_finish_matches_the_one_launch_path(cuda, case, dtype):
    """The data-parallel path on one rank's rows: bn_stats' sums then
    bn_stats_finish, and bn_bwd_reduce's sums then bn_bwd_finish, give the
    one-launch path's results bit for bit (the same f64 sums, finished with
    the same arithmetic). Over two halves of the rows whose sums are added
    (two ranks' all-reduce), against the float64 plain versions over all
    rows at the forward and gradient bars."""
    rows, c, relu, with_res = case
    x, res, gy, scale, bias = _bn_inputs(rows, c, dtype, cuda, seed=13)
    res = res if with_res else None
    one = batchnorm.bn_stats(x, scale, bias, 1e-5)
    finish_before = batchnorm.bn_stats.finish_launches, batchnorm.bn_bwd_reduce.finish_launches
    sums = batchnorm.bn_stats(x, scale, bias, 1e-5, sums=True)
    two = batchnorm.bn_stats_finish(sums, scale, bias, 1e-5)
    for name, got_t, want_t in zip(("mean", "var", "rstd", "a", "b"), two, one):
        assert torch.equal(got_t, want_t), name
    mean, _, rstd, a, b = one
    y = batchnorm.bn_apply(x, a, b, res, relu)
    want = batchnorm.bn_bwd_reduce(gy, y, x, mean, rstd, scale, relu)
    ds, db, k, gsums = batchnorm.bn_bwd_reduce(gy, y, x, mean, rstd, scale, relu, sums=True)
    mg, mgx = batchnorm.bn_bwd_finish(gsums, sums)
    for name, got_t, want_t in zip(("dscale", "dbias", "k", "mg", "mgx"), (ds, db, k, mg, mgx), want):
        assert torch.equal(got_t, want_t), name
    assert (batchnorm.bn_stats.finish_launches, batchnorm.bn_bwd_reduce.finish_launches) == \
        (finish_before[0] + 1, finish_before[1] + 1)

    h = rows // 2
    halves = batchnorm.bn_stats(x[:h], scale, bias, 1e-5, sums=True) + \
        batchnorm.bn_stats(x[h:], scale, bias, 1e-5, sums=True)
    mean2, var2, rstd2, _, _ = batchnorm.bn_stats_finish(halves, scale, bias, 1e-5)
    g_halves = sum(batchnorm.bn_bwd_reduce(gy[i], y[i], x[i], mean2, rstd2, scale, relu, sums=True)[3]
                   for i in (slice(0, h), slice(h, rows)))
    mg2, mgx2 = batchnorm.bn_bwd_finish(g_halves, halves)
    torch.cuda.synchronize()
    d = lambda t: None if t is None else t.double()  # noqa: E731
    p_mean, p_var, p_rstd, _, _ = batchnorm.bn_stats_reference(d(x), d(scale), d(bias), 1e-5)
    _, _, _, p_mg, p_mgx = batchnorm.bn_bwd_reduce_reference(d(gy), d(y), d(x), p_mean, p_rstd, d(scale), relu)
    close = lambda a_, b_, tol: torch.testing.assert_close(a_.double(), b_, atol=tol[0], rtol=tol[1])  # noqa: E731
    close(mean2, p_mean, (1e-5, 1e-5))
    close(var2, p_var, (1e-5, 1e-5))
    close(mg2, p_mg, (5e-4, 1e-3))
    close(mgx2, p_mgx, (5e-4, 1e-3))


# ---------------------------------------------------------------------------
# the training runtime on the card: prefetch and the Trainer's step options
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_prefetch_on_the_card_matches_the_cpu_batches(cuda):
    """Batches staged through pinned buffers on a side stream equal the
    loader's, with the consumer's stream delayed after each batch so that a
    buffer refilled before its copy finished would show; the ring (3
    buffers) is reused over 11 batches."""
    from rot_mvgaze_tpu_torch.data import BatchLoader, InMemoryGazeDataset, device_prefetch

    corpus = InMemoryGazeDataset(1, n_frames=4, image_size=64, learnable=True)
    want = list(device_prefetch(iter(BatchLoader(corpus, 7, shuffle=True, seed=3)), device="cpu"))
    got = []
    for batch in device_prefetch(iter(BatchLoader(corpus, 7, shuffle=True, seed=3)), device=cuda):
        torch.cuda._sleep(2_000_000)
        got.append({k: v.clone() for k, v in batch.items()})
    torch.cuda.synchronize()
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].device.type == "cuda" and g[k].dtype == w[k].dtype
            assert torch.equal(g[k].cpu(), w[k]), k


def _card_trainer(tmp_path, **overrides):
    from types import SimpleNamespace

    from rot_mvgaze_tpu_torch.data import BatchLoader, InMemoryGazeDataset
    from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm
    from rot_mvgaze_tpu_torch.train import Trainer

    cfg = dict(output_dir=str(tmp_path), print_freq=1, epochs=1, save_epoch=99, image_size=64,
               bf16=True, scheduler_step="iteration")
    cfg.update(overrides)
    corpus = InMemoryGazeDataset(1, n_frames=1, image_size=64, learnable=True)
    torch.manual_seed(0)
    return Trainer(SimpleNamespace(**cfg), FeatRotationSymm(backbone_depth=18, num_iter=2),
                   IterationLoss(StereoL1Loss(rel_weight=0.01), iter_decay=0.5),
                   BatchLoader(corpus, 8, shuffle=True, drop_last=True), BatchLoader(corpus, 8),
                   device="cuda", init_state_dict=FeatRotationSymm(backbone_depth=18, num_iter=2).state_dict())


@pytest.mark.gpu
@pytest.mark.parametrize(
    "option", [{}, {"grad_accum": 2}, {"ema_decay": 0.9}, {"freeze_bn": True}],
    ids=["default", "grad_accum", "ema", "freeze_bn"],
)
def test_trainer_step_launch_counts(cuda, tmp_path, option):
    """Each Trainer step (R18, 2 iterations, bf16, 8 pairs) launches every
    BN kernel twice per BatchNorm (once per view) per micro-batch, none under
    freeze_bn, and the fuser's wgmma variant 2 x 2 times per micro-batch;
    previews come from micro-batch 0; freeze_bn leaves every BN buffer as it
    was; the float32 eval launches the generic fuser 4 times per batch and no
    BN kernel."""
    from rot_mvgaze_tpu_torch.models.norm import BatchNormAct

    trainer = _card_trainer(tmp_path, **option)
    n_bn = sum(isinstance(m, BatchNormAct) for m in trainer.model.modules())
    accum = option.get("grad_accum", 1)
    per_bn = 0 if option.get("freeze_bn") else 2 * n_bn * accum
    buffers = {k: v.clone() for k, v in trainer.model.state_dict().items() if "running" in k or "tracked" in k}
    step_fn, counts = trainer._train_step, []

    def counted(batch, generator=None, *, step):
        before = [k.launches for k in batchnorm.KERNELS] + [fusion.rotate_concat_matmul_relu.launches_by_variant["wgmma"]]
        stats = step_fn(batch, generator, step=step)
        torch.cuda.synchronize()
        after = [k.launches for k in batchnorm.KERNELS] + [fusion.rotate_concat_matmul_relu.launches_by_variant["wgmma"]]
        counts.append([a - b for a, b in zip(after, before)])
        # previews: the first 8 rows of micro-batch 0
        assert stats["img_0"].shape == (8 // accum, 64, 64, 3) and torch.isfinite(stats["loss_gaze"])
        return stats

    trainer._train_step = counted
    trainer.train_one_epoch(0)
    assert len(counts) == 2
    for c in counts:
        assert c == [per_bn] * len(batchnorm.KERNELS) + [2 * 2 * accum]
    if option.get("freeze_bn"):
        for k, v in trainer.model.state_dict().items():
            if k in buffers:
                assert torch.equal(v, buffers[k]), k
    generic = fusion.rotate_concat_matmul_relu.launches_by_variant["generic"]
    bn_before = [k.launches for k in batchnorm.KERNELS]
    assert np.isfinite(trainer.test(0))
    assert fusion.rotate_concat_matmul_relu.launches_by_variant["generic"] - generic == 4 * 3
    assert [k.launches for k in batchnorm.KERNELS] == bn_before


FAMILY_CASES = {  # flags -> (BN launches per BatchNorm, wgmma fuser launches) per update
    "fuse_views": ({"fuse_views": True}, 1, 4),
    "ignore_rotmat": ({"ignore_rotmat": True}, 2, 0),
    "encode_rotmat": ({"encode_rotmat": True}, 2, 0),
    "share_feature": ({"share_feature": True}, 2, 0),
    "share_weights": ({"share_weights": True}, 2, 4),
    "v3": ({"num_views": 3}, 1, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FAMILY_CASES))
def test_model_family_update_launch_counts(cuda, name):
    """One bf16 update (R18, 2 iterations, 8 pairs or frames, 64x64) of each
    configuration beyond the default one: with both (or all) views in one
    backbone batch every BN kernel launches once per BatchNorm, else twice;
    the fuser's wgmma variant runs 2 x 2 times where the default fuser path
    runs (fuse_views, share_weights), never under the ablations or the
    V-view model (their fusers are F.linear MLPs, as in JAX); the loss is
    finite."""
    from rot_mvgaze_tpu_torch.losses import IterationLoss, MultiViewL1Loss, StereoL1Loss
    from rot_mvgaze_tpu_torch.models import FeatRotationMultiView, FeatRotationSymm
    from rot_mvgaze_tpu_torch.models.norm import BatchNormAct
    from rot_mvgaze_tpu_torch.train import make_multiview_train_step, make_optimizer, make_train_step

    flags, per_bn, n_fuser = FAMILY_CASES[name]
    views = flags.get("num_views", 2)
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.manual_seed(0)
    if views > 2:
        model = FeatRotationMultiView(backbone_depth=18, num_iter=2).to(cuda)
        step = make_multiview_train_step(model, IterationLoss(MultiViewL1Loss(0.01), 0.5),
                                         make_optimizer(model.parameters()), image_size=64,
                                         compute_dtype=torch.bfloat16)
        batch = {"imgs": torch.randint(0, 256, (8, views, 64, 64, 3), dtype=torch.uint8, device=cuda, generator=g),
                 "head_poses": torch.rand(8, views, 2, device=cuda, generator=g) - 0.5,
                 "gt_gazes": torch.rand(8, views, 2, device=cuda, generator=g) - 0.5}
    else:
        model = FeatRotationSymm(backbone_depth=18, num_iter=2, **flags).to(cuda)
        step = make_train_step(model, IterationLoss(StereoL1Loss(0.01), 0.5), make_optimizer(model.parameters()),
                               image_size=64, compute_dtype=torch.bfloat16)
        batch = {f"img_{v}": torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8, device=cuda, generator=g)
                 for v in (0, 1)}
        batch.update({k: torch.rand(8, 2, device=cuda, generator=g) - 0.5
                      for k in ("head_pose_0", "head_pose_1", "gt_gaze", "gt_gaze_1")})
    n_bn = sum(isinstance(m, BatchNormAct) for m in model.modules())
    gen = torch.Generator(device="cuda").manual_seed(1)
    before = [k.launches for k in batchnorm.KERNELS] + [fusion.rotate_concat_matmul_relu.launches_by_variant["wgmma"]]
    stats = step(batch, gen, step=0)
    torch.cuda.synchronize()
    after = [k.launches for k in batchnorm.KERNELS] + [fusion.rotate_concat_matmul_relu.launches_by_variant["wgmma"]]
    assert [a - b for a, b in zip(after, before)] == [per_bn * n_bn] * len(batchnorm.KERNELS) + [n_fuser]
    assert torch.isfinite(stats["loss_gaze"])


# ---------------------------------------------------------------------------
# the serving surface: the int8 product, the fuser inside an exported
# program, the resize
# ---------------------------------------------------------------------------

# (M, K, N): the R50 stem's K = 7*7*3 = 147 (padded to 152), a 3x3 conv's
# (K = 9*64) and a 1x1 conv's at micro-batch 64 x 2 views, and shapes that
# need M and N padded
INT8_GEMM_CASES = [(128 * 112 * 112, 147, 64), (128 * 56 * 56, 576, 64), (128 * 56 * 56, 256, 64),
                   (5, 40, 12), (300, 33, 10)]


@pytest.mark.gpu
@pytest.mark.parametrize("m, k, n", INT8_GEMM_CASES, ids=["stem", "3x3", "1x1", "m5_n12", "k33_n10"])
def test_int8_matmul_equals_plain_bit_for_bit(cuda, m, k, n):
    """torch._int_mm on the int8 tensor cores, full-range int8 inputs: the
    int32 result is the plain float64 product's exactly, one launch."""
    from rot_mvgaze_tpu_torch.ops import quant

    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=cuda, generator=g)
    b = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=cuda, generator=g)
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(a, b)
    torch.cuda.synchronize()
    assert quant.int8_matmul.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, quant.int8_matmul_reference(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [((8, 3, 64, 64), (64, 3, 7, 7), 2, 3, 1), ((8, 64, 16, 16), (64, 64, 3, 3), 1, 1, 1),
                                  ((8, 256, 16, 16), (128, 256, 1, 1), 2, 0, 1),
                                  ((8, 128, 8, 8), (128, 4, 3, 3), 1, 1, 32)],
                         ids=["stem", "3x3", "1x1_s2", "grouped"])
def test_int8_conv_accumulate_equals_plain_bit_for_bit(cuda, case):
    from rot_mvgaze_tpu_torch.ops import quant

    xs, ws, stride, pad, groups = case
    g = torch.Generator(device="cuda").manual_seed(1)
    x8 = torch.randint(-127, 128, xs, dtype=torch.int8, device=cuda, generator=g).to(memory_format=torch.channels_last)
    w8 = torch.randint(-127, 128, ws, dtype=torch.int8, device=cuda, generator=g)
    got = quant.int8_conv_accumulate(x8, w8, stride, pad, groups)
    assert torch.equal(got, quant.int8_conv_accumulate_reference(x8, w8, stride, pad, groups))


@pytest.mark.gpu
def test_exported_program_launches_the_fuser_kernel(cuda, tmp_path):
    """R18 (D = V = 512: the wgmma variant), 2 iterations, bf16, micro-batch
    8, 64x64: the loaded program launches the fuser's wgmma kernel 2 x 2
    times per micro-batch and predicts what the live predictor predicts."""
    from rot_mvgaze_tpu_torch import export, serving
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm

    torch.manual_seed(0)
    ckpt = str(tmp_path / "m.pth.tar")
    torch.save(FeatRotationSymm(backbone_depth=18, num_iter=2).state_dict(), ckpt)
    live = serving.GazePredictor(ckpt, backbone_depth=18, num_iter=2, micro_batch=8, image_size=64)
    artifact = str(tmp_path / "a.pt2")
    export.export_serving_artifact(live.model, artifact, micro_batch=8, image_size=64)
    aot = export.AotGazePredictor(artifact, ckpt)
    rng = np.random.default_rng(0)
    req = (rng.integers(0, 256, (16, 64, 64, 3), dtype=np.uint8), rng.integers(0, 256, (16, 64, 64, 3), dtype=np.uint8),
           rng.uniform(-0.5, 0.5, (16, 2)).astype(np.float32), rng.uniform(-0.5, 0.5, (16, 2)).astype(np.float32))
    before = dict(fusion.rotate_concat_matmul_relu.launches_by_variant)
    got = aot.predict(*req)
    after = fusion.rotate_concat_matmul_relu.launches_by_variant
    assert after["wgmma"] - before["wgmma"] == 2 * 2 * 2 and after["generic"] == before["generic"]
    want = live.predict(*req)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("h, w", [(448, 448), (129, 129), (300, 200), (112, 112)])
def test_resize_on_the_card_equals_the_cpu(cuda, h, w):
    """The same weights and contraction: float32 within 1e-6 (TF32 off)."""
    from rot_mvgaze_tpu_torch.augment.ops import resize_bilinear

    x = torch.from_numpy(np.random.default_rng(h).random((4, h, w, 3), dtype=np.float32))
    got = resize_bilinear(x.to(cuda), 224).cpu()
    torch.testing.assert_close(got, resize_bilinear(x, 224), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# meshes on the card: height strips through the BN kernels, mesh serving
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("strips", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bn_over_strips_matches_float64_plain(cuda, strips, dtype):
    """fused_batchnorm_act_blocks over height strips on the card (a logical
    mesh on one card: every strip's bn_stats sums, one finish, each strip's
    bn_apply; backward likewise) against the float64 plain versions over the
    whole map, at test_bn_kernels_match_float64_plain's bars, with the
    residual and ReLU; 7 rows (layer 4 at 224x224) over 2 strips split 4 +
    3, over 4 strips 2 + 2 + 2 + 1."""
    from rot_mvgaze_tpu_torch.parallel import split_sizes

    n, c, h, w = 64, 256, 7, 7
    g = torch.Generator(cuda).manual_seed(strips)
    cl = torch.channels_last
    x = (torch.randn(n, c, h, w, device=cuda, generator=g) * 2 + 0.5).to(dtype).contiguous(memory_format=cl)
    res = torch.randn(n, c, h, w, device=cuda, generator=g).to(dtype).contiguous(memory_format=cl)
    gy = torch.randn(n, c, h, w, device=cuda, generator=g).to(dtype).contiguous(memory_format=cl)
    scale = (torch.rand(c, device=cuda, generator=g) + 0.5).requires_grad_(True)
    bias = (torch.randn(c, device=cuda, generator=g) * 0.1).requires_grad_(True)

    def cut(t):
        out, h0 = [], 0
        for rows in split_sizes(h, strips):
            out.append(t[:, :, h0:h0 + rows].contiguous(memory_format=cl).requires_grad_(True))
            h0 += rows
        return out

    xs, rs = cut(x), cut(res)
    before = [k.launches for k in batchnorm.KERNELS] + [batchnorm.bn_stats.finish_launches,
                                                        batchnorm.bn_bwd_reduce.finish_launches]
    ys, mean, var, count = batchnorm.fused_batchnorm_act_blocks([xs], scale, bias, [rs], 1e-5, True)
    y = torch.cat(ys[0], dim=2)
    y.backward(gy)
    torch.cuda.synchronize()
    after = [k.launches for k in batchnorm.KERNELS] + [batchnorm.bn_stats.finish_launches,
                                                       batchnorm.bn_bwd_reduce.finish_launches]
    assert [a - b for a, b in zip(after, before)] == [strips] * 4 + [1, 1]
    assert count == n * h * w

    def rows(t):
        return t.double().permute(0, 2, 3, 1).reshape(-1, c)

    s64, b64 = scale.detach().double(), bias.detach().double()
    p_mean, p_var, p_rstd, p_a, p_b = batchnorm.bn_stats_reference(rows(x), s64, b64, 1e-5)
    p_y = batchnorm.bn_apply_reference(rows(x), p_a, p_b, rows(res), True)
    p_ds, p_db, p_k, p_mg, p_mgx = batchnorm.bn_bwd_reduce_reference(rows(gy), rows(y.detach()), rows(x), p_mean,
                                                                     p_rstd, s64, True)
    p_dx, p_dres = batchnorm.bn_bwd_dx_reference(rows(gy), rows(y.detach()), rows(x), p_mean, p_rstd, p_k, p_mg,
                                                 p_mgx, None, None, True, True)
    close = lambda a_, b_, tol: torch.testing.assert_close(a_.double(), b_, atol=tol[0], rtol=tol[1])  # noqa: E731
    f32 = dtype == torch.float32
    close(mean, p_mean, (1e-5, 1e-5))
    close(var, p_var, (1e-5, 1e-5))
    close(rows(y.detach()), p_y, (1e-5, 1e-5) if f32 else (1e-2, 1e-2))
    close(scale.grad, p_ds, (5e-4, 1e-3))
    close(bias.grad, p_db, (5e-4, 1e-3))
    close(rows(torch.cat([t.grad for t in xs], dim=2)), p_dx, (5e-4, 1e-3) if f32 else (1e-2, 1e-2))
    torch.testing.assert_close(rows(torch.cat([t.grad for t in rs], dim=2)), p_dres, atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("data,spatial", [(2, 1), (1, 2), (2, 2)], ids=["data2", "spatial2", "data2_spatial2"])
def test_logical_mesh_predictor_matches_one_card(cuda, tmp_path, data, spatial):
    """R18 (D = V = 512: the fuser's wgmma variant in bf16), 2 iterations,
    64x64, micro-batch 8, on a logical mesh of cuda:0: float32 within atol
    2e-4 / rtol 1e-3 of the one-card predictor, bf16 within 0.1 deg mean;
    2 x 2 wgmma fuser launches per data replica per micro-batch."""
    from rot_mvgaze_tpu_torch import serving
    from rot_mvgaze_tpu_torch.geometry import angular_error_numpy
    from rot_mvgaze_tpu_torch.models import FeatRotationSymm
    from rot_mvgaze_tpu_torch.parallel import make_mesh

    torch.manual_seed(0)
    ckpt = str(tmp_path / "m.pth.tar")
    torch.save(FeatRotationSymm(backbone_depth=18, num_iter=2).state_dict(), ckpt)
    rng = np.random.default_rng(0)
    req = (rng.integers(0, 256, (16, 64, 64, 3), dtype=np.uint8), rng.integers(0, 256, (16, 64, 64, 3), dtype=np.uint8),
           rng.uniform(-0.5, 0.5, (16, 2)).astype(np.float32), rng.uniform(-0.5, 0.5, (16, 2)).astype(np.float32))
    kw = dict(backbone_depth=18, num_iter=2, micro_batch=8, image_size=64)
    mesh = make_mesh(["cuda:0"] * (data * spatial), spatial=spatial)
    for dtype in (torch.float32, torch.bfloat16):
        one = serving.GazePredictor(ckpt, dtype=dtype, **kw).predict(*req)
        pred = serving.GazePredictor(ckpt, dtype=dtype, mesh=mesh, **kw)
        before = dict(fusion.rotate_concat_matmul_relu.launches_by_variant)
        got = pred.predict(*req)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, one, atol=2e-4, rtol=1e-3)
        else:
            after = fusion.rotate_concat_matmul_relu.launches_by_variant
            assert after["wgmma"] - before["wgmma"] == 2 * 2 * data * 2  # 2 micro-batches
            assert angular_error_numpy(got.astype(np.float64), one.astype(np.float64)).mean() <= 0.1
