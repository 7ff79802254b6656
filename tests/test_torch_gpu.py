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
from rot_mvgaze_tpu_torch.ops import batchnorm, fusion


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
     (64, 2048, 512, 1000), (7, 100, 36, 90)],
    ids=["serving", "b1", "b50", "h1000", "unaligned"],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fusion_kernel_matches_reference(cuda, b, d, v, h, dtype):
    """f32 with TF32 off: atol/rtol 1e-4. bf16, compared in f32: atol/rtol
    2e-2 (one bf16 ulp is 2^-8 and K reaches 3584)."""
    args = _fusion_inputs(b, d, v, h, dtype, cuda)
    before = fusion.rotate_concat_matmul_relu.launches
    got = fusion.rotate_concat_matmul_relu(*args)
    torch.cuda.synchronize()
    assert fusion.rotate_concat_matmul_relu.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h)
    want = fusion.rotate_concat_matmul_relu_reference(*args)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


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
    kernel's y, so both use one ReLU mask."""
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
