"""The port's rotate+concat+GEMM+ReLU fuser (rot_mvgaze_tpu_torch.ops.fusion)
against the JAX package's Pallas kernel, which runs in interpret mode on the
CPU. Weights go to the port in nn.Linear's (out, in) layout. The CUDA
kernel itself is held against the plain version in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.geometry import rotation_matrix_2d as jax_rotation_matrix_2d
from rot_mvgaze_tpu.ops import fused_image_feat_fuser as jax_fused_image_feat_fuser
from rot_mvgaze_tpu.ops import rotate_concat_matmul_relu as jax_rotate_concat_matmul_relu
from rot_mvgaze_tpu_torch.ops import fusion


def _inputs(b, d, v, h, seed=0):
    """numpy inputs; w1 is (K, H) as the JAX kernel takes it."""
    rng = np.random.RandomState(seed)
    img = (rng.randn(b, d) * 0.1).astype(np.float32)
    feat = (rng.randn(b, 3, v) * 0.1).astype(np.float32)
    hp = rng.uniform(-0.8, 0.8, (b, 2)).astype(np.float32)
    rot = np.array(jax_rotation_matrix_2d(jnp.asarray(hp)), np.float32)
    w1 = (rng.randn(d + 3 * v, h) * 0.02).astype(np.float32)
    b1 = (rng.randn(h) * 0.01).astype(np.float32)
    return img, feat, rot, w1, b1


def _port_args(img, feat, rot, w1, b1, device="cpu", dtype=torch.float32):
    t = lambda a, dt=dtype: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)  # noqa: E731
    return t(img), t(feat), t(rot, torch.float32), t(w1.T), t(b1, torch.float32)


@pytest.mark.parametrize("shape", [(128, 256, 128, 512), (256, 256, 128, 1024)])
def test_reference_matches_pallas_kernel(shape):
    """The plain version equals the Pallas kernel (the JAX suite's bar,
    tests/test_ops.py)."""
    args = _inputs(*shape)
    want = np.asarray(jax_rotate_concat_matmul_relu(*map(jnp.asarray, args)))
    got = fusion.rotate_concat_matmul_relu(*_port_args(*args))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_fused_fuser_ragged_batch_matches_jax():
    """B=50: the JAX wrapper pads to its 128-row tile, the port does not."""
    b, d, v, h = 50, 256, 128, 512
    img, feat, rot, w1, b1 = _inputs(b, d, v, h, seed=1)
    rng = np.random.RandomState(2)
    w2 = (rng.randn(h, 3 * v) * 0.02).astype(np.float32)
    b2 = (rng.randn(3 * v) * 0.01).astype(np.float32)
    want = np.asarray(
        jax_fused_image_feat_fuser(*map(jnp.asarray, (img, feat, rot, w1, b1, w2, b2)))
    )
    port = _port_args(img, feat, rot, w1, b1)
    got = fusion.fused_image_feat_fuser(
        *port, torch.from_numpy(np.ascontiguousarray(w2.T)), torch.from_numpy(b2)
    )
    assert got.shape == (b, 3 * v)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


def test_cpu_call_does_not_count_a_launch(monkeypatch):
    monkeypatch.setattr(fusion.rotate_concat_matmul_relu, "launches", 0)
    monkeypatch.setattr(
        fusion.rotate_concat_matmul_relu, "launches_by_variant", dict.fromkeys(fusion.VARIANTS, 0)
    )
    fusion.rotate_concat_matmul_relu(*_port_args(*_inputs(4, 16, 8, 24)))
    assert fusion.rotate_concat_matmul_relu.launches == 0
    assert fusion.rotate_concat_matmul_relu.launches_by_variant == {"wgmma": 0, "generic": 0}


def test_bf16_reference_rounds_rotated_row_and_output():
    """bf16: the rotated row and the output are rounded to bf16, the product
    accumulates in f32."""
    args = _port_args(*_inputs(8, 32, 16, 40), dtype=torch.bfloat16)
    got = fusion.rotate_concat_matmul_relu(*args)
    img, feat, rot, w1, b1 = args
    rotated = torch.einsum("bij,bjv->biv", rot, feat.float()).to(torch.bfloat16)
    x = torch.cat([img, rotated.flatten(1)], 1).float()
    want = torch.relu(x @ w1.float().T + b1).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize(
    "mutate, error",
    [
        (lambda a: (a[0].to(torch.float64),) + a[1:], TypeError),
        (lambda a: a[:1] + (a[1].to(torch.bfloat16),) + a[2:], TypeError),
        (lambda a: a[:4] + (a[4].to(torch.bfloat16),), TypeError),
        (lambda a: a[:3] + (a[3][:, :-1],) + a[4:], ValueError),
        (lambda a: (a[0][:-1],) + a[1:], ValueError),
        (lambda a: a[:3] + (a[3].T.contiguous().T,) + a[4:], ValueError),
    ],
    ids=["f64", "mixed-dtype", "bf16-bias", "bad-k", "batch-mismatch", "non-contiguous"],
)
def test_wrapper_rejects_bad_inputs(mutate, error):
    args = _port_args(*_inputs(4, 16, 8, 16))
    with pytest.raises(error):
        fusion.rotate_concat_matmul_relu(*mutate(args))


@pytest.mark.parametrize(
    "b, h, k, n_sm, want",
    [
        (64, 3584, 3584, 132, (384, 10)),  # serving shape on an H100
        (1, 3584, 3584, 132, (384, 10)),
        (64, 1000, 3584, 132, (128, 28)),
        (512, 8192, 4096, 132, (4096, 1)),  # enough tiles: no split
        (64, 64, 40, 132, (32, 2)),  # fewer K tiles than wanted splits
    ],
)
def test_plan_splits(b, h, k, n_sm, want):
    k_chunk, splits = fusion.plan_splits(b, h, k, n_sm)
    assert (k_chunk, splits) == want
    assert k_chunk % 32 == 0 and (splits - 1) * k_chunk < k <= splits * k_chunk



@pytest.mark.parametrize(
    "b, d, v, h, want",
    [
        (64, 2048, 512, 3584, (64, 28, 1, 4, 14)),  # serving: 112 blocks, clusters of 4
        (1, 2048, 512, 3584, (64, 28, 1, 4, 14)),
        (50, 2048, 512, 3584, (64, 28, 1, 4, 14)),
        (200, 2048, 512, 3584, (128, 28, 2, 2, 28)),  # two batch tiles: clusters of 2
        (64, 2048, 512, 1000, (64, 8, 1, 8, 7)),  # few M-tiles: the largest cluster
        (64, 512, 512, 2048, (64, 16, 1, 8, 4)),  # R18/R34's fuser
        (512, 2048, 512, 8192, (128, 64, 4, 1, 56)),  # enough tiles: no split
    ],
)
def test_plan_wgmma(b, d, v, h, want):
    n_tile, m_tiles, n_tiles, splits, steps = fusion.plan_wgmma(b, d, v, h, 132)
    assert (n_tile, m_tiles, n_tiles, splits, steps) == want
    assert 1 <= splits <= 8 and m_tiles * 128 >= h and n_tiles * n_tile >= b
    assert splits == 1 or m_tiles * n_tiles * splits <= 132
    # the busiest block's steps: its image steps and 3 per v block
    assert steps * splits >= (d + 3 * v) // 64


def _shifted(t):
    """A contiguous copy of t that starts one element past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view_as(t)
    out.copy_(t)
    return out


@pytest.mark.parametrize(
    "b, d, v, h, dtype, shift, want",
    [
        (64, 2048, 512, 64, torch.bfloat16, None, "wgmma"),  # R50
        (1, 512, 512, 64, torch.bfloat16, None, "wgmma"),  # R18 / R34, one pair
        (64, 2048, 512, 64, torch.float32, None, "generic"),  # f32: no wgmma mode
        (8, 200, 64, 64, torch.bfloat16, None, "generic"),  # D not a multiple of 64
        (8, 256, 40, 64, torch.bfloat16, None, "generic"),  # V not a multiple of 64
        (8, 256, 64, 64, torch.bfloat16, 0, "generic"),  # img 2 bytes past 16-byte alignment
        (8, 256, 64, 64, torch.bfloat16, 1, "generic"),  # feat
        (8, 256, 64, 64, torch.bfloat16, 3, "generic"),  # w1
    ],
)
def test_choose_variant(b, d, v, h, dtype, shift, want):
    """The variant follows dtype, shape and alignment alone (the routing
    the wrapper's docstring names)."""
    args = list(_port_args(*_inputs(b, d, v, h), dtype=dtype))
    if shift is not None:
        args[shift] = _shifted(args[shift])
    assert fusion.choose_variant(args[0], args[1], args[3]) == want
