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
from rot_mvgaze_tpu_torch.ops import fusion


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
