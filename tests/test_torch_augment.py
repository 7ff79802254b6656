"""The port's eval preprocessing (rot_mvgaze_tpu_torch.augment) against the
JAX package's at the identity resize: within one float32 ulp, because XLA
contracts ``x * (1/std) - mean/std`` into one fused multiply-add where
PyTorch rounds the product first."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.augment.ops import eval_preprocess as jax_eval_preprocess
from rot_mvgaze_tpu_torch.augment import eval_preprocess


@pytest.mark.parametrize("size", [32, 224])
def test_eval_preprocess_equals_jax(size):
    img = np.random.default_rng(size).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    got = eval_preprocess(torch.from_numpy(img), size)
    want = np.asarray(jax_eval_preprocess(jnp.asarray(img), size))
    assert got.dtype == torch.float32 and got.shape == (2, size, size, 3)
    # outputs lie in [-2.2, 2.7]: one ulp there is 2.4e-7 or 4.8e-7
    np.testing.assert_allclose(got.numpy(), want, atol=4.8e-7, rtol=0)


def test_resize_other_than_identity_raises():
    img = torch.zeros((1, 48, 48, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="not ported"):
        eval_preprocess(img, 32)
