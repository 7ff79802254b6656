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


# ---------------------------------------------------------------------------
# train stack: deterministic cores equal JAX's given the same parameters,
# and the draws follow JAX's distributions (two-sample KS, the JAX ops as
# the oracle)
# ---------------------------------------------------------------------------

import jax  # noqa: E402
from scipy.stats import ks_2samp  # noqa: E402

from rot_mvgaze_tpu.augment.ops import (  # noqa: E402
    _affine_warp_nearest as jax_affine_warp_nearest,
    _jitter_one as jax_jitter_one,
    color_jitter as jax_color_jitter,
    random_affine as jax_random_affine,
    random_multi_erasing as jax_random_multi_erasing,
    train_preprocess as jax_train_preprocess,
)
from rot_mvgaze_tpu_torch.augment import ops  # noqa: E402

KS_N = 2000
KS_P = 1e-3


def _image(h=24, w=20, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(np.float32)


@pytest.mark.parametrize(
    "scale, tx, ty",
    [(1.0, 0.0, 0.0), (0.99, 2.0, -1.0), (1.01, -2.0, 2.0), (0.8, 5.0, 3.0), (1.3, -4.0, 0.0)],
)
def test_affine_warp_equals_jax(scale, tx, ty):
    img = _image()
    want = np.asarray(jax_affine_warp_nearest(jnp.asarray(img), jnp.float32(scale), jnp.float32(tx), jnp.float32(ty)))
    got = ops.affine_warp_nearest(
        torch.from_numpy(img)[None], torch.tensor([scale]), torch.tensor([tx]), torch.tensor([ty])
    )[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", [0, 1, 2], ids=["brightness", "contrast", "saturation"])
@pytest.mark.parametrize("factor", [0.0, 0.37, 0.95, 1.1, 1.9])
def test_jitter_op_equals_jax(op, factor):
    """Within 2 float32 ulps at 1: XLA may contract the blend into fused
    multiply-adds and sums the luma mean in another order."""
    img = _image(seed=1)
    want = np.asarray(jax_jitter_one(jnp.asarray(img), jnp.int32(op), jnp.float32(factor)))
    got = ops.jitter_blend(torch.from_numpy(img)[None], torch.tensor([op]), torch.tensor([factor]))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=2.4e-7, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_color_jitter_equals_jax_given_its_draws(seed):
    """JAX's factors and order for a key, fed to the port's core."""
    key = jax.random.PRNGKey(seed)
    k_perm, k_b, k_c, k_s = jax.random.split(key, 4)
    factors = np.asarray([
        jax.random.uniform(k_b, (), minval=0.0, maxval=2.0),
        jax.random.uniform(k_c, (), minval=0.9, maxval=1.1),
        jax.random.uniform(k_s, (), minval=0.9, maxval=1.1),
    ])[None]
    order = np.asarray(jax.random.permutation(k_perm, 3))[None]
    img = _image(seed=2)
    want = np.asarray(jax_color_jitter(key, jnp.asarray(img)))
    got = ops.apply_color_jitter(
        torch.from_numpy(img)[None], torch.from_numpy(factors), torch.from_numpy(order).long()
    )[0]
    np.testing.assert_allclose(got.numpy(), want, atol=5e-7, rtol=0)


@pytest.mark.parametrize("seed", range(6))
def test_erasing_mask_equals_jax_given_its_draws(seed):
    """JAX's dot, proportion and keep grid for a key, fed to the port's core:
    the mask is exact."""
    key = jax.random.PRNGKey(seed)
    _, k_dot, k_prop, k_grid = jax.random.split(key, 4)
    dot = jax.random.uniform(k_dot, (), minval=0.05, maxval=0.3)
    prop = jax.random.uniform(k_prop, (), minval=0.5, maxval=0.6)
    grid = jax.random.uniform(k_grid, (ops.MAX_ERASE_GRID, ops.MAX_ERASE_GRID))
    h, w = 37, 50
    want = np.asarray(jax_random_multi_erasing(key, jnp.ones((h, w, 1)), p=1.0))[..., 0]
    got = ops.multi_erasing_mask(
        torch.tensor([float(dot)]), torch.tensor([float(prop)]),
        torch.from_numpy(np.asarray(grid))[None], h, w,
    )[0]
    np.testing.assert_array_equal(got.numpy().astype(np.float32), want)


# --- draws, recovered from each op's output on images made to reveal them


def _jitter_probe():
    """2x2 image: gray 0.2, gray 0.3, and twice the colour (0.3, 0.2, 0.25).
    Unclipped, jitter is f_b * [f_c f_s x + f_c (1-f_s) luma + (1-f_c) M]
    in any op order, so the factors can be read back from the output."""
    img = np.array([[[0.2] * 3, [0.3] * 3], [[0.3, 0.2, 0.25], [0.3, 0.2, 0.25]]], np.float32)
    return img


def _jitter_factors(out: np.ndarray):
    """(f_b, f_c, f_s) per sample from (n, 2, 2, 3) jittered probes."""
    img = _jitter_probe()
    w = np.array([0.299, 0.587, 0.114])
    m = (img @ w).mean()
    out = out.astype(np.float64)
    fb = (out @ w).mean(axis=(1, 2)) / m
    fc = (out[:, 0, 1, 0] - out[:, 0, 0, 0]) / (0.1 * fb)
    fs = (out[:, 1, 0, 0] - out[:, 1, 0, 1]) / (0.1 * fb * fc)
    return fb, fc, fs


def _both_affine(h=60, w=60):
    keys = jax.random.split(jax.random.PRNGKey(7), KS_N)
    img = (np.arange(h)[:, None] * w + np.arange(w)[None, :] + 1).astype(np.float32)[..., None]
    kw = dict(scale_range=(0.7, 1.3), translate=(0.05, 0.05))
    want = np.asarray(jax.vmap(lambda k: jax_random_affine(k, jnp.asarray(img), **kw))(keys))
    g = torch.Generator().manual_seed(7)
    b = torch.from_numpy(img)[None].expand(KS_N, h, w, 1)
    got = ops.affine_warp_nearest(b, *ops.draw_affine(KS_N, h, w, g, b.device, **kw)).numpy()
    return want, got


@pytest.fixture(scope="module")
def jitter_draws():
    probe = _jitter_probe()
    keys = jax.random.split(jax.random.PRNGKey(11), KS_N)
    want = np.asarray(jax.vmap(lambda k: jax_color_jitter(k, jnp.asarray(probe)))(keys))
    g = torch.Generator().manual_seed(11)
    got = ops.color_jitter(torch.from_numpy(probe)[None].expand(KS_N, 2, 2, 3).contiguous(), g).numpy()
    return _jitter_factors(want), _jitter_factors(got)


@pytest.mark.parametrize("which", [0, 1, 2], ids=["brightness", "contrast", "saturation"])
def test_jitter_factor_distributions_match_jax(jitter_draws, which):
    (jb, jc, js), (pb, pc, ps) = jitter_draws
    want, got = (jb, jc, js)[which], (pb, pc, ps)[which]
    if which:
        # contrast and saturation are read through f_b: drop samples with
        # f_b < 0.05 on both sides (f_b is drawn independently of them)
        want, got = want[jb > 0.05], got[pb > 0.05]
    lo, hi = ((0.0, 2.0), (0.9, 1.1), (0.9, 1.1))[which]
    assert lo - 1e-3 <= got.min() and got.max() <= hi + 1e-3
    assert ks_2samp(want, got).pvalue > KS_P


def _warp_params(out: np.ndarray, h: int, w: int):
    """(scale, tx, ty) per sample from warps of the image y*w + x + 1: a
    line fit of the source index against the output index, along the middle
    row and the middle column; t = c - (c + t)/s solved for t, rounded to
    the whole pixel it was drawn as."""
    scales, shifts = [], []
    for o in out[..., 0]:
        row, col = o[h // 2, :], o[:, w // 2]
        sx, tx = _fit((row - 1) % w, row > 0, w)
        sy, ty = _fit((col - 1) // w, col > 0, h)
        scales.append((sx + sy) / 2)
        shifts.append((tx, ty))
    shifts = np.asarray(shifts)
    return np.asarray(scales), shifts[:, 0], shifts[:, 1]


def _fit(src, keep, size):
    p = np.arange(size)[keep]
    slope, icpt = np.polyfit(p, src[keep], 1)
    c = (size - 1) / 2
    # src = c + (p - c - t)/s  =>  slope = 1/s, icpt = c - (c + t)/s
    s = 1.0 / slope
    t = (c - icpt) * s - c
    return s, np.round(t)


@pytest.fixture(scope="module")
def affine_draws():
    h = w = 60
    want, got = _both_affine(h, w)
    return _warp_params(want, h, w), _warp_params(got, h, w)


@pytest.mark.parametrize("which", [0, 1, 2], ids=["scale", "tx", "ty"])
def test_affine_draw_distributions_match_jax(affine_draws, which):
    """scale_range=(0.7, 1.3), wide enough for a 60-pixel warp to show the
    scale (the default 1% moves no nearest pixel by more than 0.3), and
    translate=(0.05, 0.05): shifts round(U[-3, 3])."""
    want, got = affine_draws[0][which], affine_draws[1][which]
    if which:
        assert set(np.unique(got)) <= {-3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0}
    else:
        assert 0.69 < got.min() < 0.72 and 1.28 < got.max() < 1.31
    assert ks_2samp(want, got).pvalue > KS_P


def test_erased_fraction_distribution_matches_jax():
    h = w = 40
    keys = jax.random.split(jax.random.PRNGKey(13), KS_N)
    want = np.asarray(
        jax.vmap(lambda k: jax_random_multi_erasing(k, jnp.ones((h, w, 1)), p=1.0))(keys)
    )
    got = ops.random_multi_erasing(
        torch.ones(KS_N, h, w, 1), torch.Generator().manual_seed(13), p=1.0
    ).numpy()
    want_frac, got_frac = (want == 0).mean(axis=(1, 2, 3)), (got == 0).mean(axis=(1, 2, 3))
    assert abs(want_frac.mean() - got_frac.mean()) < 0.01
    assert ks_2samp(want_frac, got_frac).pvalue > KS_P


def test_erasing_gate_rate():
    """p=0.5: about half of the samples are erased at all (binomial, n=2000:
    sd 0.011)."""
    got = ops.random_multi_erasing(
        torch.ones(KS_N, 16, 16, 1), torch.Generator().manual_seed(17), p=0.5
    )
    rate = float((got == 0).flatten(1).any(1).float().mean())
    assert 0.45 < rate < 0.55


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_preprocess_same_seed_same_output(dtype):
    img = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8))
    a = ops.train_preprocess(img, torch.Generator().manual_seed(5), 32, dtype)
    b = ops.train_preprocess(img, torch.Generator().manual_seed(5), 32, dtype)
    c = ops.train_preprocess(img, torch.Generator().manual_seed(6), 32, dtype)
    assert a.dtype == dtype and a.shape == (3, 32, 32, 3)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)


def test_train_preprocess_output_distribution_matches_jax():
    """Per-image mean of the whole train stack on one uint8 image, n=2000
    draws on each side."""
    img = np.random.default_rng(4).integers(0, 256, (1, 24, 24, 3), dtype=np.uint8)
    want = np.asarray(
        jax_train_preprocess(jax.random.PRNGKey(19), jnp.asarray(np.repeat(img, KS_N, 0)), 24)
    ).mean(axis=(1, 2, 3))
    got = ops.train_preprocess(
        torch.from_numpy(img).expand(KS_N, 24, 24, 3), torch.Generator().manual_seed(19), 24
    ).mean(dim=(1, 2, 3)).numpy()
    assert ks_2samp(want, got).pvalue > KS_P
