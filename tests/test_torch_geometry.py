"""The port's geometry (rot_mvgaze_tpu_torch.geometry) against the JAX
package's: float32 functions within 1e-6, float64 numpy twins exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu import geometry as jgeo
from rot_mvgaze_tpu_torch import geometry as tgeo

RNG = np.random.default_rng(0)
PITCHYAW = RNG.uniform(-1.2, 1.2, (64, 2)).astype(np.float32)
PITCHYAW_B = RNG.uniform(-1.2, 1.2, (64, 2)).astype(np.float32)
VECTORS = RNG.normal(size=(64, 3)).astype(np.float32)
VECTORS_B = RNG.normal(size=(64, 3)).astype(np.float32)


def _both(fn_name, *arrays, **kw):
    want = np.asarray(getattr(jgeo, fn_name)(*map(jnp.asarray, arrays), **kw))
    got = getattr(tgeo, fn_name)(*map(torch.from_numpy, arrays), **kw).numpy()
    return got, want


@pytest.mark.parametrize(
    "fn_name, arrays, kw",
    [
        ("pitchyaw_to_vector", (PITCHYAW,), {}),
        ("vector_to_pitchyaw", (VECTORS,), {}),
        ("rotation_matrix_2d", (PITCHYAW,), {}),
        ("rotation_matrix_2d", (PITCHYAW,), {"inverse": True}),
        ("rotation_matrix_2d", (PITCHYAW.reshape(4, 16, 2),), {}),
    ],
    ids=["py2vec", "vec2py", "rot", "rot-inverse", "rot-batched"],
)
def test_float32_functions_match_jax(fn_name, arrays, kw):
    got, want = _both(fn_name, *arrays, **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "a, b", [(PITCHYAW, PITCHYAW_B), (VECTORS, VECTORS_B)], ids=["pitchyaw", "vectors"]
)
def test_angular_error_matches_jax(a, b):
    """In degrees, at the JAX suite's golden bar (tests/test_geometry.py)."""
    got, want = _both("angular_error", a, b)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_angular_error_identical_is_finite_and_small():
    """At 0° the clamped cosine keeps arccos finite. arccos is ill-conditioned
    there: one f32 ulp below a cosine of 1 reads 0.0198°, in either package."""
    got = tgeo.angular_error(torch.from_numpy(PITCHYAW), torch.from_numpy(PITCHYAW))
    assert torch.isfinite(got).all() and got.abs().max() < 0.025


def test_rotation_is_orthonormal():
    r = tgeo.rotation_matrix_2d(torch.from_numpy(PITCHYAW)).double()
    eye = torch.eye(3, dtype=torch.float64).expand_as(r)
    torch.testing.assert_close(r @ r.transpose(-1, -2), eye, atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "fn_name, arrays",
    [
        ("pitchyaw_to_vector_numpy", (PITCHYAW,)),
        ("vector_to_pitchyaw_numpy", (VECTORS,)),
        ("angular_error_numpy", (PITCHYAW, PITCHYAW_B)),
        ("angular_error_numpy", (VECTORS, VECTORS_B)),
    ],
    ids=["py2vec", "vec2py", "err-pitchyaw", "err-vectors"],
)
def test_numpy_twins_equal_jax_packages(fn_name, arrays):
    got = getattr(tgeo, fn_name)(*arrays)
    want = getattr(jgeo, fn_name)(*arrays)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
