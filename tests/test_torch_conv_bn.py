"""The port's conv + BN-statistics op (rot_mvgaze_tpu_torch.ops.conv_bn) and
its probe on the CPU, where the op runs its plain version.

Against the JAX package's ``conv3x3_bn_stats`` (its Pallas kernel in
interpret mode, patched as tests/test_conv_bn.py patches it) on the same
numpy inputs, at the JAX suite's bars: out atol 3e-2, stats rtol 5e-3 /
atol 1.0. Against a float64 numpy oracle on the bf16-rounded inputs at
tighter bars, so that the algorithm is held and not only the JAX bar.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import rot_mvgaze_tpu.ops.conv_bn as jax_conv_bn
from rot_mvgaze_tpu_torch import probe_conv_bn_epilogue as probe
from rot_mvgaze_tpu_torch.ops import conv_bn


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _rand(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _corner_input():
    # mass only at the corner: the conv must see zeros beyond the border
    x = np.zeros((2, 4, 4, 128), np.float32)
    x[:, 0, 0, :] = 1.0
    return x


# name: (x, w, JAX batch_tile, x dtype)
CASES = {
    "tile2": (lambda: _rand((4, 6, 6, 128)), lambda: _rand((3, 3, 128, 128), 1, 0.05), 2, "f32"),
    "tile4": (lambda: _rand((4, 6, 6, 128)), lambda: _rand((3, 3, 128, 128), 1, 0.05), 4, "f32"),
    # a grid of 4 JAX programs: the stats must cover every image
    "grid4": (lambda: _rand((8, 4, 4, 128), 2), lambda: _rand((3, 3, 128, 128), 3, 0.05), 2, "f32"),
    "corner": (_corner_input, lambda: _rand((3, 3, 128, 128), 4, 0.05), 2, "f32"),
    "cout64": (lambda: _rand((4, 6, 6, 128), 5), lambda: _rand((3, 3, 128, 64), 6, 0.05), 2, "f32"),
    "c72": (lambda: _rand((4, 5, 7, 72), 7), lambda: _rand((3, 3, 72, 72), 8, 0.05), 2, "f32"),
    "bf16": (lambda: _rand((4, 6, 6, 128), 9), lambda: _rand((3, 3, 128, 128), 10, 0.05), 2, "bf16"),
}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _case(name):
    make_x, make_w, tile, dt = CASES[name]
    return make_x(), make_w(), tile, DTYPES[dt]


def _port(x, w, torch_dtype):
    out, stats = conv_bn.conv3x3_bn_stats(torch.from_numpy(x).to(torch_dtype), torch.from_numpy(w))
    return out.float().numpy(), stats.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_kernel(name):
    """Port (plain version) against JAX's Pallas kernel in interpret mode:
    out atol 3e-2 (bf16 rounding of the inputs on one side or both, and
    summation order), stats rtol 5e-3 / atol 1.0 (per-channel sums of
    zero-mean data cancel, so the absolute term carries them)."""
    x, w, tile, (tdt, jdt) = _case(name)
    out, stats = _port(x, w, tdt)
    want, want_stats = jax_conv_bn.conv3x3_bn_stats(jnp.asarray(x, jdt), jnp.asarray(w), batch_tile=tile)
    assert out.shape == want.shape and stats.shape == (2, w.shape[3])
    np.testing.assert_allclose(out, np.asarray(want, np.float32), atol=3e-2, rtol=0)
    np.testing.assert_allclose(stats, np.asarray(want_stats), rtol=5e-3, atol=1.0)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).double().numpy()


def _oracle(x, w):
    """float64 convolution of the bf16-rounded inputs, zero-padded, and the
    (sum, sum of squares) of its output over rows."""
    xb, wb = _bf16(x), _bf16(w)
    b, h, wd, _ = x.shape
    xp = np.pad(xb, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = np.zeros((b, h, wd, w.shape[3]))
    for dy in range(3):
        for dx in range(3):
            out += np.einsum("bhwc,cn->bhwn", xp[:, dy:dy + h, dx:dx + wd], wb[dy, dx])
    flat = out.reshape(-1, w.shape[3])
    return out, np.stack([flat.sum(0), (flat * flat).sum(0)])


@pytest.mark.parametrize("name", list(CASES))
def test_matches_float64_oracle(name):
    """The plain version against float64 on the same bf16-rounded inputs.
    float32 out: its float32 accumulation over K = 9C products, atol 1e-5.
    bf16 out: one rounding of that, half a bf16 ulp (rtol 2^-8) plus the
    same atol. Stats: float32 accumulators summed in float64, rtol 1e-5 /
    atol 1e-3 (about 1e-6 per accumulator over at most 288 rows)."""
    x, w, _, (tdt, _) = _case(name)
    out, stats = _port(x, w, tdt)
    want, want_stats = _oracle(x, w)
    rtol = 2.0**-8 if tdt == torch.bfloat16 else 0.0
    np.testing.assert_allclose(out, want, atol=1e-5, rtol=rtol)
    np.testing.assert_allclose(stats, want_stats, rtol=1e-5, atol=1e-3)


def test_f32_out_is_the_accumulator_and_stats_come_from_it():
    """A float32 x returns the float32 accumulator; the stats are its sums,
    not those of a bf16-rounded output (the JAX kernel's :70-72)."""
    x, w = _rand((3, 5, 5, 16), 11), _rand((3, 3, 16, 24), 12, 0.3)
    out, stats = conv_bn.conv3x3_bn_stats(torch.from_numpy(x), torch.from_numpy(w))
    flat = out.double().reshape(-1, 24)
    np.testing.assert_allclose(stats[0].numpy(), flat.sum(0).numpy(), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(stats[1].numpy(), (flat * flat).sum(0).numpy(), rtol=1e-6, atol=1e-4)
    out16, stats16 = conv_bn.conv3x3_bn_stats(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w))
    assert out16.dtype == torch.bfloat16
    torch.testing.assert_close(stats16, stats, atol=0, rtol=0)  # same accumulator


def test_rejects_bad_shapes():
    x = torch.from_numpy(_rand((4, 6, 6, 128)))
    with pytest.raises(ValueError, match="w must be"):
        conv_bn.conv3x3_bn_stats(x, torch.from_numpy(_rand((5, 5, 128, 128))))
    with pytest.raises(ValueError, match="w must be"):
        conv_bn.conv3x3_bn_stats(x, torch.from_numpy(_rand((3, 3, 64, 128))))
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        conv_bn.conv3x3_bn_stats(x[0], torch.from_numpy(_rand((3, 3, 128, 128))))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv_bn.conv3x3_bn_stats(x.double(), torch.from_numpy(_rand((3, 3, 128, 128))))


def test_cpu_tensors_never_launch():
    before = conv_bn.conv3x3_bn_stats.launches
    conv_bn.conv3x3_bn_stats(torch.from_numpy(_rand((1, 3, 3, 8))), torch.from_numpy(_rand((3, 3, 8, 8))))
    assert conv_bn.conv3x3_bn_stats.launches == before == 0


@pytest.mark.parametrize(
    "m, c, cout, splits",
    [(64 * 56 * 56, 64, 64, 1), (64 * 28 * 28, 128, 128, 1), (64 * 14 * 14, 256, 256, 1),
     (64 * 7 * 7, 512, 512, 2), (256 * 14 * 14, 256, 256, 1), (3 * 5 * 7, 72, 40, None)],
    ids=["l1", "l2", "l3", "l4", "probe", "ragged"],
)
def test_split_plan_covers_k(m, c, cout, splits):
    """On 132 SMs: one split wherever the output tiles fill the card, two at
    R50 layer 4 (64 images); every plan covers K = 9C with whole K tiles and
    no empty split."""
    k = 9 * c
    k_chunk, n = conv_bn.plan_splits(m, cout, k, 132)
    if splits is not None:
        assert n == splits
    assert k_chunk % conv_bn._BK == 0 and n * k_chunk >= k > (n - 1) * k_chunk


PROBE_KEYS = {
    "out_max_abs_diff", "stats_max_rel_diff", "library_conv_ms", "library_conv_plus_stats_ms",
    "kernel_ms", "plain_ms", "bound_ms", "bound_by", "verdict", "device",
}


def test_run_probe_on_cpu_returns_the_record():
    record = probe.run_probe(batch=2, hw=4, c=16, steps=2, device="cpu")
    assert PROBE_KEYS <= set(record)
    assert record["verdict"] in ("lever_real", "falsified")
    assert record["out_max_abs_diff"] <= 3e-2 and record["device"] == "cpu"
    assert record["bound_by"] == "bytes"  # a toy shape moves more bytes than it computes
    assert all(record[k] > 0 for k in ("library_conv_ms", "kernel_ms", "plain_ms", "bound_ms"))


def test_probe_main_reads_the_environment(monkeypatch, capsys):
    for key, value in {"PROBE_BATCH": "1", "PROBE_HW": "3", "PROBE_C": "8", "PROBE_STEPS": "1"}.items():
        monkeypatch.setenv(key, value)
    assert probe.main(["--device", "cpu"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (record["B"], record["HW"], record["C"], record["n_steps"]) == (1, 3, 8, 1)
    assert PROBE_KEYS <= set(record)


def test_bound_at_the_probe_shape():
    """59.2 GFLOP at 989 TFLOP/s bf16: operations bind, not the 52.6 MB."""
    b = probe.bound(256, 14, 256, 256)
    assert b["flops"] == 2 * 256 * 14 * 14 * 9 * 256 * 256
    assert b["bound_by"] == "operations"
    assert abs(b["bound_ms"] - b["flops"] / 989e12 * 1e3) < 1e-12
    assert 52e6 < b["bytes"] < 53e6
