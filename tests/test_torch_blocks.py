"""The port's block library (rot_mvgaze_tpu_torch.models.blocks: Conv2dNet,
Conv2dTransposeNet, weight_copy) against the JAX package's, with the JAX
variables carried across by compat.blocks_state_dict_from_jax, and the
profiling helpers (utils.trace, utils.device_memory_stats) on the CPU.
Float32 throughout; the JAX modules take NHWC, the port's NCHW."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.models.blocks import Conv2dNet as JaxConv2dNet
from rot_mvgaze_tpu.models.blocks import Conv2dTransposeNet as JaxConv2dTransposeNet
from rot_mvgaze_tpu_torch.compat import blocks_state_dict_from_jax
from rot_mvgaze_tpu_torch.models import Conv2dNet, Conv2dTransposeNet, weight_copy
from rot_mvgaze_tpu_torch.utils import device_memory_stats, trace

# name -> (JAX module, port module, constructor arguments, input NCHW)
NETS = {
    "conv": (JaxConv2dNet, Conv2dNet,
             dict(features=[4, 5, 6], kernels=[4, 4, 5], strides=[2, 2, 2], paddings=[1, 1, 2]),
             (4, 3, 32, 32)),
    "conv_defaults": (JaxConv2dNet, Conv2dNet, dict(features=[8, 3], kernels=[3, 1]), (3, 2, 12, 12)),
    "convt": (JaxConv2dTransposeNet, Conv2dTransposeNet,
              dict(features=[4, 2], kernels=[4, 4], strides=[2, 2], paddings=[1, 1]), (2, 3, 8, 8)),
    "convt_defaults": (JaxConv2dTransposeNet, Conv2dTransposeNet, dict(features=[5, 3, 2], kernels=[3, 2, 3]),
                       (3, 4, 5, 5)),
}
FWD = dict(atol=1e-5, rtol=1e-5)  # the BN bars: forward 1e-5
GRAD = dict(atol=5e-4, rtol=1e-3)  # gradients atol 5e-4 / rtol 1e-3


def _nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


@pytest.fixture(scope="module", params=list(NETS))
def pair(request):
    """JAX variables from init (BN statistics then set away from 0 / 1),
    the port's module with them loaded strictly, and a seeded input."""
    jax_cls, port_cls, kw, shape = NETS[request.param]
    rng = np.random.default_rng(sum(map(ord, request.param)))
    x = rng.standard_normal(shape).astype(np.float32)
    net = jax_cls(**kw)
    variables = jax.tree.map(np.asarray, jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(_nhwc(x))))
    stats = {k: {"mean": rng.normal(0.0, 0.1, v["mean"].shape).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)}
             for k, v in variables["batch_stats"].items()}
    variables = {"params": variables["params"], "batch_stats": stats}
    port = port_cls(shape[1], **kw)
    port.load_state_dict(blocks_state_dict_from_jax(variables), strict=True)
    return request.param, net, variables, port, x


def test_eval_forward_matches_jax(pair):
    name, net, variables, port, x = pair
    want = jax.jit(lambda v, x: net.apply(v, x, train=False))(variables, jnp.asarray(_nhwc(x)))
    got = port.eval()(torch.from_numpy(x)).detach().numpy()
    assert _nhwc(got).shape == want.shape, name
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **FWD, err_msg=name)


def test_train_forward_and_gradients_match_jax(pair):
    """Train mode: output and running statistics at the forward bar, the
    gradients of a seeded weighted sum of the output at the gradient bar."""
    name, net, variables, port, x = pair
    out_shape = jax.eval_shape(lambda v, x: net.apply(v, x, train=False), variables, _nhwc(x)).shape
    w = np.random.default_rng(7).standard_normal(out_shape).astype(np.float32)

    def loss(params):
        y, upd = net.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           jnp.asarray(_nhwc(x)), train=True, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd)

    (_, (want, updates)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))
    fresh = type(port)(x.shape[1], **NETS[name][2])
    fresh.load_state_dict(port.state_dict())
    fresh.train()
    got = fresh(torch.from_numpy(x))
    np.testing.assert_allclose(_nhwc(got.detach().numpy()), np.asarray(want), **FWD, err_msg=name)
    (got * torch.from_numpy(w.transpose(0, 3, 1, 2).copy())).sum().backward()

    new = blocks_state_dict_from_jax({"params": variables["params"],
                                      "batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])})
    for key, value in fresh.state_dict().items():
        if "running_" in key:
            np.testing.assert_allclose(value.numpy(), new[key].numpy(), **FWD, err_msg=key)
        if "num_batches_tracked" in key:
            assert int(value) == 1
    want_grads = blocks_state_dict_from_jax({"params": jax.tree.map(np.asarray, grads),
                                             "batch_stats": variables["batch_stats"]})
    for key, p in fresh.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[key].numpy(), **GRAD, err_msg=key)


@pytest.mark.parametrize("k, s, p", [(4, 2, 1), (3, 1, 0), (3, 2, 1), (5, 3, 2)])
def test_transpose_net_equals_torch_conv_transpose(k, s, p):
    """One layer of Conv2dTransposeNet is torch's ConvTranspose2d(k, s, p),
    shape and value, and so is the JAX net's (flax pad k-1-p, transposed
    kernel) with the same weights."""
    rng = np.random.default_rng(k * 100 + s * 10 + p)
    c_in, c_out = 2, 3
    x = rng.standard_normal((1, c_in, 5, 5)).astype(np.float32)
    bare = torch.nn.ConvTranspose2d(c_in, c_out, k, stride=s, padding=p)
    with torch.no_grad():
        bare.weight.copy_(torch.from_numpy(rng.standard_normal((c_in, c_out, k, k)).astype(np.float32)))
        bare.bias.copy_(torch.from_numpy(rng.standard_normal(c_out).astype(np.float32)))
    ref = bare(torch.from_numpy(x)).detach().numpy()
    assert ref.shape[2] == (5 - 1) * s - 2 * p + k

    net = Conv2dTransposeNet(c_in, [c_out], [k], [s], [p])
    net.blocks[0][0].load_state_dict(bare.state_dict())
    got = net(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)

    jax_net = JaxConv2dTransposeNet(features=[c_out], kernels=[k], strides=[s], paddings=[p])
    kernel = bare.weight.detach().numpy().transpose(2, 3, 1, 0)  # (k, k, out, in)
    params = {"convt_0": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bare.bias.detach().numpy())}}
    want = jax_net.apply({"params": params}, jnp.asarray(_nhwc(x)))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert set(blocks_state_dict_from_jax({"params": params})) == {"blocks.0.0.weight", "blocks.0.0.bias"}
    np.testing.assert_array_equal(blocks_state_dict_from_jax({"params": params})["blocks.0.0.weight"].numpy(),
                                  bare.weight.detach().numpy())


def test_state_dict_keys_follow_the_block_anatomy():
    net = Conv2dNet(3, [4, 2], [3, 3])
    assert list(net.state_dict()) == [
        "blocks.0.0.weight", "blocks.0.0.bias", "blocks.0.1.weight", "blocks.0.1.bias",
        "blocks.0.1.running_mean", "blocks.0.1.running_var", "blocks.0.1.num_batches_tracked",
        "blocks.1.0.weight", "blocks.1.0.bias",
    ]
    bn = net.blocks[0][1]
    assert (bn.eps, bn.momentum) == (1e-5, 0.1)
    assert isinstance(net.blocks[0][2], torch.nn.ReLU) and len(net.blocks[1]) == 1
    act = Conv2dTransposeNet(3, [4, 2], [3, 3]).blocks[0][2]
    assert isinstance(act, torch.nn.LeakyReLU) and act.negative_slope == 0.01
    with pytest.raises(ValueError, match="not a block"):
        blocks_state_dict_from_jax({"params": {"dense_0": {}}})


def test_weight_copy():
    torch.manual_seed(0)
    dst, src = Conv2dNet(3, [4, 2], [3, 3]), Conv2dNet(3, [4, 2], [3, 3])
    running = dst.blocks[0][1].running_mean.clone()
    src.blocks[0][1].running_mean.fill_(5.0)
    assert weight_copy(dst, src) is dst
    for (n, a), (_, b) in zip(dst.named_parameters(), src.named_parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(dst.blocks[0][1].running_mean, running)  # parameters only
    before = {n: p.clone() for n, p in dst.named_parameters()}
    with pytest.raises(ValueError, match="shape mismatch"):
        weight_copy(dst, Conv2dNet(3, [4, 2], [3, 5]))
    with pytest.raises(ValueError, match="names differ"):
        weight_copy(dst, Conv2dNet(3, [4, 4, 2], [3, 3, 3]))
    for n, p in dst.named_parameters():
        assert torch.equal(p, before[n]), n  # nothing copied on a refusal


def test_device_memory_stats_is_empty_without_a_card():
    assert device_memory_stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "profile")
    with trace(log_dir, device="cpu") as path:
        torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8), torch.ones(4, 3, 3, 3)).sum()
    assert path == os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
