"""Spatial partitioning in the port (rot_mvgaze_tpu_torch.parallel.spatial,
the backbone and the train step on height strips) on the CPU, against the
unsharded ops, the port's unsharded steps and the JAX package's 2-D
``(data, spatial)`` mesh over its 8 virtual CPU devices
(tests/test_spatial_partition.py).

- The strip conv and max-pool at every R50 site (kernel, stride, padding)
  over heights whose strips have odd boundaries and a short last strip,
  against ``F.conv2d`` / ``F.max_pool2d`` in float64: atol 1e-10.
- The BN over strips, forward and backward, against the unsharded op at
  the BN bars (forward 1e-5; gradients atol 5e-4 / rtol 1e-3); one strip
  is the one-launch path bit for bit.
- R18 at 64x64 over 2 strips, where layer4's 2 rows fall under the floor:
  eval-mode gradients against JAX's unsharded ones (rtol 1e-4 / atol
  1e-5), with the early stages on strips.
- Two SGD steps under ``(data 1, spatial 2)`` against JAX's ``(data 4,
  spatial 2)`` steps on the same pre-augmented batch: losses and running
  statistics at rtol 1e-4 / atol 1e-5, parameters within 2e-5; and against
  the port's unsharded steps. With augmentation on, the strips are cut
  after the draws.
- ``grad_accum 2``, ``freeze_bn``, ``fuse_views``, ``bn_stat_subsample 2``,
  ``remat`` and an in-process ``(data 2, spatial 2)`` mesh: one update
  against the same option unsharded.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from rot_mvgaze_tpu.losses import IterationLoss as JaxIterationLoss
from rot_mvgaze_tpu.losses import StereoL1Loss as JaxStereoL1Loss
from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu.models.resnet import resnet18 as jax_resnet18
from rot_mvgaze_tpu.parallel.mesh import image_sharding as jax_image_sharding
from rot_mvgaze_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rot_mvgaze_tpu.parallel.mesh import replicated_sharding as jax_replicated
from rot_mvgaze_tpu.parallel.mesh import shard_batch as jax_shard_batch
from rot_mvgaze_tpu.parallel.mesh import with_spatial_floor as jax_with_spatial_floor
from rot_mvgaze_tpu.train.steps import make_train_step as jax_make_train_step
from rot_mvgaze_tpu.train.trainer import TrainState
from rot_mvgaze_tpu_torch.compat import state_dict_from_jax
from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss
from rot_mvgaze_tpu_torch.models import FeatRotationSymm
from rot_mvgaze_tpu_torch.models.resnet import resnet18
from rot_mvgaze_tpu_torch.ops import batchnorm, fusion
from rot_mvgaze_tpu_torch.ops.batchnorm import fused_batchnorm_act, fused_batchnorm_act_blocks
from rot_mvgaze_tpu_torch.parallel import make_mesh, split_sizes, with_spatial_floor
from rot_mvgaze_tpu_torch.parallel.spatial import (
    Sharded,
    conv2d,
    fetch_rows,
    max_pool2d,
    shard_images,
)
from rot_mvgaze_tpu_torch.train import make_train_step

SIZE, BATCH = 64, 4
CFG = {"backbone_depth": 18, "num_iter": 1}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _strips(x, n):
    """x (N, C, H, W) as one group of GSPMD's n height strips."""
    out, h0 = [], 0
    for h in split_sizes(x.shape[2], n):
        out.append(x[:, :, h0:h0 + h].contiguous(memory_format=torch.channels_last))
        h0 += h
    return Sharded([out])


def _whole(s):
    return torch.cat(s.rows[0], dim=2)


# ------------------------------------------------------------ strip ops

# every R50 conv site (kernel, stride, padding): the stem, the 3x3 stride-1
# body, layer{2,3,4}.0.conv2's stride 2, the 1x1 body and the 1x1 stride-2
# downsample
SITES = {"stem": (7, 2, 3), "3x3": (3, 1, 1), "3x3_s2": (3, 2, 1), "1x1": (1, 1, 0), "1x1_s2": (1, 2, 0)}
# (height, strips): even splits, layer4's 14 -> 7 (4 + 3 out), short last
# strips (10 over 4: 3,3,3,1; 13 over 4; 20 over 4), an odd height over 2
HEIGHTS = [(56, 2), (14, 2), (10, 4), (13, 4), (20, 4), (7, 2)]




def _splits(h, n):
    """Whether every one of n strips of a height-h axis holds a row (where
    it would not, the backbone's floor has gathered the strips)."""
    return h - (n - 1) * -(-h // n) >= 1


CONV_CASES = [(site, h, n) for site in sorted(SITES) for h, n in HEIGHTS
              if _splits((h + 2 * SITES[site][2] - SITES[site][0]) // SITES[site][1] + 1, n)]


@pytest.mark.parametrize("site,h,n", CONV_CASES, ids=[f"{site}_h{h}_n{n}" for site, h, n in CONV_CASES])
def test_strip_conv_is_the_unsharded_conv(site, h, n):
    k, s, p = SITES[site]
    rng = np.random.default_rng(h * 7 + n)
    x = torch.from_numpy(rng.normal(size=(2, 5, h, 9))).contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.normal(size=(6, 5, k, k)))
    got = conv2d(_strips(x, n), w, None, s, p)
    want = F.conv2d(x, w, None, s, p)
    assert [t.shape[2] for t in got.rows[0]] == split_sizes(want.shape[2], n)
    assert all(t.is_contiguous(memory_format=torch.channels_last) for t in got.rows[0])
    torch.testing.assert_close(_whole(got), want, atol=1e-10, rtol=0)


POOL_CASES = [(h, n) for h, n in HEIGHTS if _splits((h - 1) // 2 + 1, n)]


@pytest.mark.parametrize("h,n", POOL_CASES, ids=[f"h{h}_n{n}" for h, n in POOL_CASES])
def test_strip_max_pool_is_the_unsharded_pool(h, n):
    """The stem's MaxPool2d(3, 2, 1): -inf above and below the image only
    (negative inputs, so a zero row would show)."""
    rng = np.random.default_rng(h + n)
    x = torch.from_numpy(-np.abs(rng.normal(size=(2, 5, h, 9)))).contiguous(memory_format=torch.channels_last)
    got = max_pool2d(_strips(x, n), 3, 2, 1)
    torch.testing.assert_close(_whole(got), F.max_pool2d(x, 3, 2, 1), atol=1e-10, rtol=0)


def test_halo_rows_come_from_the_neighbour_below():
    """layer4 at 224x224 over 2 strips: the input's 14 rows split 7 + 7,
    the output's 7 rows 4 + 3, so output strip 0 reads input rows -1..7 and
    row 7 lives in strip 1."""
    x = torch.arange(14.0).reshape(1, 1, 14, 1).expand(1, 2, 14, 3).contiguous(memory_format=torch.channels_last)
    row = _strips(x, 2).rows[0]
    got = fetch_rows(row, -1, 8, torch.device("cpu"), 0.0)
    assert got[0, 0, :, 0].tolist() == [0.0] + [float(i) for i in range(8)]
    assert got.is_contiguous(memory_format=torch.channels_last)
    last = fetch_rows(row, 7, 15, torch.device("cpu"), float("-inf"))
    assert last[0, 0, :, 0].tolist() == [float(i) for i in range(7, 14)] + [float("-inf")]


# ------------------------------------------------------------ BatchNorm

BN_CASES = [  # (residual, relu, subsample)
    (False, True, 1),
    (True, True, 1),
    (False, False, 1),
    (True, True, 2),
    (False, True, 4),
]
LAYOUTS = [(1, 2), (2, 2), (1, 4)]


def _bn_inputs(seed, n=8, c=8, h=10, w=6):
    rng = np.random.default_rng(seed)

    def t(*shape, **kw):
        return torch.from_numpy(rng.normal(size=shape, **kw).astype(np.float32))

    x = t(n, c, h, w, loc=0.5, scale=2.0).contiguous(memory_format=torch.channels_last)
    res = t(n, c, h, w).contiguous(memory_format=torch.channels_last)
    g = t(n, c, h, w).contiguous(memory_format=torch.channels_last)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    bias = t(c)
    return x, res, g, scale, bias


def _blocks(x, reps, n_strips):
    """x as reps data replicas (rows) of n_strips height strips."""
    b = x.shape[0] // reps
    return [_strips(x[r * b:(r + 1) * b], n_strips).rows[0] for r in range(reps)]


def _leaves(*ts):
    return [t.detach().clone().requires_grad_(True) for t in ts]


@pytest.mark.parametrize("layout", LAYOUTS, ids=[f"d{d}_s{s}" for d, s in LAYOUTS])
@pytest.mark.parametrize("case", BN_CASES, ids=[f"res{int(r)}_relu{int(a)}_k{k}" for r, a, k in BN_CASES])
def test_bn_over_strips_is_the_unsharded_bn(case, layout):
    residual, relu, k = case
    x, res, g, scale, bias = _bn_inputs(3)
    xa, ra, sa, ba = _leaves(x, res, scale, bias)
    y, mean, var = fused_batchnorm_act(xa, sa, ba, ra if residual else None, 1e-5, relu, k)
    y.backward(g)

    xb, rb, sb, bb = _leaves(x, res, scale, bias)
    reps, n = layout
    ys, mb, vb, count = fused_batchnorm_act_blocks(
        _blocks(xb, reps, n), sb, bb, _blocks(rb, reps, n) if residual else None, 1e-5, relu, k)
    assert count == (x.shape[0] // k) * x.shape[2] * x.shape[3]
    got_y = torch.cat([torch.cat(row, dim=2) for row in ys], dim=0)
    got_y.backward(g)
    torch.testing.assert_close(got_y, y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(mb, mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(vb, var, atol=1e-5, rtol=1e-5)
    pairs = [(xb.grad, xa.grad), (sb.grad, sa.grad), (bb.grad, ba.grad)]
    if residual:
        pairs.append((rb.grad, ra.grad))
    for got, want in pairs:
        torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)


def test_one_strip_is_the_one_launch_path_bit_for_bit():
    x, res, g, scale, bias = _bn_inputs(5)
    xa, ra, sa, ba = _leaves(x, res, scale, bias)
    y, mean, var = fused_batchnorm_act(xa, sa, ba, ra, 1e-5, True, 2)
    y.backward(g)
    xb, rb, sb, bb = _leaves(x, res, scale, bias)
    ys, mb, vb, _ = fused_batchnorm_act_blocks([[xb]], sb, bb, [[rb]], 1e-5, True, 2)
    ys[0][0].backward(g)
    for got, want in ((ys[0][0], y), (mb, mean), (vb, var), (xb.grad, xa.grad), (rb.grad, ra.grad),
                      (sb.grad, sa.grad), (bb.grad, ba.grad)):
        assert torch.equal(got, want)


# ------------------------------------------------------------ the backbone's floor


def _strip_counts(model):
    """Forward pre-hooks recording the strip count at every conv's input."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args, name=name: seen.append(
        (name, args[0].strips if isinstance(args[0], Sharded) else 0)))
        for name, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)]
    return seen, hooks


@pytest.mark.parametrize("size,n", [(64, 2), (80, 4)], ids=["64_over_2", "80_over_4"])
def test_floor_gradients_match_jax_unsharded(size, n, variables):
    """R18 in eval mode, the loss mean(out^2): at 64x64 over 2 strips
    layer4's output has 2 rows (1 per strip), at 80x80 over 4 layer2's has
    10 (3,3,3,1), so the floor gathers there; the gradients match JAX's
    unsharded ones, and the stages before the floor ran on strips."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    jmodel = jax_resnet18(dtype=jnp.float32)
    backbone = jax.tree.map(np.asarray, jmodel.init({"params": jax.random.PRNGKey(0)},
                                                    jnp.zeros((1, size, size, 3))))

    def loss_fn(params, x):
        out = jmodel.apply({"params": params, "batch_stats": backbone["batch_stats"]}, x, train=False)
        return jnp.mean(out ** 2)

    g_jax = jax.jit(jax.grad(loss_fn))(backbone["params"], jnp.asarray(x))
    model = resnet18().to(memory_format=torch.channels_last).eval()
    model.load_state_dict({**model.state_dict(), **_backbone_state(variables, backbone)}, strict=True)
    with_spatial_floor(model, make_mesh(["cpu"] * n, spatial=n))
    seen, hooks = _strip_counts(model)
    out = model(shard_images(torch.from_numpy(x), [["cpu"] * n]))
    for h in hooks:
        h.remove()
    out.square().mean().backward()
    got = {name: p.grad for name, p in model.named_parameters() if p.grad is not None}
    want = _backbone_state(variables, {"params": jax.tree.map(np.asarray, g_jax),
                                       "batch_stats": backbone["batch_stats"]})
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
    gathered_at = "layer4" if size == 64 else "layer2"
    assert all(c == n for name, c in seen if name < gathered_at or name in ("conv1",)), seen
    assert all(c == 1 for name, c in seen if name.startswith(gathered_at)), seen


def _backbone_state(model_vars, backbone):
    """A JAX R18 backbone's variables (or gradients in their tree) as the
    port backbone's state dict, through the stereo model's converter (the
    stereo model's variables ``model_vars`` carry the rest)."""
    merged = {"params": {**model_vars["params"], "backbone": backbone["params"]},
              "batch_stats": {**model_vars["batch_stats"], "backbone": backbone["batch_stats"]}}
    prefix = "_feat_extractor.0."
    return {k[len(prefix):]: v for k, v in state_dict_from_jax(merged, **CFG).items() if k.startswith(prefix)}


def _batch(seed=0, augmented=True):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if augmented:
        imgs = {v: rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(f32) for v in ("img_0", "img_1")}
    else:
        imgs = {v: rng.integers(0, 256, (BATCH, SIZE + 8, SIZE + 8, 3), dtype=np.uint8)
                for v in ("img_0", "img_1")}
    return {**imgs,
            "gt_gaze": rng.uniform(-1, 1, (BATCH, 2)).astype(f32),
            "gt_gaze_1": rng.uniform(-1, 1, (BATCH, 2)).astype(f32),
            "head_pose_0": rng.uniform(-0.8, 0.8, (BATCH, 2)).astype(f32),
            "head_pose_1": rng.uniform(-0.8, 0.8, (BATCH, 2)).astype(f32)}


@pytest.fixture(scope="module")
def variables():
    data = {"img_0": jnp.zeros((2, SIZE, SIZE, 3)), "img_1": jnp.zeros((2, SIZE, SIZE, 3)),
            "rot_0": jnp.broadcast_to(jnp.eye(3), (2, 3, 3)), "rot_1": jnp.broadcast_to(jnp.eye(3), (2, 3, 3))}
    return jax.tree.map(np.asarray, JaxFeatRotationSymm(**CFG).init({"params": jax.random.PRNGKey(0)}, data))


def _metrics():
    return IterationLoss(StereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)


def _jax_steps(variables, mesh=None, pallas=False):
    """JAX's two SGD steps (augment=False): on ``mesh`` (its 2-D mesh's
    GSPMD halos, XLA's BatchNorm) or unsharded with the Pallas kernels in
    interpret mode. Returns the losses and the state after each step, as
    port state dicts."""
    model = JaxFeatRotationSymm(**CFG, dtype=jnp.float32,
                                **({"use_pallas_bn": True, "use_pallas_fusion": True} if pallas else {}))
    metrics = JaxIterationLoss(loss=JaxStereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay=0.5)
    tx = optax.sgd(5e-2)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params))
    if mesh is None:
        batch = jax.tree.map(jnp.asarray, _batch())
        fn = jax.jit(jax_make_train_step(model, metrics, tx, image_size=SIZE, augment=False))
    else:
        rep = jax_replicated(mesh)
        state = jax.device_put(state, rep)
        batch = jax_shard_batch(_batch(), mesh)
        fn = jax.jit(jax_make_train_step(jax_with_spatial_floor(model, mesh), metrics, tx, image_size=SIZE,
                                         augment=False, image_sharding=jax_image_sharding(mesh)),
                     out_shardings=(rep, rep))
    losses, states = [], []
    for _ in range(2):
        state, stats = fn(state, batch, jax.random.PRNGKey(1))
        losses.append(float(stats["loss_gaze"]))
        states.append(state_dict_from_jax(
            jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats}), **CFG))
    return losses, states


@pytest.fixture(scope="module")
def jax_steps(variables):
    """JAX's steps on its (data 4, spatial 2) mesh, and unsharded on its
    Pallas kernels (the port's BatchNorm formulation)."""
    return {"data4_spatial2": _jax_steps(variables, jax_make_mesh(jax.devices(), spatial=2)),
            "pallas_bn": _jax_steps(variables, pallas=True)}


@contextlib.contextmanager
def _float64_plain_path():
    """The port's plain BatchNorm and fuser versions taking float64 (their
    float32/bfloat16 checks lifted): the yardstick of how closely a float32
    step can reach the true one."""
    codes = (batchnorm._DTYPE_CODES, fusion._DTYPE_CODES)
    check = batchnorm._check_vectors
    for c in codes:
        c[torch.float64] = -1
    batchnorm._check_vectors = lambda *args, **kwargs: None
    try:
        yield
    finally:
        for c in codes:
            del c[torch.float64]
        batchnorm._check_vectors = check


@pytest.fixture(scope="module")
def port_steps(variables):
    """The port's two SGD steps unsharded and under (data 1, spatial 2), in
    float32 and float64: losses and the state after each step."""
    batch = _batch()
    out = {}
    for name, mesh in (("unsharded", None), ("sp2", make_mesh(["cpu"] * 2, spatial=2))):
        for dtype in (torch.float32, torch.float64):
            model = FeatRotationSymm(**CFG)
            model.load_state_dict(state_dict_from_jax(variables, **CFG), strict=True)
            model = with_spatial_floor(model.to(dtype=dtype, memory_format=torch.channels_last), mesh)
            step = make_train_step(model, _metrics(), torch.optim.SGD(model.parameters(), lr=5e-2),
                                   image_size=SIZE, augment=False, mesh=mesh)
            tbatch = {k: torch.from_numpy(v).to(dtype) if k.startswith("img") else torch.from_numpy(v)
                      for k, v in batch.items()}
            losses, states = [], []
            with _float64_plain_path() if dtype == torch.float64 else contextlib.nullcontext():
                for i in range(2):
                    losses.append(float(step(tbatch, step=i)["loss_gaze"]))
                    states.append({k: v.detach().double() for k, v in model.state_dict().items()})
            out[name if dtype == torch.float32 else f"{name}_f64"] = (losses, states)
    return out


def _state_keys(state):
    return [k for k in state if "num_batches_tracked" not in k and not k.endswith(("fc.weight", "fc.bias"))]


def _hold(got, want, anchor, peer, atol, rtol, what):
    """``got`` within the bar (atol + rtol*|want|) of ``want``, or, where
    float32 cannot reach that (random-init gradients amplified by SGD's
    rate), no farther from ``anchor`` than 1.5x ``peer`` is (chip_smoke.py's
    rule for float32 gradients). Returns whether the bar held."""
    got, want, anchor, peer = (torch.as_tensor(t, dtype=torch.float64) for t in (got, want, anchor, peer))
    if bool(((got - want).abs() <= atol + rtol * want.abs()).all()):
        return True
    ours, theirs = float((got - anchor).abs().max()), float((peer - anchor).abs().max())
    assert ours <= 1.5 * theirs, f"{what}: {ours:.3e} from its anchor, its peer {theirs:.3e}"
    return False


# reference -> (anchor, peer) of _hold where a float32 bar is out of reach
REFERENCES = {
    # JAX's own spatial mesh: GSPMD halos, XLA's BatchNorm, whose float32
    # rounding differs from the port's formulation: no farther from it than
    # the port's unsharded steps are
    "jax_data4_spatial2": ("data4_spatial2", "reference", "unsharded"),
    # JAX unsharded on its Pallas kernels (the port's BatchNorm formulation)
    # and the port unsharded: no farther from the float64 steps than they are
    "jax_pallas_bn": ("pallas_bn", "unsharded_f64", "reference"),
    "port_unsharded": ("unsharded", "unsharded_f64", "reference"),
}


@pytest.mark.parametrize("against", sorted(REFERENCES))
def test_spatial_steps_match(against, jax_steps, port_steps):
    """Two SGD steps (rate 5e-2, JAX's spatial test) of the port under
    (data 1, spatial 2) against each reference, after each step: losses and
    running statistics at rtol 1e-4 / atol 1e-5, parameters within 2e-5,
    each held by :func:`_hold` where float32 cannot reach the bar: at random
    init the stem's gradient, amplified by two such steps, lies 1.6e-3 from
    float64 in the port's float32 runs, with the strips or without, and
    9.1e-4 in JAX's mesh run (XLA's BatchNorm)."""
    runs = {**jax_steps, **port_steps}
    name, anchor, peer = REFERENCES[against]
    runs["reference"] = runs[name]
    losses, states = port_steps["sp2"]
    (want_losses, want_states), (a_losses, a_states), (p_losses, p_states) = (
        runs[name], runs[anchor], runs[peer])
    beyond = []
    for i in range(2):
        _hold(losses[i], want_losses[i], a_losses[i], p_losses[i], 1e-5, 1e-4, f"loss {i}")
        for key in _state_keys(want_states[i]):
            stat = key.endswith(("running_mean", "running_var"))
            atol, rtol = (1e-5, 1e-4) if stat else (2e-5, 0.0)
            if not _hold(states[i][key], want_states[i][key], a_states[i][key], p_states[i][key], atol, rtol,
                         f"{key} {i}"):
                beyond.append(f"{key} (step {i + 1})")
    print(f"spatial steps against {against}: beyond float32's reach of the bar {beyond}")
    assert int(states[1]["_feat_extractor.0.layer1.0.bn1.num_batches_tracked"]) == 4  # per view and step


def test_spatial_steps_are_the_unsharded_steps_in_float64(port_steps):
    """The same two steps in float64: the strips change nothing but
    rounding (losses at rtol 1e-10, state within 1e-7)."""
    (losses, states), (want_losses, want_states) = port_steps["sp2_f64"], port_steps["unsharded_f64"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-10)
    for i in range(2):
        for key in _state_keys(want_states[i]):
            torch.testing.assert_close(states[i][key], want_states[i][key], atol=1e-7, rtol=0,
                                       msg=lambda m, key=key: f"{key}: {m}")
