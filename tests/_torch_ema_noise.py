"""How far apart two float32 runs of the EMA probe's epoch lie, and why the
port's lies farther from JAX's than from its own float64 run: the readings
behind tests/test_torch_ema_probe.py's bars. Run it from the repository's
root on the CPU (about two minutes)::

    JAX_PLATFORMS=cpu python tests/_torch_ema_noise.py

It prints, for the test's three updates at the probe's rate (same start,
same batches): each run's update gap to another by the median and the worst
leaf (the test's ``update_gaps``) and its raw and averaged eval errors; then
the first update's gradient (plain SGD at rate 1) of the port's float64 step
against JAX's float32 step, before and after the one ReLU element nearest
zero at the output of each backbone block is moved to the other side of
zero (by twice its float64 value) in the port's float64 forward.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import contextlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import test_torch_ema_probe as t  # noqa: E402
from rot_mvgaze_tpu.data import BatchLoader as JaxBatchLoader  # noqa: E402
from rot_mvgaze_tpu.data import GazeDataset as JaxGazeDataset  # noqa: E402
from rot_mvgaze_tpu.evaluate import evaluate_gaze as jax_evaluate_gaze  # noqa: E402
from rot_mvgaze_tpu_torch.compat import state_dict_from_jax  # noqa: E402
from rot_mvgaze_tpu_torch.data import BatchLoader, GazeDataset, write_synthetic_dataset  # noqa: E402
from rot_mvgaze_tpu_torch.losses import IterationLoss, StereoL1Loss  # noqa: E402
from rot_mvgaze_tpu_torch.ops import batchnorm, fusion  # noqa: E402
from rot_mvgaze_tpu_torch.train import init_ema, make_optimizer, make_train_step  # noqa: E402

PLAIN = [(fusion, "rotate_concat_matmul_relu")] + [
    (batchnorm, n) for n in ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx")]


@contextlib.contextmanager
def plain_versions():
    """The wrappers' plain versions, which also take float64."""
    kept = [getattr(m, n) for m, n in PLAIN]
    for m, n in PLAIN:
        setattr(m, n, getattr(m, f"{n}_reference"))
    try:
        yield
    finally:
        for (m, n), k in zip(PLAIN, kept):
            setattr(m, n, k)


def jax_state(variables, batches, tx, pallas, ema_decay=0.0):
    kw = {"use_pallas_bn": True, "use_pallas_fusion": True} if pallas else {}
    step = jax.jit(t.jax_make_train_step(
        t.JaxFeatRotationSymm(**t.CFG, **kw),
        t.JaxIterationLoss(loss=t.JaxStereoL1Loss(rel_weight=0.01), iter_decay=0.5), tx,
        image_size=t.SIZE, augment=False, ema_decay=ema_decay))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = t.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                         opt_state=tx.init(params),
                         ema_params=jax.tree.map(jnp.copy, params) if ema_decay else None)
    for b in batches:
        state, _ = step(state, jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(0))
    return state


def port_steps(variables, batches, dtype, optimizer=None, ema_decay=0.0, hooks=()):
    model = t._port_model(variables).to(dtype)
    for module, hook in hooks:
        module(model).register_forward_pre_hook(hook)
    ema = init_ema(model) if ema_decay else None
    opt = optimizer(model) if optimizer else make_optimizer(model.parameters(), lr=t.LR)
    step = make_train_step(model, IterationLoss(StereoL1Loss(rel_weight=0.01), iter_decay=0.5), opt,
                           image_size=t.SIZE, augment=False, ema_decay=ema_decay, ema=ema,
                           fold_key_by_step=True)
    gen = torch.Generator().manual_seed(0)
    with plain_versions():
        for i, b in enumerate(batches):
            step({k: torch.from_numpy(v).to(dtype) for k, v in b.items()}, gen, step=i)
    state = {k: v.detach().float() for k, v in model.state_dict().items()}
    avg = dict(state, **{k: v.detach().float() for k, v in ema.items()}) if ema else None
    return state, avg


def score(state, loader):
    model = t.FeatRotationSymm(**t.CFG)
    model.load_state_dict(state)
    return t.evaluate_gaze(model, loader, image_size=t.SIZE)


def block_outputs(model):
    """The backbone's residual-block BNs, whose outputs are the blocks'."""
    backbone = model._feat_extractor[0]
    return [(name, block.bn2) for layer in ("layer1", "layer2", "layer3", "layer4")
            for i, block in enumerate(getattr(backbone, layer)) for name in [f"{layer}.{i}"]]


def main() -> None:
    import tempfile

    torch.set_num_threads(4)
    data = {"img_0": jnp.zeros((2, t.SIZE, t.SIZE, 3)), "img_1": jnp.zeros((2, t.SIZE, t.SIZE, 3)),
            "rot_0": jnp.broadcast_to(jnp.eye(3), (2, 3, 3)), "rot_1": jnp.broadcast_to(jnp.eye(3), (2, 3, 3))}
    variables = jax.tree.map(np.asarray, jax.jit(t.JaxFeatRotationSymm(**t.CFG).init)(jax.random.PRNGKey(0), data))
    start = state_dict_from_jax(variables, **t.CFG)
    batches = t._float_batches(seed=5)
    tmp = tempfile.mkdtemp(prefix="ema_noise_")
    names = write_synthetic_dataset(tmp, ["e0.h5"], n_frames=2, image_size=t.SIZE, learnable=True, seed=77)
    loader = BatchLoader(GazeDataset("xgaze", tmp, "bgr", names, seed=0), batch_size=t.BATCH)
    jax_loader = JaxBatchLoader(JaxGazeDataset("xgaze", tmp, "bgr", names, seed=0), batch_size=t.BATCH)

    runs = {}
    for name, pallas in (("JAX plain", False), ("JAX Pallas", True)):
        s = jax_state(variables, batches, t.jax_make_optimizer(lambda _t: t.LR), pallas, t.DECAY)
        stats = jax.tree.map(np.asarray, s.batch_stats)
        runs[name] = (state_dict_from_jax({"params": jax.tree.map(np.asarray, s.params), "batch_stats": stats},
                                          **t.CFG),
                      state_dict_from_jax({"params": jax.tree.map(np.asarray, s.ema_params),
                                           "batch_stats": stats}, **t.CFG))
        errors = [jax_evaluate_gaze(t.JaxFeatRotationSymm(**t.CFG), {"params": p, "batch_stats": s.batch_stats},
                                    jax_loader, image_size=t.SIZE) for p in (s.params, s.ema_params)]
        print(f"{name}: raw {errors[0]:.6f} deg, average {errors[1]:.6f} deg (JAX's scoring)")
    for name, dtype in (("port float32", torch.float32), ("port float64", torch.float64)):
        runs[name] = port_steps(variables, batches, dtype, ema_decay=t.DECAY)
    print(f"start: {score(start, loader):.6f} deg")
    for name, (raw, avg) in runs.items():
        print(f"{name}: raw {score(raw, loader):.6f} deg, average {score(avg, loader):.6f} deg")
    for a, b in (("port float32", "port float64"), ("JAX Pallas", "JAX plain"), ("port float32", "JAX plain"),
                 ("JAX plain", "port float64")):
        print(f"update gap, {a} against {b}: parameters {t._summary(t.update_gaps(runs[a][0], runs[b][0], start))}; "
              f"average {t._summary(t.update_gaps(runs[a][1], runs[b][1], start))}")

    # the first update's gradient: SGD at rate 1 moves each leaf by -g
    sgd = lambda model: torch.optim.SGD(model.parameters(), lr=1.0)  # noqa: E731
    s = jax_state(variables, batches[:1], optax.sgd(1.0), pallas=False)
    jax_grad = state_dict_from_jax(jax.tree.map(np.asarray, {"params": s.params, "batch_stats": s.batch_stats}),
                                   **t.CFG)
    nearest, seen = {}, {}

    def watch(name):
        def hook(mod, args):
            c, ident = args
            m = c.mean((0, 2, 3), keepdim=True)
            var = c.var((0, 2, 3), unbiased=False, keepdim=True)
            pre = (c - m) / torch.sqrt(var + mod.eps) * mod.weight.view(1, -1, 1, 1) + mod.bias.view(1, -1, 1, 1)
            pre = pre + ident
            i = int(pre.abs().flatten().argmin())
            view = seen[name] = seen.get(name, -1) + 1
            if name not in nearest or abs(pre.flatten()[i]) < abs(nearest[name][2]):
                nearest[name] = (view, i, float(pre.flatten()[i]))
        return hook

    probe = t._port_model(variables)
    hooks = [(lambda mdl, n=n: dict(block_outputs(mdl))[n], watch(n)) for n, _ in block_outputs(probe)]
    plain64, _ = port_steps(variables, batches[:1], torch.float64, optimizer=sgd, hooks=hooks)
    gaps = t.update_gaps(plain64, jax_grad, start)
    print(f"first gradient, port float64 against JAX float32: {t._summary(gaps)}")
    name = min(nearest, key=lambda n: abs(nearest[n][2]))
    call, index, value = nearest[name]
    print(f"nearest zero at a block output: {name}, view {call}, element {index}, float64 value {value:.3e}")
    calls = []

    def nudge(mod, args):
        calls.append(1)
        if len(calls) - 1 != call:
            return None
        c, ident = args
        delta = torch.zeros_like(ident)
        delta[np.unravel_index(index, tuple(ident.shape))] = -2 * value
        return c, ident + delta

    opened, _ = port_steps(variables, batches[:1], torch.float64, optimizer=sgd,
                           hooks=[(lambda mdl: dict(block_outputs(mdl))[name], nudge)])
    print(f"first gradient with that element across zero, port float64 against JAX float32: "
          f"{t._summary(t.update_gaps(opened, jax_grad, start))}")


if __name__ == "__main__":
    main()
