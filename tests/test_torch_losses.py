"""The port's losses (rot_mvgaze_tpu_torch.losses) against the JAX package's
on the same numpy inputs: values, and gradients (``jax.grad`` against
autograd), at atol 1e-5 / rtol 1e-4 in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu import losses as jax_losses
from rot_mvgaze_tpu_torch import losses

ATOL, RTOL = 1e-5, 1e-4


def _pair(n=16, seed=0, equal=False):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-0.7, 0.7, (n, 2)).astype(np.float32)
    label = pred.copy() if equal else rng.uniform(-0.7, 0.7, (n, 2)).astype(np.float32)
    return pred, label


def _value_and_grad_torch(fn, pred, label):
    p = torch.from_numpy(pred).requires_grad_(True)
    value = fn(p, torch.from_numpy(label))
    value.backward()
    return value.detach().numpy(), p.grad.numpy()


@pytest.mark.parametrize("kind", ["angular", "l1", "l2"])
@pytest.mark.parametrize("equal", [False, True], ids=["random", "pred_equals_label"])
def test_gaze_loss_matches_jax(kind, equal):
    pred, label = _pair(equal=equal)
    if kind == "angular":
        # both take (prediction, label)
        port, ref = losses.make_gaze_loss(kind), jax_losses.make_gaze_loss(kind)
    else:
        # l1 / l2 take (label, prediction)
        port = lambda p, y: losses.make_gaze_loss(kind)(y, p)  # noqa: E731
        ref = lambda p, y: jax_losses.make_gaze_loss(kind)(y, p)  # noqa: E731
    value, grad = _value_and_grad_torch(port, pred, label)
    want_value, want_grad = jax.value_and_grad(ref)(jnp.asarray(pred), jnp.asarray(label))
    np.testing.assert_allclose(value, np.asarray(want_value), atol=ATOL, rtol=RTOL)
    assert np.all(np.isfinite(grad))
    np.testing.assert_allclose(grad, np.asarray(want_grad), atol=ATOL, rtol=RTOL)


def test_unknown_loss_type_raises():
    with pytest.raises(ValueError, match="unknown loss type"):
        losses.make_gaze_loss("huber")


def _model_output(num_iter=3, n=8, seed=1):
    rng = np.random.default_rng(seed)
    out = {
        "gt_gaze": rng.uniform(-0.6, 0.6, (n, 2)).astype(np.float32),
        "gt_gaze_1": rng.uniform(-0.6, 0.6, (n, 2)).astype(np.float32),
    }
    # keys out of numeric order: iter_10 must come after iter_2
    for i in list(range(num_iter))[::-1]:
        out[f"iter_{i}"] = {
            "pred_gaze_0": rng.uniform(-0.6, 0.6, (n, 2)).astype(np.float32),
            "pred_gaze_1": rng.uniform(-0.6, 0.6, (n, 2)).astype(np.float32),
        }
    return out


def _preds(out):
    return {k: v for k, v in out.items() if k.startswith("iter_")}


def _with_preds(out, preds, to_tensor):
    common = {k: to_tensor(v) for k, v in out.items() if not k.startswith("iter_")}
    return {**common, **preds}


@pytest.mark.parametrize(
    "num_iter, iter_decay, additional_decay",
    [(3, 0.5, None), (11, 0.5, None), (3, 0.5, 2.0), (1, 1.0, None)],
    ids=["shipped", "eleven_iters", "additional_decay", "one_iter"],
)
def test_iteration_loss_matches_jax(num_iter, iter_decay, additional_decay):
    """IterationLoss(StereoL1Loss(rel_weight=0.01)) as the CLI builds it;
    gradients with respect to every iteration's predictions."""
    out = _model_output(num_iter)
    port = losses.IterationLoss(
        losses.StereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay, additional_decay
    )
    ref = jax_losses.IterationLoss(
        jax_losses.StereoL1Loss(rel_weight=0.01, reference_decay=1.0), iter_decay, additional_decay
    )
    tpreds = {
        k: {kk: torch.from_numpy(vv).requires_grad_(True) for kk, vv in v.items()}
        for k, v in _preds(out).items()
    }
    value = port(_with_preds(out, tpreds, torch.from_numpy))
    value.backward()

    def ref_loss(preds):
        return ref(_with_preds(out, preds, jnp.asarray))

    jpreds = jax.tree.map(jnp.asarray, _preds(out))
    want_value, want_grads = jax.value_and_grad(ref_loss)(jpreds)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(want_value), atol=ATOL, rtol=RTOL)
    for k, v in tpreds.items():
        for kk, t in v.items():
            np.testing.assert_allclose(
                t.grad.numpy(), np.asarray(want_grads[k][kk]), atol=ATOL, rtol=RTOL,
                err_msg=f"{k}.{kk}",
            )


def test_stereo_loss_matches_jax_with_reference_decay():
    out = _model_output(1)
    data = {**{k: v for k, v in out.items() if not k.startswith("iter_")}, **out["iter_0"]}
    port = losses.StereoL1Loss(rel_weight=0.5, reference_decay=0.3)
    ref = jax_losses.StereoL1Loss(rel_weight=0.5, reference_decay=0.3)
    got = port({k: torch.from_numpy(v) for k, v in data.items()})
    want = ref({k: jnp.asarray(v) for k, v in data.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_stereo_loss_rejects_other_metrics():
    with pytest.raises(ValueError, match="angular_error"):
        losses.StereoL1Loss(distance_metric="l1")
