"""The port's forward check and multi-device dry run
(rot_mvgaze_tpu_torch.dryrun) on the CPU: dryrun_multichip(2, "reduced")
and dryrun_multichip(2, "multiview") over ["cpu"] * 2 (the loss falls over
a repeated batch, the update count advances, the evaluation over the mesh
takes a ragged batch), its refusals, and entry()'s seeded bf16 forward."""

import pytest
import torch

from rot_mvgaze_tpu_torch import dryrun


@pytest.fixture(autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_dryrun_multichip_on_two_cpu_devices(capsys):
    run = dryrun.dryrun_multichip(2, config="reduced", device="cpu")
    assert run["devices"] == ["cpu", "cpu"] and run["updates"] == 4
    losses = run["losses"]
    assert (losses[-2] + losses[-1]) / 2 < (losses[0] + losses[1]) / 2
    assert (run["eval_rows"], run["padded_to"]) == (3, 4)
    assert "dryrun_multichip(2) OK [reduced: R18/64^2 float32" in capsys.readouterr().out


def test_dryrun_multichip_multiview_on_two_cpu_devices(capsys):
    """The V-view configuration (R18/64², V=3) over a (data 2) mesh, as
    JAX's dry run shards it: one sample's three views per replica, the
    loss trend, and a ragged evaluation of 3 samples padded by samples to
    4."""
    run = dryrun.dryrun_multichip(2, config="multiview", device="cpu")
    assert run["devices"] == ["cpu", "cpu"] and run["updates"] == 4
    losses = run["losses"]
    assert (losses[-2] + losses[-1]) / 2 < (losses[0] + losses[1]) / 2
    assert (run["eval_rows"], run["padded_to"]) == (3, 4)
    assert "dryrun_multichip(2) OK [multiview: R18/64^2 float32" in capsys.readouterr().out


@pytest.mark.parametrize("kwargs, match", [
    ({"n_steps": 3}, "n_steps must be >= 4"),
    ({"config": "bogus"}, "unknown dryrun config"),
    ({"devices": ["cpu"]}, "need 2 devices"),
])
def test_dryrun_refusals(kwargs, match):
    with pytest.raises(ValueError, match=match):
        dryrun.dryrun_multichip(2, device="cpu", **kwargs)


def test_dryrun_configs_are_jaxs():
    assert dryrun.DRYRUN_CONFIGS == {
        "r50-small": (64, 50, "float32", 1, 2),
        "flagship": (224, 50, "bfloat16", 1, 2),
        "reduced": (64, 18, "float32", 1, 2),
        "spatial": (64, 18, "float32", 2, 2),
        "multiview": (64, 18, "float32", 1, 3),
    }


def test_mesh_devices():
    assert dryrun.mesh_devices(3, "cpu") == [torch.device("cpu")] * 3


def test_entry_is_a_seeded_bf16_forward():
    """(fn, (params, data)) of the R50 x 3 eval forward at batch 8, 224x224:
    finite (8, 2) float32 gaze, the same from a second entry() (seeded), and
    the model's eval forward under bf16 autocast with its own weights."""
    fn, (params, data) = dryrun.entry(device="cpu")
    out = fn(params, data)
    assert out.shape == (8, 2) and out.dtype == torch.float32 and torch.isfinite(out).all()
    assert data["img_0"].shape == (8, 224, 224, 3) and data["rot_0"].shape == (8, 3, 3)
    fn2, (params2, data2) = dryrun.entry(device="cpu")
    assert all(torch.equal(params[k], params2[k]) for k in params)
    assert torch.equal(out, fn2(params2, data2))
    running = [v for k, v in params.items() if k.endswith("running_var")]
    assert running and not all(torch.equal(v, torch.ones_like(v)) for v in running)  # estimated, not the init
