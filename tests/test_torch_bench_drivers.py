"""The port's benchmark commands on the CPU at tiny settings: each main
prints its JAX counterpart's record keys (bench's ``vs_baseline`` and
``hbm_bw_util`` are the documented exceptions) with the device beside them,
the refusals raise as JAX's do, no command runs without a card unless asked
for the CPU, bench's FLOP count equals the one counted from the model's
modules, probe_int8's int8 chain is the integer chain bit for bit, the
static probe's patch is undone, and check_command_budgets fails a command
that overruns its budget."""

import functools
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

from rot_mvgaze_tpu_torch import (
    bench,
    bench_cold_path,
    bench_eval,
    bench_loader_scaling,
    bench_probes,
    bench_sweep,
    check_command_budgets,
    probe_int8,
    probe_int8_static,
)

CPU = {"name": "cpu", "power_limit": None}
TINY = {"BENCH_BATCH": "2", "BENCH_SIZE": "32", "BENCH_DEPTH": "18", "BENCH_ITERS": "1"}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def env(monkeypatch):
    """The BENCH_* settings of this process cleared, then set per test."""
    for k in list(os.environ):
        if k.startswith(("BENCH_", "SERVE_")):
            monkeypatch.delenv(k)

    def set_env(values):
        for k, v in values.items():
            monkeypatch.setenv(k, v)

    return set_env


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def _tiny_run(monkeypatch, module, settings=None, **kwargs):
    """``module.run`` with ``kwargs`` (and ``settings`` over its settings
    dict, where it takes one) set, so that ``main`` runs a tiny workload on
    the CPU; the commands have no option for that."""
    run = module.run
    if settings is None:
        monkeypatch.setattr(module, "run", functools.partial(run, **kwargs))
    else:
        monkeypatch.setattr(module, "run", lambda s, *a, **kw: run({**s, **settings}, *a, **{**kw, **kwargs}))


def test_bench_prints_the_record(env, capsys, monkeypatch):
    env(TINY)
    _tiny_run(monkeypatch, bench, steps=1)
    assert bench.main(["--device", "cpu"]) == 0
    (rec,) = _json_lines(capsys.readouterr().out)
    assert {"metric", "value", "unit"} <= set(rec)  # JAX's keys but vs_baseline
    assert rec["metric"] == "rotmv_r18_train_step_throughput" and rec["value"] > 0
    assert rec["config"] == {"backbone_depth": 18, "num_iter": 1, "image_size": 32}
    assert rec["device"] == CPU and rec["mfu"] is None and rec["value_by_cuda_events"] is None
    assert rec["flops_per_step"] > 0 and "vs_baseline" not in rec and "hbm_bw_util" not in rec


def test_bench_runs_the_v_view_step_over_a_data_mesh(env):
    """BENCH_NUM_VIEWS=3 over --device cpu,cpu: the V-view step on a (data
    2) mesh, each replica BENCH_BATCH frames of 3 views; the record counts
    V images per sample and adds n_chips and total_imgs_per_sec, as the
    stereo record over a mesh does."""
    env({**TINY, "BENCH_NUM_VIEWS": "3"})
    out = bench.run(bench.read_settings(), "cpu,cpu", steps=1)
    rec = out["record"]
    assert out["devices"] == ["cpu", "cpu"] and out["steps_run"] == bench.WARMUP + 1
    assert rec["metric"] == "rotmv_r18_mv3_train_step_throughput" and rec["value"] > 0
    assert rec["config"] == {"backbone_depth": 18, "num_iter": 1, "image_size": 32, "num_views": 3}
    assert rec["n_chips"] == 2 and rec["total_imgs_per_sec"] == pytest.approx(2 * rec["value"])
    assert rec["unit"].startswith("images/sec/card (3-view 32^2")


JAX_REFUSALS = [
    ({"BENCH_NUM_VIEWS": "1"}, "BENCH_NUM_VIEWS must be >= 2"),
    ({"BENCH_FREEZE_BN": "1", "BENCH_FUSE_VIEWS": "1"}, "silently inert: BENCH_FUSE_VIEWS"),
    ({"BENCH_FREEZE_BN": "1", "BENCH_PALLAS_BN": "1", "BENCH_BN_STAT_SUBSAMPLE": "2"},
     "silently inert: BENCH_PALLAS_BN, BENCH_BN_STAT_SUBSAMPLE"),
    ({"BENCH_NUM_VIEWS": "3", "BENCH_FUSE_VIEWS": "1"}, "stereo-only model options at num_views=3"),
]


@pytest.mark.parametrize("values, match", JAX_REFUSALS, ids=["views", "freeze_fuse", "freeze_bn_opts", "v3_stereo"])
def test_bench_refuses_as_jax_does(env, values, match):
    """Each refusal of the JAX benchmark exits the port's too, with its
    words, before any step runs."""
    env({**TINY, **values})
    with pytest.raises(SystemExit, match=match):
        bench.run(bench.read_settings(), "cpu")
    jax_bench = importlib.import_module("bench")
    with pytest.raises(SystemExit, match=match.split(":")[0]):
        jax_bench.main()


@pytest.mark.parametrize("values, match", [
    ({"BENCH_PALLAS_BN": "residual"}, "residual is refused"),
    ({"BENCH_PALLAS_BN": "2"}, "must be 0, 1 or residual"),
    ({"BENCH_COMPILER_OPTIONS": "{}"}, "no counterpart"),
    ({"BENCH_PEAK_TFLOPS": "197"}, "no counterpart"),
    ({"BENCH_PEAK_GBPS": "819"}, "no counterpart"),
])
def test_bench_refuses_what_the_port_has_not(env, values, match):
    env(values)
    with pytest.raises(SystemExit, match=match):
        bench.read_settings()


def test_bench_inert_pallas_options_and_defaults(env):
    env({"BENCH_PALLAS_FUSION": "1", "BENCH_PALLAS_BN": "1"})
    s = bench.read_settings()
    assert s["stereo_opts"] == {"use_pallas_fusion": True, "use_pallas_bn": True}
    assert (s["batch"], s["size"], s["depth"], s["num_iter"], s["num_views"]) == (128, 224, 50, 3, 2)


def _expected_flops(model, run):
    """FLOPs counted from the modules the step calls: every conv and linear,
    and each fuser's two layers (the custom op and an F.linear), forward
    2 * rows * fan-in * out, times 3 for forward and backward (a weight and
    an input gradient each), except the stem, whose input needs no gradient
    (times 2)."""
    from rot_mvgaze_tpu_torch.models.rot_mv import ImageFeatFuser

    total = [0]
    stem = model._feat_extractor[0].conv1

    def conv_hook(mod, args, out):
        fan_in = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
        fwd = 2 * out.numel() * fan_in
        total[0] += fwd * (2 if mod is stem else 3)

    def linear_hook(mod, args, out):
        total[0] += 3 * 2 * out.numel() * mod.in_features

    def fuser_hook(mod, args, out):
        rows = args[0].shape[0]
        for layer in (mod._fuser.blocks[0][0], mod._fuser.blocks[1][0]):
            total[0] += 3 * 2 * rows * layer.in_features * layer.out_features

    hooks = []
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            hooks.append(m.register_forward_hook(conv_hook))
        elif isinstance(m, ImageFeatFuser):
            hooks.append(m.register_forward_hook(fuser_hook))
        elif isinstance(m, nn.Linear):
            hooks.append(m.register_forward_hook(linear_hook))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def test_flops_per_step_match_the_modules():
    """bench's FlopCounterMode count over one step of R18 x 1 at 32x32 (2
    pairs, augmentation on) within 1% of the count from the modules' shapes
    (the rest: the 3x3 rotations and the fuser backward's small products)."""
    from rot_mvgaze_tpu_torch.train import make_optimizer
    from rot_mvgaze_tpu_torch.utils.drivers import Workload, make_host_batch, to_device

    torch.manual_seed(0)
    wl = Workload(backbone_depth=18, num_iter=1)
    data = to_device(make_host_batch(np.random.default_rng(0), 2, 32), "cpu")
    step = wl.make_train_step(make_optimizer(wl.model.parameters()), image_size=32)
    gen = torch.Generator().manual_seed(0)
    _, counted = bench.count_flops(lambda: step(data, gen, step=0))
    expected = _expected_flops(wl.model, lambda: step(data, gen, step=1))
    print(f"flops per step: counted {counted:,}, from the modules {expected:,}")
    assert abs(counted - expected) <= 0.01 * expected
    # without the custom op's formula the fuser's forward counts 0, and the total falls short
    from torch.utils.flop_counter import FlopCounterMode

    bare = FlopCounterMode(display=False)
    with bare:
        step(data, gen, step=2)
    assert bare.get_total_flops() < 0.99 * expected


def test_bench_eval_prints_the_record(env, capsys, monkeypatch):
    env({"BENCH_BATCH": "2", "SERVE_BATCH": "1"})
    _tiny_run(monkeypatch, bench_eval, {"size": 32, "depth": 18}, n_steps=1, n_latency=2)
    assert bench_eval.main(["--device", "cpu"]) == 0
    (rec,) = _json_lines(capsys.readouterr().out)
    assert {"eval_imgs_per_sec", "serving_p50_ms", "serving_p99_ms", "serving_batch", "int8", "num_views"} <= set(rec)
    assert rec["eval_imgs_per_sec"] > 0 and rec["serving_batch"] == 1 and rec["int8"] is False
    assert rec["device"] == CPU


@pytest.mark.parametrize("values, match", [({"BENCH_INT8": "yes"}, "BENCH_INT8 must be 0, 1, or static"),
                                           ({"BENCH_NUM_VIEWS": "1"}, "BENCH_NUM_VIEWS must be >= 2")])
def test_bench_eval_refusals(env, values, match):
    env(values)
    with pytest.raises(SystemExit, match=match):
        bench_eval.read_settings()


def test_bench_eval_int8_settings(env):
    for raw, want in (("0", False), ("1", True), ("static", "static")):
        env({"BENCH_INT8": raw})
        assert bench_eval.read_settings()["int8"] == want
    env({"BENCH_SIZE": "32", "BENCH_DEPTH": "18"})  # bench's settings; JAX's bench_eval reads neither
    assert (bench_eval.read_settings()["size"], bench_eval.read_settings()["depth"]) == (224, 50)


def test_bench_sweep_prints_a_record_per_variant(capsys, monkeypatch):
    _tiny_run(monkeypatch, bench_sweep, depth=18, size=32, num_iter=1)
    argv = ["full", "bf16aug", "fwdonly", "--batch", "2", "--steps", "1", "--device", "cpu"]
    assert bench_sweep.main(argv) == 0
    recs = _json_lines(capsys.readouterr().out)
    assert [r["variant"] for r in recs] == ["full", "bf16aug", "fwdonly"]
    for r in recs:
        assert set(r) == {"variant", "batch", "ms_per_step", "imgs_per_sec", "device"}
        assert r["ms_per_step"] > 0 and r["device"] == CPU and r["batch"] == 2
    with pytest.raises(SystemExit, match="unknown variant"):
        bench_sweep.run(["bogus"], device="cpu")


def test_bench_probes_print_a_record_per_probe(capsys, monkeypatch):
    _tiny_run(monkeypatch, bench_probes, size=32, depth=18)
    argv = ["conv1", "conv1_s2d", "bb_train", "bb_eval", "--batch", "2", "--steps", "1", "--device", "cpu"]
    assert bench_probes.main(argv) == 0
    recs = _json_lines(capsys.readouterr().out)
    assert [r["probe"] for r in recs] == ["conv1", "conv1_s2d", "bb_train", "bb_eval"]
    for r in recs:
        assert set(r) == {"probe", "batch_imgs", "ms", "imgs_per_sec", "device"} and r["ms"] > 0
    with pytest.raises(SystemExit, match="unknown probe"):
        bench_probes.run(["bogus"], device="cpu")


def test_probe_int8_prints_a_record_per_case(capsys, monkeypatch):
    """probe_int8's cases (each conv at one image, the product at 32 rows),
    one record per case, in order."""
    convs = [(name, (1,) + x[1:], w) for name, x, w in probe_int8.CONV_CASES]
    dots = [(name, (32, a[1]), b) for name, a, b in probe_int8.DOT_CASES]
    monkeypatch.setattr(probe_int8, "CONV_CASES", convs)
    monkeypatch.setattr(probe_int8, "DOT_CASES", dots)
    _tiny_run(monkeypatch, probe_int8, iters=1, reps=1)
    assert probe_int8.main(["--device", "cpu"]) == 0
    recs = _json_lines(capsys.readouterr().out)
    assert [r["case"] for r in recs] == [c[0] for c in convs + dots]
    for r in recs:
        assert r["bf16_ms_per_iter"] > 0 and r["int8_ms_per_iter"] > 0 and r["speedup"] > 0
        assert r["bf16_share_of_peak"] is None and r["device"] == CPU


def _int_chain_reference(x, w, n):
    """The int8 conv chain in numpy int64: 3x3 'same' convs of NCHW x by
    (O, C, 3, 3) w, each sum shifted right by 8 and clipped to [-127, 127]."""
    x = x.astype(np.int64)
    w = w.astype(np.int64)
    for _ in range(n):
        b, c, h, wd = x.shape
        xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
        y = np.zeros((b, w.shape[0], h, wd), np.int64)
        for i in range(3):
            for j in range(3):
                y += np.einsum("bchw,oc->bohw", xp[:, :, i:i + h, j:j + wd], w[:, :, i, j])
        x = np.clip(y >> 8, -127, 127)
    return x.astype(np.int8)


def test_probe_int8_chains_are_the_integer_chains():
    """The int8 conv and product chains bit for bit their numpy int64
    reference (full-range int8 operands, 3 iterations)."""
    rng = np.random.default_rng(2)
    x8, w8, _, _ = probe_int8.conv_operands(rng, (2, 6, 6, 16), (3, 3, 16, 16), "cpu")
    got = probe_int8.int8_conv_chain(x8, w8, 3).numpy()
    assert np.array_equal(got, _int_chain_reference(x8.numpy(), w8.numpy(), 3))
    a = rng.integers(-127, 127, (5, 24), dtype=np.int8)
    b = rng.integers(-127, 127, (24, 24), dtype=np.int8)
    want = a.astype(np.int64)
    for _ in range(3):
        want = np.clip((want @ b.astype(np.int64)) >> 8, -127, 127)
    got = probe_int8.int8_dot_chain(torch.from_numpy(a), torch.from_numpy(b), 3).numpy()
    assert np.array_equal(got, want.astype(np.int8))


def test_probe_int8_static_patch_is_undone(env, capsys, monkeypatch):
    from rot_mvgaze_tpu_torch.ops import quant

    orig = quant.quantize_symmetric
    x = torch.randn(2, 3, 4, 4)
    with probe_int8_static.fixed_activation_scale():
        q, s = quant.quantize_symmetric(x)
        assert float(s) == pytest.approx(8 / 127) and q.dtype == torch.int8
        w8, sw = quant.quantize_symmetric(x, reduce_dims=(1, 2, 3))  # weights: per channel, as before
        assert torch.equal(sw, orig(x, reduce_dims=(1, 2, 3))[1])
    assert quant.quantize_symmetric is orig
    with pytest.raises(RuntimeError), probe_int8_static.fixed_activation_scale():
        raise RuntimeError("inside the probe")
    assert quant.quantize_symmetric is orig
    env({"BENCH_BATCH": "2"})
    _tiny_run(monkeypatch, probe_int8_static, steps=1, size=32, depth=18)
    assert probe_int8_static.main(["--device", "cpu"]) == 0
    (rec,) = _json_lines(capsys.readouterr().out)
    assert rec["static_scale_int8_eval_imgs_per_sec"] > 0 and rec["batch"] == 2 and rec["device"] == CPU
    assert quant.quantize_symmetric is orig


def test_loader_scaling_prints_points_and_table(tmp_path, capsys):
    argv = ["--threads", "1,2", "--samples", "40", "--image-size", "16", "--batch", "8", "--iter-samples", "40",
            "--dir", str(tmp_path), "--out", str(tmp_path / "out.json"), "--device", "cpu"]
    assert bench_loader_scaling.main(argv) == 0
    out = capsys.readouterr().out
    recs = _json_lines(out)
    assert [r["n_threads"] for r in recs] == [1, 2]
    keys = {"n_threads", "stereo_samples_per_sec", "images_per_sec", "gbytes_per_sec", "per_thread_rate",
            "timed_samples", "wall_s"}
    assert all(keys | {"device"} == set(r) and r["timed_samples"] >= 40 for r in recs)
    assert "| threads | stereo samples/s |" in out
    assert json.loads((tmp_path / "out.json").read_text())["results"] == recs


def test_cold_path_record(tmp_path, capsys, monkeypatch):
    argv = ["--samples", "36", "--files", "2", "--image-size", "16", "--batch", "8", "--dir", str(tmp_path),
            "--device", "cpu"]
    assert bench_cold_path.main(argv) == 0
    (rec,) = _json_lines(capsys.readouterr().out)
    assert rec["conversion"]["total_rows"] == 72 and rec["conversion"]["rows_per_sec"] > 0
    assert rec["epoch_samples"] == 72 and rec["cold_epoch_samples_per_sec"] > 0 and rec["device"] == CPU
    assert rec["page_cache_evicted"] is True
    # a machine without h5py: no conversion, and the reason; the packs from the same rows
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert bench_cold_path.main(argv) == 0
    (rec,) = _json_lines(capsys.readouterr().out)
    assert rec["conversion"] is None and "h5py" in rec["conversion_reason"] and rec["epoch_samples"] == 72
    monkeypatch.setattr(bench_cold_path, "fs_type", lambda path: "tmpfs")
    with pytest.raises(SystemExit, match="tmpfs"):
        bench_cold_path.main(argv)


COMMANDS = [
    ("bench", []), ("bench_eval", []), ("bench_sweep", ["augonly"]), ("bench_probes", ["conv1"]),
    ("probe_int8", []), ("probe_int8_static", []), ("bench_loader_scaling", []), ("bench_cold_path", []),
    ("dryrun", []), ("check_command_budgets", []),
]


@pytest.mark.parametrize("name, argv", COMMANDS, ids=[c[0] for c in COMMANDS])
def test_commands_run_on_the_card_by_default(env, name, argv, monkeypatch):
    """Without --device each command asks for the card, and raises where
    there is none (never a fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    module = importlib.import_module(f"rot_mvgaze_tpu_torch.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)


def test_check_command_budgets_fails_an_overrun():
    """A planted command that sleeps 3 s against a 1 s budget fails the
    check; one inside its budget passes, one that exits non-zero fails."""
    def ok(check):
        return check_command_budgets.run_checks([check], "cpu")["ok"]

    slow = ("planted", 1.0, {}, [sys.executable, "-c", "import time; time.sleep(3)"], None)
    assert not ok(slow)
    quick = ("planted", 60.0, {}, [sys.executable, "-c", "print('done')"], None)
    assert ok(quick)
    failing = ("planted", 60.0, {}, [sys.executable, "-c", "raise SystemExit(3)"], None)
    assert not ok(failing)
    summary = check_command_budgets.run_checks([quick, slow], "cpu")
    assert [c["ok"] for c in summary["checks"]] == [True, False] and summary["device"] == CPU


def test_check_command_budgets_contracts():
    names = [c[0] for c in check_command_budgets.checks("cpu")]
    assert names == ["bench", "entry", "dryrun"]
    good = json.dumps({"metric": "m", "value": 1.0, "unit": "u", "device": CPU, "flops_per_step": 1})
    assert check_command_budgets.validate_bench(good) is None
    assert "missing keys" in check_command_budgets.validate_bench(json.dumps({"metric": "m"}))
    assert check_command_budgets.validate_bench("no json") == "no JSON line in bench output"
    assert check_command_budgets.validate_entry("entry OK (8, 2) torch.float32") is None
    assert check_command_budgets.validate_dryrun("dryrun_multichip(8) OK [reduced") is None
    assert check_command_budgets.validate_dryrun("") is not None


def test_check_command_budgets_main_exit_codes(monkeypatch, capsys):
    """main prints the summary and exits 1 when a check fails, 0 when all
    pass; --only with no such check exits 2."""
    slow = ("bench", 1.0, {}, [sys.executable, "-c", "import time; time.sleep(3)"], None)
    quick = ("entry", 60.0, {}, [sys.executable, "-c", "print('done')"], None)
    monkeypatch.setattr(check_command_budgets, "checks", lambda device: [slow, quick])
    assert check_command_budgets.main(["--device", "cpu"]) == 1
    summary = _json_lines(capsys.readouterr().out)[-1]
    assert [c["name"] for c in summary["checks"]] == ["bench", "entry"] and summary["ok"] is False
    assert check_command_budgets.main(["--device", "cpu", "--only", "entry"]) == 0
    assert check_command_budgets.main(["--device", "cpu", "--only", "bogus"]) == 2
