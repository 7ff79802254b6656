"""The port's four-protocol table (rot_mvgaze_tpu_torch.reference_parity)
on the CPU: its run_our_eval against scripts/reference_parity.py's on the
same archives and checkpoint (a seeded port model saved as a reference
.pth.tar), R18 with 2 fusion iterations at 32x32, batch 9, two synthetic
subjects x 3 frames x 18 cameras per dataset; the HDF5 and packed routes
bit for bit, and the rehearsal's packs byte for byte the packs of its
archives; the command line's surface and error exits; the rehearsal end to
end."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from rot_mvgaze_tpu_torch import reference_parity as port_rp
from rot_mvgaze_tpu_torch.data.packed import pack_hdf5
from rot_mvgaze_tpu_torch.models import FeatRotationSymm

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
sys.path.insert(0, SCRIPTS)

import reference_parity as jax_rp  # noqa: E402

MODEL_CFG = dict(backbone_depth=18, num_iter=2, share_weights=False, encode_rotmat=False,
                 share_feature=False, ignore_rotmat=False)
SIZE, BATCH, SEED = 32, 9, 0


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; two intra-op threads
    each keep torch from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The rehearsal's corpora (HDF5 archives for JAX and the HDF5 route,
    and their packs) and a seeded port model's state dict as a reference
    .pth.tar."""
    work = tmp_path_factory.mktemp("parity")
    roots, subjects = port_rp.rehearsal_corpora(str(work), SIZE, archives=True)
    torch.manual_seed(0)
    ckpt = str(work / "seeded.pth.tar")
    torch.save(FeatRotationSymm(**MODEL_CFG).state_dict(), ckpt)
    return work, roots, subjects, ckpt


@pytest.fixture(scope="module")
def jax_table(assets):
    """scripts/reference_parity.py's run_our_eval for every protocol. Each
    call builds a JAX Trainer, which jits a fresh eval step; one step
    function per (model, size) here lets the four share one compile (every
    eval batch pads to 9 rows)."""
    import rot_mvgaze_tpu.train.steps as jax_steps

    work, roots, subjects, ckpt = assets
    make = jax_steps.make_eval_step
    steps = {}

    def shared(model, image_size=224, image_sharding=None):
        key = (model, image_size, image_sharding)
        if key not in steps:
            steps[key] = make(model, image_size, image_sharding)
        return steps[key]

    jax_steps.make_eval_step = shared
    try:
        return {p: jax_rp.run_our_eval(p, ckpt, roots, subjects, MODEL_CFG, SIZE, BATCH, SEED,
                                       str(work / f"jax_{p}"))
                for p in jax_rp.PROTOCOLS}
    finally:
        jax_steps.make_eval_step = make


def _port_table(assets, native_loader):
    work, roots, subjects, ckpt = assets
    return {p: port_rp.run_our_eval(p, ckpt, roots, subjects, MODEL_CFG, SIZE, BATCH, SEED,
                                    str(work / f"port_{native_loader}_{p}"), device="cpu",
                                    native_loader=native_loader)
            for p in port_rp.PROTOCOLS}


@pytest.fixture(scope="module")
def port_tables(assets):
    return {"hdf5": _port_table(assets, native_loader=False), "packed": _port_table(assets, native_loader=True)}


@pytest.mark.parametrize("protocol", port_rp.PROTOCOLS)
def test_table_matches_the_jax_script(jax_table, port_tables, protocol):
    """Within 1e-3 deg per protocol (measured: about 2e-6, printed)."""
    got, want = port_tables["hdf5"][protocol], jax_table[protocol]
    print(f"{protocol}: port {got:.8f} deg, JAX {want:.8f} deg, delta {abs(got - want):.3e}")
    assert np.isfinite(got) and abs(got - want) <= 1e-3, (got, want)


def test_hdf5_and_packed_routes_agree_bit_for_bit(assets, port_tables):
    work, roots, subjects, _ = assets
    _, test_loader, route = port_rp.protocol_loaders("xgaze2mpiinv_known", roots, subjects, BATCH, SEED)
    assert route == "packed" and test_loader.dataset.pool is not None
    assert port_tables["packed"] == port_tables["hdf5"]
    assert len(set(port_tables["hdf5"].values())) == 4


@pytest.mark.parametrize("dataset, color", [("xgaze", "bgr"), ("mpiinv", "rgb")])
def test_rehearsal_packs_are_the_packs_of_its_archives(assets, tmp_path, dataset, color):
    """rehearsal_corpora's packs (written from the rows, no archive read)
    equal byte for byte what pack_hdf5 makes of its archives."""
    _, roots, subjects, _ = assets
    for name in subjects[dataset]:
        want = pack_hdf5(os.path.join(roots[dataset], name), str(tmp_path / name), dataset, color)
        with open(want, "rb") as f, open(os.path.join(roots[dataset], "_rmgpack", dataset,
                                                      name + ".rmgpack"), "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("protocol", port_rp.PROTOCOLS)
def test_protocol_spec_matches_the_jax_script(protocol):
    assert port_rp.protocol_spec(protocol) == jax_rp.protocol_spec(protocol)


def test_protocols_and_unknown_names():
    assert port_rp.PROTOCOLS == jax_rp.PROTOCOLS
    for bad in ("xgaze_known", "xgaze2mpiinv_seen"):
        with pytest.raises(KeyError):
            port_rp.protocol_spec(bad)


@pytest.mark.parametrize("dataset, n", [("xgaze", 80), ("mpiinv", 15)])
def test_subjects_load_as_the_jax_script_loads_them(dataset, n):
    subjects = port_rp.load_subjects(dataset)
    assert subjects == jax_rp.load_subjects(dataset)
    assert len(subjects) == n and all(s.endswith(".h5") for s in subjects)


@pytest.mark.parametrize("case", ["no_data_dirs", "unknown_protocol", "missing_ckpt", "no_reference",
                                  "no_reference_dir"])
def test_error_exits(tmp_path, capsys, case):
    """Exit 2 before any data is read, with the JAX script's messages; a
    --run_reference without the reference's checkout names the directory,
    and one without --reference_dir asks for it."""
    absent = str(tmp_path / "reference")
    argv = {
        "no_data_dirs": ["--ckpt_dir", str(tmp_path)],
        "unknown_protocol": ["--xgaze_dir", str(tmp_path), "--mpiinv_dir", str(tmp_path), "--ckpt", "bogus=/x"],
        "missing_ckpt": ["--xgaze_dir", str(tmp_path), "--mpiinv_dir", str(tmp_path), "--ckpt_dir", str(tmp_path)],
        "no_reference": ["--rehearse", "--run_reference", "--reference_dir", absent],
        "no_reference_dir": ["--rehearse", "--run_reference"],
    }[case]
    with pytest.raises(SystemExit) as e:
        port_rp.main([*argv, "--device", "cpu"])
    assert e.value.code == 2
    want = {"no_data_dirs": "--xgaze_dir", "unknown_protocol": "unknown protocol",
            "missing_ckpt": "no checkpoint for", "no_reference": absent,
            "no_reference_dir": "--run_reference needs --reference_dir"}[case]
    assert want in capsys.readouterr().err


def test_rehearsal_end_to_end(tmp_path, capsys):
    """--rehearse --device cpu without the reference: the port trains the
    checkpoint, all four protocols run, the reference column stays empty,
    exit 0, and --out holds the JSON record."""
    out = str(tmp_path / "table.json")
    rc = port_rp.main(["--rehearse", "--device", "cpu", "--out", out])
    assert rc == 0
    with open(out) as f:
        record = json.load(f)
    assert record["budget_deg"] == 0.1 and record["rehearsal"] is True and record["device"] == "cpu"
    assert [r["protocol"] for r in record["rows"]] == list(port_rp.PROTOCOLS)
    for r in record["rows"]:
        assert r["reference_deg"] is None and r["delta_deg"] is None
        assert np.isfinite(r["ours_deg"]) and 0.0 < r["ours_deg"] < 180.0
    table = capsys.readouterr().out
    assert "| Protocol | reference (deg) | ours (deg) | delta (deg) |" in table
    for p in port_rp.PROTOCOLS:
        row = next(line for line in table.splitlines() if line.startswith(f"| {p} |"))
        assert row.startswith(f"| {p} | — | ") and row.endswith(" | — |"), row
