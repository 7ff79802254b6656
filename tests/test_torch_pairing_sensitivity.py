"""The port's pairing-sensitivity experiment (rot_mvgaze_tpu_torch.
pairing_sensitivity) on the CPU against the JAX package: pairing_errors
over one JAX model's converted weights against JAX's evaluate_gaze over the
same weights, for pairing seeds 0-2 and the reference pairing (R18, 2
fusion iterations, 32x32, batch 9, two synthetic subjects x 3 frames x 18
cameras); the command line end to end at a tiny size."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.data import BatchLoader as JaxBatchLoader
from rot_mvgaze_tpu.data import GazeDataset as JaxGazeDataset
from rot_mvgaze_tpu.evaluate import evaluate_gaze as jax_evaluate_gaze
from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu_torch import pairing_sensitivity
from rot_mvgaze_tpu_torch.compat import state_dict_from_jax
from rot_mvgaze_tpu_torch.data import write_synthetic_corpus, write_synthetic_dataset
from rot_mvgaze_tpu_torch.models import FeatRotationSymm

SIZE, BATCH = 32, 9


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; two intra-op threads
    each keep torch from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


CFG = {"backbone_depth": 18, "num_iter": 2}


@pytest.fixture(scope="module")
def variables():
    """JAX variables of FeatRotationSymm(**CFG) at SIZE, as numpy."""
    data = {"img_0": jnp.zeros((2, SIZE, SIZE, 3)), "img_1": jnp.zeros((2, SIZE, SIZE, 3)),
            "rot_0": jnp.broadcast_to(jnp.eye(3), (2, 3, 3)), "rot_1": jnp.broadcast_to(jnp.eye(3), (2, 3, 3))}
    return jax.tree.map(np.asarray, jax.jit(JaxFeatRotationSymm(**CFG).init)(jax.random.PRNGKey(0), data))


def _port_model(variables):
    model = FeatRotationSymm(**CFG)
    model.load_state_dict(state_dict_from_jax(variables, **CFG), strict=True)
    return model


@pytest.fixture(scope="module")
def pairing_corpus(tmp_path_factory):
    """The same two subjects as HDF5 archives (for JAX) and, in another
    directory, as packs only (the experiment's own corpus route)."""
    root = tmp_path_factory.mktemp("pairing")
    names = write_synthetic_dataset(str(root / "h5"), ["s00.h5", "s01.h5"], n_frames=3, image_size=SIZE)
    write_synthetic_corpus(str(root / "packs"), names, n_frames=3, image_size=SIZE)
    return str(root / "h5"), str(root / "packs"), names


def test_pairing_errors_match_jax_evaluate_gaze(pairing_corpus, variables):
    """Per-seed and reference-pairing errors within 1e-3 deg of JAX's
    (measured: a few 1e-6, printed), the same rows for every pairing."""
    root, packs, subjects = pairing_corpus
    got_seeds, got_ref = pairing_sensitivity.pairing_errors(
        _port_model(variables).eval(), packs, subjects, range(3), SIZE, BATCH)
    model = JaxFeatRotationSymm(**CFG)
    want = {}
    for s in ("reference", 0, 1, 2):
        kw = {"pairing": "reference", "seed": 0} if s == "reference" else {"pairing": "rng", "seed": s}
        ds = JaxGazeDataset("xgaze", root, "bgr", subjects, camera_tag="all", **kw)
        want[s] = jax_evaluate_gaze(model, variables, JaxBatchLoader(ds, batch_size=BATCH), image_size=SIZE)
        ds.close()
    assert sorted(got_seeds) == [0, 1, 2]
    for s in (0, 1, 2):
        print(f"seed {s}: port {got_seeds[s]:.8f} deg, JAX {want[s]:.8f} deg")
        assert abs(got_seeds[s] - want[s]) <= 1e-3, (s, got_seeds[s], want[s])
    print(f"reference pairing: port {got_ref:.8f} deg, JAX {want['reference']:.8f} deg")
    assert abs(got_ref - want["reference"]) <= 1e-3
    assert len({round(v, 6) for v in got_seeds.values()}) == 3  # the partners really changed


def test_pairing_sensitivity_command_line(tmp_path, capsys):
    out = str(tmp_path / "pairing.json")
    rc = pairing_sensitivity.main(["--out", out, "--seeds", "2", "--epochs", "1", "--image_size", "32",
                                   "--n_frames", "1", "--batch_size", "9", "--device", "cpu"])
    assert rc == 0
    with open(out) as f:
        record = json.load(f)
    errs = np.array(list(record["per_seed_mean_error_deg"].values()))
    assert list(record["per_seed_mean_error_deg"]) == ["0", "1"]
    assert record["setup"] == {"backbone": 18, "image_size": 32, "n_samples": 36, "train_epochs": 1,
                               "n_pairing_seeds": 2, "device": "cpu"}
    assert record["spread_deg"] == pytest.approx(errs.max() - errs.min())
    assert record["mean_deg"] == pytest.approx(errs.mean()) and record["std_deg"] == pytest.approx(errs.std())
    assert np.isfinite(record["reference_pairing_mean_error_deg"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-2])["spread_deg"] == record["spread_deg"]
