"""The port's serving tier (rot_mvgaze_tpu_torch.serving, .serve) on the CPU:
the port's GazePredictor against the JAX package's on one reference-format
.pth.tar made from JAX variables, the request coalescer, validation, and one
HTTP round trip."""

import http.client
import io
import json
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rot_mvgaze_tpu.compat import flax_to_torch_state_dict
from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu.serving import GazePredictor as JaxGazePredictor
from rot_mvgaze_tpu.utils.padding import iter_padded_microbatches as jax_iter_padded_microbatches
from rot_mvgaze_tpu_torch import serving
from rot_mvgaze_tpu_torch.serve import build_handler
from rot_mvgaze_tpu_torch.utils.padding import iter_padded_microbatches, pad_rows

CFG = {"backbone_depth": 18, "num_iter": 2}
SIZE = 64


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    """Reference-format .pth.tar of JAX-initialised R18 variables, with
    non-trivial BN running statistics."""
    s = jnp.zeros((1, SIZE, SIZE, 3))
    eye = jnp.broadcast_to(jnp.eye(3), (1, 3, 3))
    variables = JaxFeatRotationSymm(**CFG).init(
        jax.random.PRNGKey(0), {"img_0": s, "img_1": s, "rot_0": eye, "rot_1": eye}
    )
    sd = flax_to_torch_state_dict(jax.tree.map(np.asarray, variables), strict_compatible=True, **CFG)
    rng = np.random.default_rng(1)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = rng.normal(0.0, 0.1, sd[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, sd[k].shape).astype(np.float32)
    path = str(tmp_path_factory.mktemp("ckpt") / "model.pth.tar")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return path


@pytest.fixture(scope="module")
def predictor(ckpt_path):
    return serving.GazePredictor(
        ckpt_path, **CFG, micro_batch=4, image_size=SIZE, dtype=torch.float32, device="cpu"
    )


def _request(n, seed=0, size=SIZE):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
        rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
        rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32),
        rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32),
    )


def test_predictor_matches_jax_predictor(ckpt_path, predictor):
    """N=6 over micro-batch 4: the last micro-batch is padded on both sides."""
    jax_pred = JaxGazePredictor(
        ckpt_path, **CFG, micro_batch=4, image_size=SIZE, dtype=jnp.float32
    )
    req = _request(6)
    before = predictor.micro_batches_run
    got = predictor.predict(*req)
    assert predictor.micro_batches_run == before + 2
    assert got.shape == (6, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_pred.predict(*req), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("n, micro_batch", [(5, 4), (4, 4), (1, 3), (9, 2)])
def test_padded_microbatches_equal_jax_packages(n, micro_batch):
    """Same slices, same last-row padding, same real-row counts."""
    x = np.arange(n * 3).reshape(n, 3)
    got = list(iter_padded_microbatches((x, x[:, 0]), micro_batch))
    want = list(jax_iter_padded_microbatches((x, x[:, 0]), micro_batch))
    assert [rows for _, rows in got] == [rows for _, rows in want]
    for (g, _), (w, _) in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[-1][0][0][-1], x[-1])


def test_pad_rows_refuses_empty():
    with pytest.raises(ValueError):
        pad_rows(np.zeros((0, 2)), 4)


def test_empty_request(predictor):
    assert predictor.predict(*_request(0)).shape == (0, 2)


def test_batching_predictor_concurrent_callers_match_direct(predictor):
    batching = serving.BatchingPredictor(predictor, max_delay_ms=20.0)
    sizes = [1, 3, 4, 2, 5, 1]
    requests = [_request(n, seed=10 + i) for i, n in enumerate(sizes)]
    results = [None] * len(requests)

    def call(i):
        results[i] = batching.predict(*requests[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(requests))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        batching.close()
    for req, got in zip(requests, results):
        np.testing.assert_allclose(got, predictor.predict(*req), atol=1e-5, rtol=1e-5)


def test_batching_predictor_propagates_errors_to_every_caller(predictor):
    class Failing:
        request_fields = predictor.request_fields
        micro_batch = 4
        image_size = SIZE
        validate_request = predictor.validate_request

        def predict(self, *args):
            raise RuntimeError("device lost")

    batching = serving.BatchingPredictor(Failing(), max_delay_ms=20.0)
    errors = []

    def call():
        try:
            batching.predict(*_request(1))
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=call) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        batching.close()
    assert errors == ["device lost"] * 3


@pytest.mark.parametrize(
    "mutate",
    [
        lambda r: (r[0].astype(np.float32),) + r[1:],
        lambda r: (r[0], r[1][:1]) + r[2:],
        lambda r: r[:2] + (r[2][:, :1], r[3]),
        lambda r: (r[0][..., :2],) + r[1:],
        lambda r: _request(2, size=SIZE // 2),
    ],
    ids=["float-pixels", "batch-mismatch", "pose-shape", "two-channels", "wrong-size"],
)
def test_batching_predictor_rejects_malformed_requests(predictor, mutate):
    batching = serving.BatchingPredictor(predictor)
    try:
        with pytest.raises(ValueError):
            batching.predict(*mutate(_request(2)))
    finally:
        batching.close()


def test_default_device_without_card_raises(ckpt_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.GazePredictor(ckpt_path, **CFG, image_size=SIZE)


@pytest.fixture
def server(predictor):
    batching = serving.BatchingPredictor(predictor)
    stats = {"requests": 0, "samples": 0, "time": 0.0}
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0), build_handler(batching, stats, max_body_bytes=8 * 1024 * 1024)
    )
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address[1], stats
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        batching.close()


def _call(port, method, path, body=b"", length=None):
    """(status, body) of one request; ``length`` overrides Content-Length."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.putrequest(method, path)
        conn.putheader("Content-Length", str(len(body) if length is None else length))
        conn.endheaders(body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_http_predict_round_trip(server, predictor):
    port, stats = server
    req = _request(3, seed=5)
    status, body = _call(port, "POST", "/predict", _npz(**dict(zip(predictor.request_fields, req))))
    assert status == 200
    np.testing.assert_allclose(
        np.load(io.BytesIO(body))["pred_gaze"], predictor.predict(*req), atol=1e-5, rtol=1e-5
    )
    status, body = _call(port, "GET", "/healthz")
    health = json.loads(body)
    assert status == 200 and health["status"] == "ok" and health["requests"] == 1 and health["samples"] == 3


def test_http_client_errors(server, predictor):
    port, _ = server
    req = dict(zip(predictor.request_fields, _request(2)))
    missing = {k: v for k, v in req.items() if k != "head_pose_1"}
    assert _call(port, "POST", "/predict", _npz(**missing))[0] == 400
    bad = dict(req, img_0=req["img_0"].astype(np.float32))
    assert _call(port, "POST", "/predict", _npz(**bad))[0] == 400
    # refused on the declared length, before any body is read
    assert _call(port, "POST", "/predict", length=9 * 1024 * 1024)[0] == 413
    assert _call(port, "POST", "/nope")[0] == 404
    assert _call(port, "GET", "/nope")[0] == 404
