"""The port's pretrained-weights download (rot_mvgaze_tpu_torch.compat.download)
against the JAX package's (rot_mvgaze_tpu.compat.download), with
``urllib.request.urlopen`` patched: no test here opens a connection.

- every case of tests/test_download.py against the port: the sha256 prefix
  of every torchvision name, download-verify-cache, a checksum mismatch
  installing nothing, a corrupt cached file fetched again, the zero-egress
  and the HTTP-error messages, a transfer dropped midway, an unknown
  backbone, and ``--pretrained_backbone``'s resolution;
- across the packages: the same default cache; with one fake payload both
  write the same path and bytes; a file that one fetched the other reuses
  without fetching;
- the command line: ``--pretrained_backbone auto`` downloads a
  torchvision-keyed R18 state dict into the cache and loads it into the
  backbone (``--epochs 0``: the first evaluation, then the export).
"""

import glob
import hashlib
import http.client
import io
import os
import urllib.error
import urllib.request

import pytest
import torch

from rot_mvgaze_tpu.compat import download as jax_download
from rot_mvgaze_tpu.models.resnet import MODEL_URLS as JAX_MODEL_URLS
from rot_mvgaze_tpu_torch.cli import main as cli
from rot_mvgaze_tpu_torch.compat import download, pretrained
from rot_mvgaze_tpu_torch.compat.pretrained import MODEL_URLS, resolve_pretrained
from rot_mvgaze_tpu_torch.data import write_synthetic_dataset
from rot_mvgaze_tpu_torch.models import BACKBONES
from rot_mvgaze_tpu_torch.utils.config import load_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Response(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def serving(payload, calls=None):
    """A fake ``urlopen`` answering every address with ``payload``."""

    def urlopen(url, timeout=60):
        if calls is not None:
            calls.append((url, timeout))
        return _Response(payload)

    return urlopen


def refuse(*args, **kwargs):
    pytest.fail("network used despite a valid cache")


def fake_url(payload, arch="resnet18"):
    return f"https://example.com/models/{arch}-{hashlib.sha256(payload).hexdigest()[:8]}.pth"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_sockets(monkeypatch):
    """Whatever a test patches, no connection is opened."""
    import socket

    def no_network(*args, **kwargs):
        raise AssertionError("a network connection was attempted")

    monkeypatch.setattr(socket, "create_connection", no_network)
    monkeypatch.setattr(socket.socket, "connect", no_network)


# ------------------------------------------------------------ tests/test_download.py, against the port


def test_every_url_has_a_sha_prefix():
    assert MODEL_URLS == JAX_MODEL_URLS and download.MODEL_URLS is MODEL_URLS  # one table
    for name, url in MODEL_URLS.items():
        prefix = download.expected_sha_prefix(url)
        assert len(prefix) == 8 and all(c in "0123456789abcdef" for c in prefix), (name, prefix)
        assert prefix == jax_download._expected_sha_prefix(url)


def test_download_verifies_and_caches(tmp_path, monkeypatch):
    payload = b"pretend-weights"
    monkeypatch.setitem(MODEL_URLS, "resnet18", fake_url(payload))
    calls = []
    monkeypatch.setattr(urllib.request, "urlopen", serving(payload, calls))
    dest = download.download_pretrained(18, cache_dir=str(tmp_path), progress=False)
    assert open(dest, "rb").read() == payload and calls == [(MODEL_URLS["resnet18"], 60)]
    assert os.listdir(tmp_path) == [os.path.basename(dest)]  # no temporary file left
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    assert download.download_pretrained(18, cache_dir=str(tmp_path), progress=False) == dest


def test_checksum_mismatch_rejected(tmp_path, monkeypatch):
    monkeypatch.setitem(MODEL_URLS, "resnet18", "https://example.com/models/resnet18-00000000.pth")
    monkeypatch.setattr(urllib.request, "urlopen", serving(b"tampered"))
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        download.download_pretrained(18, cache_dir=str(tmp_path), progress=False)
    assert os.listdir(tmp_path) == []  # nothing installed


def test_corrupt_cached_file_is_refetched(tmp_path, monkeypatch):
    payload = b"good-weights"
    url = fake_url(payload)
    monkeypatch.setitem(MODEL_URLS, "resnet18", url)
    (tmp_path / url.rsplit("/", 1)[-1]).write_bytes(b"truncated")
    monkeypatch.setattr(urllib.request, "urlopen", serving(payload))
    out = download.download_pretrained(18, cache_dir=str(tmp_path), progress=False)
    assert open(out, "rb").read() == payload


def test_zero_egress_error_is_actionable(tmp_path, monkeypatch):
    def no_net(url, timeout=60):
        raise urllib.error.URLError("no route to host")

    monkeypatch.setattr(urllib.request, "urlopen", no_net)
    with pytest.raises(RuntimeError, match="--pretrained_backbone") as e:
        download.download_pretrained(50, cache_dir=str(tmp_path), progress=False)
    assert "no network egress" in str(e.value) and MODEL_URLS["resnet50"] in str(e.value)


def test_http_error_is_not_misdiagnosed_as_no_egress(tmp_path, monkeypatch):
    def not_found(url, timeout=60):
        raise urllib.error.HTTPError(url, 404, "Not Found", None, None)

    monkeypatch.setattr(urllib.request, "urlopen", not_found)
    with pytest.raises(RuntimeError, match="HTTP 404") as e:
        download.download_pretrained(50, cache_dir=str(tmp_path), progress=False)
    assert "no network egress" not in str(e.value)


def test_mid_download_disconnect_raises_runtime_error(tmp_path, monkeypatch):
    class Dropping(io.RawIOBase):
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self, n=-1):
            raise http.client.IncompleteRead(b"partial")

    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout=60: Dropping())
    with pytest.raises(RuntimeError, match="--pretrained_backbone"):
        download.download_pretrained(50, cache_dir=str(tmp_path), progress=False)
    assert os.listdir(tmp_path) == []  # the partial file removed


def test_unknown_arch(tmp_path):
    with pytest.raises(KeyError):
        download.download_pretrained("resnet9000", cache_dir=str(tmp_path))


def test_path_used_as_is(tmp_path):
    p = tmp_path / "w.pth"
    p.write_bytes(b"x")
    assert resolve_pretrained(str(p), 50) == str(p)


def test_missing_path_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="auto"):
        resolve_pretrained(str(tmp_path / "nope.pth"), 50)


def test_auto_invokes_download(monkeypatch):
    monkeypatch.setattr(download, "download_pretrained", lambda arch: f"/cache/{arch}.pth")
    assert resolve_pretrained("auto", 50) == "/cache/50.pth"
    assert resolve_pretrained("download", 18) == "/cache/18.pth"


# ------------------------------------------------------------ across the packages


def test_the_default_cache_is_the_jax_packages():
    assert download.default_cache_dir() == jax_download.DEFAULT_CACHE_DIR


def both_tables(monkeypatch, arch, url):
    """``url`` for ``arch`` in the port's table and in the JAX package's."""
    monkeypatch.setitem(MODEL_URLS, arch, url)
    monkeypatch.setitem(JAX_MODEL_URLS, arch, url)


def test_both_packages_write_the_same_file(tmp_path, monkeypatch):
    payload = b"shared-weights"
    both_tables(monkeypatch, "resnet18", fake_url(payload))
    monkeypatch.setattr(urllib.request, "urlopen", serving(payload))
    ours = download.download_pretrained(18, cache_dir=str(tmp_path / "port"), progress=False)
    theirs = jax_download.download_pretrained(18, cache_dir=str(tmp_path / "jax"), progress=False)
    assert os.path.relpath(ours, tmp_path / "port") == os.path.relpath(theirs, tmp_path / "jax")
    assert open(ours, "rb").read() == open(theirs, "rb").read() == payload


@pytest.mark.parametrize("first", ["port", "jax"])
def test_a_file_one_package_fetched_serves_the_other(tmp_path, monkeypatch, first):
    payload = f"fetched-by-{first}".encode()
    both_tables(monkeypatch, "resnet34", fake_url(payload, "resnet34"))
    monkeypatch.setattr(urllib.request, "urlopen", serving(payload))
    fetchers = {"port": download.download_pretrained, "jax": jax_download.download_pretrained}
    path = fetchers[first](34, cache_dir=str(tmp_path), progress=False)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    other = fetchers["jax" if first == "port" else "port"]
    assert other(34, cache_dir=str(tmp_path), progress=False) == path


# ------------------------------------------------------------ the command line


def test_cli_pretrained_backbone_auto_downloads_and_loads(tmp_path, monkeypatch, capsys):
    """A torchvision-keyed R18 state dict served as the download: the
    command line fetches it into ~/.cache/rot_mvgaze_tpu/pretrained and
    starts from it; the exported checkpoint's backbone is those weights."""
    torch.manual_seed(3)
    sd = BACKBONES[18]().state_dict()
    sd = {k: v + 0.01 * torch.randn_like(v) if v.is_floating_point() else v for k, v in sd.items()}
    buf = io.BytesIO()
    torch.save(sd, buf)
    payload = buf.getvalue()
    monkeypatch.setitem(MODEL_URLS, "resnet18", fake_url(payload))
    calls = []
    monkeypatch.setattr(urllib.request, "urlopen", serving(payload, calls))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    subjects = load_yaml(os.path.join(REPO, "configs", "subject", "mpiinv.yaml"))["subject"]
    write_synthetic_dataset(str(tmp_path / "mpiinv"), subjects, n_frames=1, image_size=32, learnable=True)
    data_path = tmp_path / "data_path.yaml"
    data_path.write_text(f"xgaze: '{tmp_path / 'xgaze'}'\nmpiinv: '{tmp_path / 'mpiinv'}'\n")
    exported = str(tmp_path / "exported.pth.tar")
    assert cli.main(["--exp_name", "mpiinv_known", "--data_path", str(data_path), "--device", "cpu",
                     "--backbone_depth", "18", "--num_iter", "1", "--image_size", "32", "--bf16", "false",
                     "--native_loader", "false", "--num_workers", "2", "--test_batch_size", "135",
                     "--epochs", "0", "--pretrained_backbone", "auto", "-out", str(tmp_path / "out"),
                     "--export_torch", exported]) == 0
    cached = tmp_path / "home" / ".cache" / "rot_mvgaze_tpu" / "pretrained" / MODEL_URLS["resnet18"].rsplit("/")[-1]
    assert len(calls) == 1 and cached.read_bytes() == payload
    assert f"backbone initialized from {cached}" in capsys.readouterr().out
    got = torch.load(exported, map_location="cpu", weights_only=True)
    got = got.get("state_dict", got)
    for k, v in sd.items():
        if not k.startswith("fc.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(got[f"_feat_extractor.0.{k}"], v), k
    assert glob.glob(str(tmp_path / "out" / "*" / "*" / "test_results.txt"))
    assert pretrained.resolve_pretrained("auto", 18) == str(cached)  # now cached: no second fetch
    assert len(calls) == 1
