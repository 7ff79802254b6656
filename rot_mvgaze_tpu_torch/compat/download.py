"""The pretrained-backbone download (port of
``rot_mvgaze_tpu/compat/download.py``, standard library only).

:func:`download_pretrained` fetches a torchvision ImageNet ResNet file
(``compat.pretrained.MODEL_URLS``) into the cache both packages share,
``~/.cache/rot_mvgaze_tpu/pretrained``, and checks it against the sha256
prefix that torchvision puts in every file name (``<arch>-<sha[:8]>.pth``).
A cached file that passes is used as it is; one that fails is deleted and
fetched again. The bytes go to ``<dest>.tmp.<pid>``, which is renamed
into place only after the check, and removed on every other exit.
Failures raise ``RuntimeError`` saying what to do: an HTTP error names
the server's answer; a failed connection, a dropped transfer or a timeout
says the machine appears to have no network egress; a checksum mismatch
installs nothing.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Optional

from rot_mvgaze_tpu_torch.compat.pretrained import MODEL_URLS


def default_cache_dir() -> str:
    """``~/.cache/rot_mvgaze_tpu/pretrained``, the JAX package's cache."""
    return os.path.join(os.path.expanduser("~"), ".cache", "rot_mvgaze_tpu", "pretrained")


def arch_name(arch: Any) -> str:
    """The ``MODEL_URLS`` name of ``arch`` (an int depth or a variant
    name); ``KeyError`` for an unknown one."""
    name = f"resnet{arch}" if isinstance(arch, int) else str(arch)
    if name not in MODEL_URLS:
        raise KeyError(f"unknown backbone {arch!r}; known: {sorted(MODEL_URLS)}")
    return name


def expected_sha_prefix(url: str) -> str:
    """The sha256 prefix in a torchvision file name, ``<arch>-<sha[:8]>.pth``."""
    return url.rsplit("/", 1)[-1].rsplit("-", 1)[-1].split(".")[0]


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_pretrained(arch: Any, cache_dir: Optional[str] = None, progress: bool = True) -> str:
    """The path of ``arch``'s ImageNet checkpoint in ``cache_dir`` (default
    :func:`default_cache_dir`), fetched with ``urllib.request.urlopen(url,
    timeout=60)`` unless a cached copy passes its checksum (the module
    docstring)."""
    import http.client
    import urllib.error
    import urllib.request

    name = arch_name(arch)
    url = MODEL_URLS[name]
    cache_dir = cache_dir or default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    fname = url.rsplit("/", 1)[-1]
    dest = os.path.join(cache_dir, fname)
    expected = expected_sha_prefix(url)
    if os.path.exists(dest):
        if sha256(dest).startswith(expected):
            return dest
        os.unlink(dest)  # a corrupt or partial file: fetch it again
    remedy = f"pass its path via --pretrained_backbone /path/to/{fname}"
    tmp = f"{dest}.tmp.{os.getpid()}"
    try:
        if progress:
            print(f"downloading {url} -> {dest}", flush=True)
        try:
            with urllib.request.urlopen(url, timeout=60) as response, open(tmp, "wb") as out:
                for chunk in iter(lambda: response.read(1 << 20), b""):
                    out.write(chunk)
        except urllib.error.HTTPError as e:
            # the server answered: the address or the server is at fault, not
            # the network (HTTPError is a URLError)
            raise RuntimeError(
                f"could not download pretrained weights for {name} ({url}): the server returned HTTP "
                f"{e.code} {e.reason}. Check the address in MODEL_URLS, or download the file elsewhere "
                f"and {remedy}."
            ) from e
        except (urllib.error.URLError, http.client.HTTPException, OSError, TimeoutError) as e:
            raise RuntimeError(
                f"could not download pretrained weights for {name} ({url}): {e}. This environment "
                f"appears to have no network egress: download the file on a connected machine and "
                f"{remedy}."
            ) from e
        got = sha256(tmp)
        if not got.startswith(expected):
            raise RuntimeError(
                f"checksum mismatch for {dest}: expected a sha256 starting {expected}, got {got[:8]}; "
                f"a corrupted download or a tampered source, not installing it."
            )
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return dest
