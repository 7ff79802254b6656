"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper) into an object file; the objects
are linked into one shared library with a plain C interface,
``build/torch_kernels/libmvgaze_kernels.so`` under the repository root,
loaded with ``ctypes``. Nothing includes PyTorch's headers, so a build takes
seconds. The library is built on first use and rebuilt when a source is
newer than it. Each source's ``-Xptxas -v`` report (registers, shared
memory, spills) is kept beside it as ``<source>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_PATH = BUILD_DIR / "libmvgaze_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def build(force: bool = False) -> Path:
    """Compile and link the library if it is missing or older than a source;
    returns its path. Raises with the compiler's output if a step fails."""
    sources = _sources()
    if (
        not force
        and LIB_PATH.exists()
        and LIB_PATH.stat().st_mtime >= max(s.stat().st_mtime for s in sources)
    ):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    tag = f"{os.getpid()}"
    objects = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
    procs = [
        subprocess.Popen(
            [compiler, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for src, obj in zip(sources, objects)
    ]
    failed = []
    for src, proc in zip(sources, procs):
        log, _ = proc.communicate()
        (BUILD_DIR / f"{src.name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = BUILD_DIR / f"{LIB_PATH.name}.{tag}.tmp"
        link = subprocess.run(
            [compiler, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
            capture_output=True,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return LIB_PATH


def build_logs() -> Dict[str, str]:
    """``-Xptxas -v`` report of each source's last build, by source name."""
    return {
        s.name: (BUILD_DIR / f"{s.name}.log").read_text()
        for s in _sources()
        if (BUILD_DIR / f"{s.name}.log").exists()
    }


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process."""
    return ctypes.CDLL(str(build()))
