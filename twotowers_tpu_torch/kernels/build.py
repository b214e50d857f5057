"""Build the package's CUDA sources at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/twotowers_tpu_torch/lib<name>.so`` at the root of the checkout, a
shared library with a plain C interface that ``ctypes`` loads. A source is
rebuilt when it is newer than its library. Nothing is built at import, so
the package imports on a machine without ``nvcc``; a build that cannot run
or fails raises. The check for a stale library and the ``nvcc`` run hold a
file lock (``fcntl.flock``) in the build directory, so the ranks of a
process group that start together never build one library at once: the
first builds it, the others find it fresh.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "twotowers_tpu_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into <name>.log
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Every CUDA source of the package, by name."""
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def find_nvcc() -> str:
    """The ``nvcc`` of ``$CUDA_HOME``, of ``$PATH`` or of the default
    toolkit location; raises when there is none."""
    candidates = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
                  if os.environ.get("CUDA_HOME") else None,
                  shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _stale(name: str) -> bool:
    lib = library_path(name)
    return not lib.exists() or lib.stat().st_mtime < sources()[name].stat().st_mtime


@contextlib.contextmanager
def _build_lock():
    """Hold the build directory's lock file, across processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the named sources (default: all) that are stale, one ``nvcc``
    per source, all started together, under the build lock. Returns the
    seconds it took (0 when nothing was stale)."""
    start = time.perf_counter()
    with _build_lock():
        srcs = sources()
        todo = [n for n in (srcs if names is None else names) if _stale(n)]
        if not todo:
            return 0.0
        _compile(srcs, todo)
    return time.perf_counter() - start


def _compile(srcs: Dict[str, Path], todo: List[str]) -> None:
    nvcc = find_nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_bytes(out)
        if proc.returncode != 0:
            failed.append(f"{name}: {out.decode(errors='replace')[-2000:]}")
            continue
        os.replace(tmp, library_path(name))  # atomic: never load a partial file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
