"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``ops/csrc/`` is compiled on its own, for ``sm_90a``, into
a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so ops/csrc/<name>.cu

The libraries land in ``open_gpu_kernel_modules_tpu_torch/_build/`` (listed
in ``.gitignore``) on first use.  The file name carries a hash of the source,
the headers beside it and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.  ``build_all`` starts one nvcc per
source at once.  Nothing here runs at import time, so a host without nvcc
can import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_OPS = Path(__file__).resolve().parent
CSRC = _OPS / "csrc"
BUILD_DIR = _OPS.parent / "_build"
SOURCES = ("paged_decode", "flash_attn", "flash_rows")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "are built only on a host with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to.  The hash covers the source,
    every ``csrc/*.cuh`` header (a source may include any of them) and the
    flags, so an edited header rebuilds the libraries too."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> subprocess.Popen:
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale library in parallel; return nvcc's output by
    name (empty for a library that was already built).  Raises on the
    first failed compile, after every started nvcc has exited."""
    procs = {n: _start(n) for n in names if not library_path(n).exists()}
    logs = {n: "" for n in names}
    failed = []
    for n, proc in procs.items():
        logs[n], _ = proc.communicate()
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))   # atomic: no half-written .so
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    lib = _loaded.get(name)
    if lib is None:
        if not library_path(name).exists():
            build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
