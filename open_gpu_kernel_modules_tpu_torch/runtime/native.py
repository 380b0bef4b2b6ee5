"""ctypes loader for the native tpurm core (native/build/libtpurm.so).

The port's own copy of the part of the JAX package's ``runtime/native.py``
that the tiered KV backing needs: the library loader, ``build_native``,
``RmError`` and the status codes it checks.  Both packages load the same
``native/build/libtpurm.so`` from the repository root; in one process the
dynamic loader hands both the same library, and each package creates its
own VA spaces in it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libtpurm.so")

TPU_OK = 0x0
# status.h TPU_ERR_DEVICE_RESET: a completion rejected by the device-
# generation fence (a full reset ran under the op); retryable by contract.
TPU_ERR_DEVICE_RESET = 0x73

_lib: Optional[ctypes.CDLL] = None


class RmError(RuntimeError):
    def __init__(self, status: int, what: str):
        super().__init__(f"{what}: status=0x{status:x}")
        self.status = status


def build_native(force: bool = False) -> str:
    """Build libtpurm.so if missing (``make -C native all``, one job per
    CPU).  Raises with make's output when the build fails."""
    if force or not os.path.exists(_LIB_PATH):
        proc = subprocess.run(
            ["make", "-C", _NATIVE_DIR, f"-j{os.cpu_count() or 1}", "all"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"make -C native all failed:\n{proc.stdout}"
                               f"\n{proc.stderr}")
    return _LIB_PATH


def load() -> ctypes.CDLL:
    """The native library, built first if missing."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build_native())
    return _lib
