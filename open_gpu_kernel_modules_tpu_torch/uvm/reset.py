"""Device generation of the native reset engine (native/src/reset.c).

The port's copy of the one call of the JAX package's ``uvm/reset.py`` that
the tiered KV backing uses: ``generation()``, which bumps once per completed
full-device reset.  ``ManagedKVBacking.read_pages`` retries a batch the
generation fence rejected only while this keeps advancing.
"""

from __future__ import annotations

import ctypes

from ..runtime import native

_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = native.load()
        lib.tpurmDeviceGeneration.argtypes = []
        lib.tpurmDeviceGeneration.restype = ctypes.c_uint64
        _bound = lib
    return _bound


def generation() -> int:
    """The device-wide generation (bumps once per completed reset)."""
    return _lib().tpurmDeviceGeneration()
