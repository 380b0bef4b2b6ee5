"""Poison probe of the native page-integrity engine (native/src/shield.c).

The port's copy of the part of the JAX package's ``uvm/shield.py`` that the
scheduler uses for poison containment: the status a poisoned-page access
fails with, and ``span_poisoned``, which counts the poisoned pages inside a
managed span, so a failed round is pinned on the stream that owns them.
"""

from __future__ import annotations

import ctypes

from ..runtime import native

#: TpuStatus of a poisoned-page access (status.h TPU_ERR_PAGE_POISONED).
PAGE_POISONED = 0x74

_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = native.load()
        lib.tpurmShieldSpanPoisoned.argtypes = [ctypes.c_uint64,
                                                ctypes.c_uint64]
        lib.tpurmShieldSpanPoisoned.restype = ctypes.c_uint32
        _bound = lib
    return _bound


def span_poisoned(addr: int, length: int) -> int:
    """Poisoned pages inside the managed span."""
    return int(_lib().tpurmShieldSpanPoisoned(addr, length))
