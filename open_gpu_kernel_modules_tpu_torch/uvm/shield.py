"""Poison probe and wire CRC of the native page-integrity engine
(native/src/shield.c).

The port's copy of the part of the JAX package's ``uvm/shield.py`` that the
scheduler and the vac migration engine use: the status a poisoned-page
access fails with; ``span_poisoned``, which counts the poisoned pages inside
a managed span, so a failed round is pinned on the stream that owns them;
and the wire check of a shipped record — ``crc32c`` seals the source bytes,
``inject_wire`` gives the ``mem.corrupt`` inject site one evaluation over
the shipped copy, ``verify_wire`` checks the copy against the seal (both
counted in the shield's wire counters).
"""

from __future__ import annotations

import ctypes

import numpy as np

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
        u32, u64 = ctypes.c_uint32, ctypes.c_uint64
        lib.tpurmShieldCrc32c.argtypes = [ctypes.c_void_p, u64]
        lib.tpurmShieldCrc32c.restype = u32
        lib.tpurmShieldInjectWire.argtypes = [ctypes.c_void_p, u64, u64]
        lib.tpurmShieldInjectWire.restype = ctypes.c_bool
        lib.tpurmShieldVerifyWire.argtypes = [ctypes.c_void_p, u64, u32, u64]
        lib.tpurmShieldVerifyWire.restype = u32
        _bound = lib
    return _bound


def span_poisoned(addr: int, length: int) -> int:
    """Poisoned pages inside the managed span."""
    return int(_lib().tpurmShieldSpanPoisoned(addr, length))


def _buf_ptr_len(buf) -> tuple[int, int]:
    a = np.asarray(buf)
    if not a.flags.c_contiguous:
        # A contiguous copy would be a temporary: an injected flip would
        # land in (and a verify would check) bytes the caller does not hold.
        raise ValueError("shield wire ops need a C-contiguous buffer")
    a = a.view(np.uint8)
    return int(a.ctypes.data), int(a.nbytes)


def crc32c(buf) -> int:
    """CRC32C of a numpy array's bytes."""
    ptr, n = _buf_ptr_len(buf)
    return int(_lib().tpurmShieldCrc32c(ptr, n))


def inject_wire(buf, scope: int) -> bool:
    """One mem.corrupt evaluation over a shipped buffer: a hit flips one bit
    in place (a verify must follow, which keeps the reconciliation exact)."""
    ptr, n = _buf_ptr_len(buf)
    return bool(_lib().tpurmShieldInjectWire(ptr, n, scope))


def verify_wire(buf, expect_crc: int, scope: int) -> bool:
    """CRC-check a shipped buffer against its seal; False on a mismatch
    (counted; the caller re-ships from its intact source)."""
    ptr, n = _buf_ptr_len(buf)
    return _lib().tpurmShieldVerifyWire(ptr, n, expect_crc & 0xFFFFFFFF,
                                        scope) == 0
