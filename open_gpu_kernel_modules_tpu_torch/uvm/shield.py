"""The native page-integrity engine (native/src/shield.c).

The port's copy of the JAX package's ``uvm/shield.py``.  The engine seals
each page with a CRC32C when it goes cold (tier demote, eviction copy-back,
save) or crosses a wire, verifies it on the way back hot, and on a mismatch
climbs a bounded re-fetch ladder (recompute, sibling copy, then POISON and
retire the page); a background scrubber catches corruption before a demand
fault does.

- ``stats`` / ``enabled``: lifetime counters (seals, verifies, mismatches,
  re-fetch saves, poisons, retirements, scrub activity) and the mem.corrupt
  reconciliation: ``inject_corrupts == inject_detected + inject_misses``,
  with ``inject_misses == 0``.
- ``span_poisoned``: the poisoned pages inside a managed span, so a failed
  round is pinned on the stream that owns them (the scheduler's probe).
- ``crc32c`` / ``inject_wire`` / ``verify_wire``: the wire check of a
  shipped record (``crc32c`` seals the source bytes, ``inject_wire`` gives
  the ``mem.corrupt`` site one evaluation over the shipped copy,
  ``verify_wire`` checks it against the seal; both counted in the shield's
  wire counters); ``crc32c_at`` seals raw process memory.
- ``scrub_now`` / ``retired_pages`` / ``span_retired``: one scrub pass and
  the quarantine list.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np

from ..runtime import native

#: TpuStatus of a poisoned-page access (status.h TPU_ERR_PAGE_POISONED).
PAGE_POISONED = 0x74


class _Stats(ctypes.Structure):
    _fields_ = [
        ("seals", ctypes.c_uint64),
        ("verifies", ctypes.c_uint64),
        ("mismatches", ctypes.c_uint64),
        ("refetchSaves", ctypes.c_uint64),
        ("pagesPoisoned", ctypes.c_uint64),
        ("pagesRetired", ctypes.c_uint64),
        ("scrubTicks", ctypes.c_uint64),
        ("scrubPages", ctypes.c_uint64),
        ("scrubHits", ctypes.c_uint64),
        ("injectCorrupts", ctypes.c_uint64),
        ("injectDetected", ctypes.c_uint64),
        ("injectMisses", ctypes.c_uint64),
        ("wireVerifies", ctypes.c_uint64),
        ("wireMismatches", ctypes.c_uint64),
    ]


@dataclasses.dataclass(frozen=True)
class ShieldStats:
    """Snapshot of the integrity engine (shield.h TpuShieldStats)."""

    seals: int
    verifies: int
    mismatches: int
    refetch_saves: int
    pages_poisoned: int
    pages_retired: int
    scrub_ticks: int
    scrub_pages: int
    scrub_hits: int
    inject_corrupts: int
    inject_detected: int
    inject_misses: int
    wire_verifies: int
    wire_mismatches: int


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
        lib.tpurmShieldEnabled.argtypes = []
        lib.tpurmShieldEnabled.restype = ctypes.c_bool
        lib.tpurmShieldStatsGet.argtypes = [ctypes.POINTER(_Stats)]
        lib.tpurmShieldStatsGet.restype = None
        lib.tpurmShieldScrubNow.argtypes = [u32]
        lib.tpurmShieldScrubNow.restype = u32
        lib.tpurmShieldRetiredPages.argtypes = [u32]
        lib.tpurmShieldRetiredPages.restype = u64
        lib.tpurmShieldRetiredTotal.argtypes = []
        lib.tpurmShieldRetiredTotal.restype = u64
        lib.tpurmShieldSpanRetired.argtypes = [u32, u32, u64, u64]
        lib.tpurmShieldSpanRetired.restype = ctypes.c_bool
        _bound = lib
    return _bound


def enabled() -> bool:
    return bool(_lib().tpurmShieldEnabled())


def stats() -> ShieldStats:
    raw = _Stats()
    _lib().tpurmShieldStatsGet(ctypes.byref(raw))
    return ShieldStats(*(getattr(raw, f) for f, _ in _Stats._fields_))


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


def crc32c_at(addr: int, length: int) -> int:
    """CRC32C over raw process memory (an engine window)."""
    return int(_lib().tpurmShieldCrc32c(addr, length))


def inject_wire(buf, scope: int = 0) -> bool:
    """One mem.corrupt evaluation over a shipped buffer: a hit flips one bit
    in place (a verify must follow, which keeps the reconciliation exact)."""
    ptr, n = _buf_ptr_len(buf)
    return bool(_lib().tpurmShieldInjectWire(ptr, n, scope))


def verify_wire(buf, expect_crc: int, scope: int = 0) -> bool:
    """CRC-check a shipped buffer against its seal; False on a mismatch
    (counted; the caller re-ships from its intact source)."""
    ptr, n = _buf_ptr_len(buf)
    return _lib().tpurmShieldVerifyWire(ptr, n, expect_crc & 0xFFFFFFFF,
                                        scope) == 0


def scrub_now(max_pages: int = 4096) -> int:
    """One synchronous scrub pass; returns the pages scrubbed."""
    return int(_lib().tpurmShieldScrubNow(max_pages))


def retired_pages(dev: Optional[int] = None) -> int:
    """Retired (quarantined) pages of device ``dev``, or of every device."""
    if dev is None:
        return int(_lib().tpurmShieldRetiredTotal())
    return int(_lib().tpurmShieldRetiredPages(dev))


def span_retired(tier: int, dev: int, offset: int, length: int) -> bool:
    """True when the arena span overlaps a retired (quarantined) page."""
    return bool(_lib().tpurmShieldSpanRetired(tier, dev, offset, length))
