"""tpuhot, hotness-driven placement: stats and coldness probes
(native/src/hot.c, public header tpurm/hot.h).

The port's own copy of the JAX package's ``uvm/hot.py``: the policy stats
(pins, throttles, prefetch governor moves, victim reorders, inject skips),
the per-device hotness gauge, the measured prefetch precision, the
counter family, and ``span_score``, the mean decayed hotness of the
managed blocks covering a span (half-life ``hot_decay_ms``, 250 ms by
default), which the scheduler's preemption victim choice reads: lower is
colder.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

from ..runtime import native

_bound = None


class _Stats(ctypes.Structure):
    _fields_ = [
        ("pins", ctypes.c_uint64),
        ("throttles", ctypes.c_uint64),
        ("throttleDelays", ctypes.c_uint64),
        ("thrashPages", ctypes.c_uint64),
        ("prefetchGrown", ctypes.c_uint64),
        ("prefetchShrunk", ctypes.c_uint64),
        ("victimReorders", ctypes.c_uint64),
        ("injectSkips", ctypes.c_uint64),
        ("decisions", ctypes.c_uint64),
    ]


@dataclasses.dataclass(frozen=True)
class HotStats:
    """Snapshot of tpurm/hot.h TpuHotStats."""

    pins: int
    throttles: int
    throttle_delays: int
    thrash_pages: int
    prefetch_grown: int
    prefetch_shrunk: int
    victim_reorders: int
    inject_skips: int
    decisions: int


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is not None:
        return _bound
    lib = native.load()
    lib.tpurmHotStatsGet.argtypes = [ctypes.POINTER(_Stats)]
    lib.tpurmHotStatsGet.restype = None
    lib.tpurmHotStatsReset.argtypes = []
    lib.tpurmHotStatsReset.restype = None
    lib.tpurmHotDeviceScore.argtypes = [ctypes.c_uint32]
    lib.tpurmHotDeviceScore.restype = ctypes.c_uint64
    lib.tpurmHotSpanScore.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.tpurmHotSpanScore.restype = ctypes.c_uint64
    _bound = lib
    return lib


def stats() -> HotStats:
    """Lifetime policy stats (pins, throttles, governor adjustments,
    victim reorders, inject skips)."""
    raw = _Stats()
    _lib().tpurmHotStatsGet(ctypes.byref(raw))
    return HotStats(
        pins=raw.pins, throttles=raw.throttles,
        throttle_delays=raw.throttleDelays,
        thrash_pages=raw.thrashPages,
        prefetch_grown=raw.prefetchGrown,
        prefetch_shrunk=raw.prefetchShrunk,
        victim_reorders=raw.victimReorders,
        inject_skips=raw.injectSkips, decisions=raw.decisions)


def stats_reset() -> None:
    """Zero the process-global policy stats and device gauges (tests;
    per-block tracker state decays on its own)."""
    _lib().tpurmHotStatsReset()


def device_score(dev: int = 0) -> int:
    """Decayed per-device hotness gauge (tpurm_hot_device_score)."""
    return int(_lib().tpurmHotDeviceScore(dev))


def span_score(addr: int, length: int) -> int:
    """Mean decayed hotness of the managed blocks covering
    ``[addr, addr+length)`` — 0 for non-managed spans.  The coldness
    signal tpusched victim choice consumes: lower = colder."""
    return int(_lib().tpurmHotSpanScore(addr, length))


def prefetch_precision() -> float:
    """Measured prefetch precision hits/(hits+useless) from the prefetch
    effectiveness counters — the signal the governor steers by.
    1.0 when nothing speculative was ever measured."""
    lib = _lib()
    hits = lib.tpurmCounterGet(b"uvm_prefetch_hits")
    useless = lib.tpurmCounterGet(b"uvm_prefetch_useless")
    total = hits + useless
    return (hits / total) if total else 1.0


def counters() -> Dict[str, int]:
    """The tpuhot counter family as scraped names."""
    lib = _lib()
    names = ("tpurm_hot_pins", "tpurm_hot_throttles",
             "tpurm_hot_throttle_delays", "tpurm_hot_thrash_pages",
             "tpurm_hot_prefetch_grown", "tpurm_hot_prefetch_shrunk",
             "tier_hot_victim_reorders", "hot_inject_skips")
    return {n: lib.tpurmCounterGet(n.encode()) for n in names}
