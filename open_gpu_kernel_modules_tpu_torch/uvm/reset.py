"""Full-device reset and the device generation (native/src/reset.c).

The port's copy of the JAX package's ``uvm/reset.py``: ``generation()``,
which bumps once per completed full-device reset; ``device_reset()``, which
forces one (quiesce, generation bump, restore); ``watchdog_start()``, which
starts the hung-op watchdog whose health tick posts chip evacuation
requests; and ``stats()``, with each reset's time to recover (MTTR).
``ManagedKVBacking.read_pages`` retries a batch the generation fence
rejected only while the generation keeps advancing; the scheduler polls it
every round and parks and restores its running sequences when it moved.
"""

from __future__ import annotations

import ctypes
import dataclasses

from ..runtime import native

_bound = None


class _Stats(ctypes.Structure):
    _fields_ = [
        ("generation", ctypes.c_uint64),
        ("resets", ctypes.c_uint64),
        ("failedResets", ctypes.c_uint64),
        ("injectedResets", ctypes.c_uint64),
        ("watchdogNudges", ctypes.c_uint64),
        ("watchdogRcResets", ctypes.c_uint64),
        ("watchdogDeviceResets", ctypes.c_uint64),
        ("watchdogEvacuations", ctypes.c_uint64),
        ("lastMttrNs", ctypes.c_uint64),
        ("lastQuiesceNs", ctypes.c_uint64),
        ("lastRestoreNs", ctypes.c_uint64),
        ("mttrSumNs", ctypes.c_uint64),
        ("staleCompletions", ctypes.c_uint64),
    ]


@dataclasses.dataclass(frozen=True)
class ResetStats:
    """Snapshot of tpurm/reset.h TpuResetStats."""

    generation: int
    resets: int
    failed_resets: int
    injected_resets: int
    watchdog_nudges: int
    watchdog_rc_resets: int
    watchdog_device_resets: int
    watchdog_evacuations: int
    last_mttr_ns: int
    last_quiesce_ns: int
    last_restore_ns: int
    mttr_sum_ns: int
    stale_completions: int

    @property
    def last_mttr_ms(self) -> float:
        """The last reset's time to recover (quiesce to restore), ms."""
        return self.last_mttr_ns / 1e6

    @property
    def mean_mttr_ms(self) -> float:
        """Mean time to recover over every reset, ms (0 before any)."""
        return (self.mttr_sum_ns / self.resets / 1e6) if self.resets \
            else 0.0


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = native.load()
        lib.tpurmDeviceGeneration.argtypes = []
        lib.tpurmDeviceGeneration.restype = ctypes.c_uint64
        lib.tpurmDeviceReset.argtypes = []
        lib.tpurmDeviceReset.restype = ctypes.c_uint32
        lib.tpurmResetStats.argtypes = [ctypes.POINTER(_Stats)]
        lib.tpurmResetStats.restype = None
        lib.tpurmResetWatchdogStart.argtypes = []
        lib.tpurmResetWatchdogStart.restype = None
        _bound = lib
    return _bound


def generation() -> int:
    """The device-wide generation (bumps once per completed reset)."""
    return _lib().tpurmDeviceGeneration()


def device_reset() -> None:
    """Force a coordinated full-device reset (quiesce -> reset -> restore);
    concurrent callers coalesce onto one reset.  RmError if it could not
    run."""
    st = _lib().tpurmDeviceReset()
    if st != 0:
        raise native.RmError(st, "tpurmDeviceReset")


def watchdog_start() -> None:
    """Start the hung-op watchdog (idempotent)."""
    _lib().tpurmResetWatchdogStart()


def stats() -> ResetStats:
    """Reset and watchdog statistics."""
    raw = _Stats()
    _lib().tpurmResetStats(ctypes.byref(raw))
    return ResetStats(*(getattr(raw, f) for f, _ in _Stats._fields_))
