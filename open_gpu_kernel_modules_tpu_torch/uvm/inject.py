"""Fault injection sites of the native engine (native/src/inject.c).

The port's copy of the part of the JAX package's ``uvm/inject.py`` that the
scheduler, the vac migration engine and their tests use: seed the sites'
PRNG, arm a named site (one-shot, every Nth, or parts-per-million, each hit
failing ``burst`` evaluations in a row), evaluate one the way an engine check
does (the scheduler's ``sched.admit`` gate, vac's ``vac.migrate``), disarm,
and read back (evaluations, hits).  Site state is
process-wide in the native library.
"""

from __future__ import annotations

import ctypes
import enum
from typing import Tuple

from ..runtime import native


class Site(enum.IntEnum):
    """Injection sites (inject.h TpuInjectSite)."""

    PMM_ALLOC = 0        # PMM chunk allocation (HBM/CXL backing)
    MIGRATE_COPY = 1     # block migration copy pass
    MSGQ_PUBLISH = 2     # msgq submit (mirror / RC shadow / GPFIFO)
    ICI_LINK = 3         # ICI link flap / retrain failure
    RDMA_COMPLETION = 4  # MR pin/map completion error
    CHANNEL_CE = 5       # channel CE push fault
    FENCE_TIMEOUT = 6    # fault-service / fence timeout
    MEMRING_SUBMIT = 7   # memring op execution (per coalesced run)
    CE_COPY = 8          # tpuce stripe submission (per attempt)
    SCHED_ADMIT = 9      # scheduler admission decision (per pass)
    RESET_DEVICE = 10    # forced full-device reset (per watchdog tick)
    VAC_MIGRATE = 11     # record shipping (per copy attempt)
    HOT_DECIDE = 12      # hotness policy decision (degrade-to-no-op)
    MEM_CORRUPT = 13     # bit flip in a sealed page / wire buffer
    DUMP_WRITE = 14      # crash-bundle serialization (per section)


class Mode(enum.IntEnum):
    OFF = 0
    ONESHOT = 1
    NTH = 2              # arg = N: every Nth evaluation
    PPM = 3              # arg = parts-per-million probability


_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is not None:
        return _bound
    lib = native.load()
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    lib.tpurmInjectConfigure.argtypes = [u32, u32, u64, u32, u64]
    lib.tpurmInjectConfigure.restype = u32
    lib.tpurmInjectDisable.argtypes = [u32]
    lib.tpurmInjectDisable.restype = None
    lib.tpurmInjectDisableAll.argtypes = []
    lib.tpurmInjectDisableAll.restype = None
    lib.tpurmInjectCounts.argtypes = [u32, ctypes.POINTER(u64),
                                      ctypes.POINTER(u64)]
    lib.tpurmInjectCounts.restype = None
    lib.tpurmInjectShouldFail.argtypes = [u32]
    lib.tpurmInjectShouldFail.restype = ctypes.c_bool
    lib.tpurmInjectSetSeed.argtypes = [u64]
    lib.tpurmInjectSetSeed.restype = None
    _bound = lib
    return lib


def should_fail(site: Site) -> bool:
    """Evaluate a site the way an engine check does (one native call; the
    disarmed fast path stays intact)."""
    return bool(_lib().tpurmInjectShouldFail(int(site)))


def set_seed(seed: int) -> None:
    """Reseed every site's PRNG (same seed, same hit sequence)."""
    _lib().tpurmInjectSetSeed(seed)


def enable(site: Site, mode: Mode, arg: int = 0, burst: int = 1) -> None:
    """Arm a site.  ``burst`` makes each hit fail that many consecutive
    evaluations."""
    # The last argument is the native scope key; 0 means every evaluation.
    st = _lib().tpurmInjectConfigure(int(site), int(mode), arg, burst, 0)
    if st != 0:
        raise native.RmError(st, "tpurmInjectConfigure")


def disable(site: Site) -> None:
    _lib().tpurmInjectDisable(int(site))


def disable_all() -> None:
    _lib().tpurmInjectDisableAll()


def counts(site: Site) -> Tuple[int, int]:
    """(evaluations, hits) for a site since process start."""
    evals, hits = ctypes.c_uint64(), ctypes.c_uint64()
    _lib().tpurmInjectCounts(int(site), ctypes.byref(evals),
                             ctypes.byref(hits))
    return evals.value, hits.value
