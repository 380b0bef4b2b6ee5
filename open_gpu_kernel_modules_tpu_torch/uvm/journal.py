"""Emit path of the native black-box journal (native/src/journal.c).

The port's copy of the part of the JAX package's ``uvm/journal.py`` that
the scheduler uses: the record types and ``emit``, which appends one
64-byte structured record (load shed, preemption, poison retire) to the
always-on journal ring with the request's tpuflow id.
"""

from __future__ import annotations

import ctypes
import enum

from ..runtime import native


class RecType(enum.IntEnum):
    """Journal record types (journal.h TpuJournalRecType)."""

    HEALTH_NOTE = 1        # a0 = health event, a1 = score after
    HEALTH_TRANSITION = 2  # a0 = old state, a1 = new state
    HEALTH_EVAC = 3        # evacuation posted: a0 = reqId, a1 = target
    WD_RUNG = 4            # a0 = rung (1 nudge / 2 rc / 25 evac / 3 reset)
    RESET_GEN = 5          # generation bump: a0 = new generation
    RESET_DEVICE = 6       # reset complete: a0 = gen, a1 = mttr ns
    RING_STALE = 7         # cross-generation completion discarded
    RING_DEADLINE = 8      # SQE deadline expired
    ICI_FLAP = 9           # a0 = src chip, a1 = dst chip
    ICI_RETRAIN = 10       # retrain FAILED: a0 = src, a1 = dst
    ICI_CRC = 11           # per-hop wire CRC mismatch: a0 = src, a1 = dst
    PAGE_QUARANTINE = 12   # a0 = va
    PAGE_POISON = 13       # a0 = va, a1 = tier
    SHIELD_VERDICT = 14    # re-fetch ladder verdict: a0 = va/scope
    VAC_BEGIN = 15         # a0 = txn id, a1 = src<<32 | dst
    VAC_COMMIT = 16        # a0 = txn id
    VAC_ABORT = 17         # a0 = txn id, a1 = src<<32 | dst
    INJECT_HIT = 18        # a0 = site, a1 = scope
    SCHED_SHED = 19        # a0 = waiting count (scheduler)
    SCHED_PREEMPT = 20     # a0 = seq slot, a1 = preempts (scheduler)
    SCHED_RETIRE = 21      # poison retire: a0 = seq slot (scheduler)
    CLIENT_DEATH = 22      # a0 = pid
    LOG = 23               # WARN+ log mirror: a0 = level
    DUMP = 24              # bundle written: a1 = 1 complete / 0 truncated
    CRC_SELFTEST = 25      # HW CRC32C mismatch: a0 = hw crc, a1 = want
    TIER_REMOTE = 26       # a0 = pages/leases, a1 = op; dev = lender


_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = native.load()
        u32, u64 = ctypes.c_uint32, ctypes.c_uint64
        lib.tpurmJournalEmitFlow.argtypes = [u32, u32, u32, u64, u64, u64]
        lib.tpurmJournalEmitFlow.restype = None
        _bound = lib
    return _bound


def emit(rec_type: RecType, dev: int = 0, status: int = 0, a0: int = 0,
         a1: int = 0, flow: int = 0) -> None:
    """Append one record; ``flow`` is the tpuflow id of the request."""
    _lib().tpurmJournalEmitFlow(int(rec_type), dev, status, a0, a1, flow)
