"""tpubox, the black-box journal of the native engine (native/src/journal.c).

The port's own copy of the JAX package's ``uvm/journal.py``.  Every engine
error or recovery moment (health notes, watchdog rungs, generation bumps,
stale or late completions, ICI flaps, page quarantine and poison, vac
manifests, inject hits) is a 64-byte record in a memfd-backed ring.  This
module emits records for the Python-side engines (the scheduler stamps its
tpuflow id), reads the journal back (stats, per-type counts, the text the
procfs node serves), writes and finds crash bundles, and tails the ring
live: :class:`Subscriber` dups the region memfd, maps it shared, keeps a
cursor of its own and blocks on the header's futex doorbell.

Record ABI (journal.h): 64-byte records ``seq@0 tsNs@8 flow@16 a0@24
a1@32 status@40 type@44 dev@46``; one 4 KiB header page ``magic@0
version@4 cap@8 recSize@12 widx@16 dropped@24 doorbell@32 nsubs@36
emitted[]@40``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
import mmap as _mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

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


#: Buffer size for the text rendering.
TEXT_BYTES = 1 << 20

#: Header struct offsets (journal.h TpuJournalHdr — fixed ABI).
_HDR = struct.Struct("<IIII QQ II")
_REC = struct.Struct("<QQQQQ IHH 16x")
_HDR_BYTES = 4096
_REC_BYTES = 64
_MAGIC = 0x31424A54


@dataclasses.dataclass(frozen=True)
class Record:
    seq: int
    ts_ns: int
    flow: int
    a0: int
    a1: int
    status: int
    type: int
    dev: int

    @property
    def type_name(self) -> str:
        return type_name(self.type)


_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is not None:
        return _bound
    lib = native.load()
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    lib.tpurmJournalEmitFlow.argtypes = [u32, u32, u32, u64, u64, u64]
    lib.tpurmJournalEmitFlow.restype = None
    lib.tpurmJournalTypeName.argtypes = [u32]
    lib.tpurmJournalTypeName.restype = ctypes.c_char_p
    lib.tpurmJournalStats.argtypes = [ctypes.POINTER(u64),
                                      ctypes.POINTER(u64),
                                      ctypes.POINTER(u32)]
    lib.tpurmJournalStats.restype = None
    lib.tpurmJournalTypeCount.argtypes = [u32]
    lib.tpurmJournalTypeCount.restype = u64
    lib.tpurmJournalRegionFd.argtypes = []
    lib.tpurmJournalRegionFd.restype = ctypes.c_int
    lib.tpurmJournalHead.argtypes = []
    lib.tpurmJournalHead.restype = u64
    lib.tpurmJournalSubscribe.argtypes = []
    lib.tpurmJournalSubscribe.restype = None
    lib.tpurmJournalUnsubscribe.argtypes = []
    lib.tpurmJournalUnsubscribe.restype = None
    lib.tpurmJournalConsume.argtypes = [ctypes.POINTER(u64),
                                        ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.POINTER(u64)]
    lib.tpurmJournalConsume.restype = ctypes.c_size_t
    lib.tpurmJournalWait.argtypes = [u64, u64]
    lib.tpurmJournalWait.restype = ctypes.c_int
    lib.tpurmJournalCrashDump.argtypes = [ctypes.c_char_p]
    lib.tpurmJournalCrashDump.restype = u32
    lib.tpurmJournalLastBundle.argtypes = [ctypes.c_char_p,
                                           ctypes.c_size_t]
    lib.tpurmJournalLastBundle.restype = ctypes.c_size_t
    lib.tpurmJournalRenderTextBuf.argtypes = [ctypes.c_char_p,
                                              ctypes.c_size_t]
    lib.tpurmJournalRenderTextBuf.restype = ctypes.c_size_t
    _bound = lib
    return lib


def emit(rec_type: RecType, dev: int = 0, status: int = 0, a0: int = 0,
         a1: int = 0, flow: int = 0) -> None:
    """Append one record (the Python engines' emit path; ``flow``
    carries the tpuflow id the scheduler stamped on the request)."""
    _lib().tpurmJournalEmitFlow(int(rec_type), dev, status, a0, a1, flow)


def type_name(rec_type: int) -> str:
    s = _lib().tpurmJournalTypeName(int(rec_type))
    return s.decode() if s else "?"


def stats() -> Tuple[int, int, int]:
    """(records ever emitted, records dropped, ring capacity)."""
    em, dr, cap = (ctypes.c_uint64(), ctypes.c_uint64(),
                   ctypes.c_uint32())
    _lib().tpurmJournalStats(ctypes.byref(em), ctypes.byref(dr),
                             ctypes.byref(cap))
    return em.value, dr.value, cap.value


def type_counts() -> Dict[str, int]:
    """Per-type emit counts keyed by dotted record name."""
    lib = _lib()
    return {type_name(t): lib.tpurmJournalTypeCount(int(t))
            for t in RecType}


def head() -> int:
    return _lib().tpurmJournalHead()


def text() -> str:
    """The journal rendered as text — the exact R/E line format the
    procfs node and the crash bundles use (tools/tpubox.py parses it)."""
    buf = ctypes.create_string_buffer(TEXT_BYTES)
    n = _lib().tpurmJournalRenderTextBuf(buf, TEXT_BYTES)
    return buf.raw[:n].decode(errors="replace")


def crash_dump(reason: str = "manual") -> int:
    """Write a crash bundle now; returns the native TpuStatus (0 OK,
    0x56 NOT_SUPPORTED when TPUMEM_DUMP_DIR is unset)."""
    return _lib().tpurmJournalCrashDump(reason.encode())


def last_bundle() -> Optional[str]:
    buf = ctypes.create_string_buffer(512)
    n = _lib().tpurmJournalLastBundle(buf, 512)
    return buf.raw[:n].decode() if n else None


class Subscriber:
    """Live journal tail over the mmap'd region.

    Dups the journal memfd, maps it shared, and reads the fixed-offset
    header directly; ``consume`` drains committed records through the
    native seqlock-validated copy loop, ``wait`` blocks on the futex
    doorbell (registered via subscribe, so emitters actually wake it).

    Use as a context manager::

        with journal.Subscriber() as sub:
            while sub.wait(timeout_ns=10**9):
                for rec in sub.consume():
                    ...
    """

    def __init__(self) -> None:
        lib = _lib()
        self._fd = lib.tpurmJournalRegionFd()
        if self._fd < 0:
            raise native.RmError(0x56, "journal region not fd-backed")
        size = os.fstat(self._fd).st_size
        self._map = _mmap.mmap(self._fd, size, prot=_mmap.PROT_READ)
        (magic, version, cap, rec_size, widx, _dropped, _db,
         _nsubs) = _HDR.unpack_from(self._map, 0)
        if magic != _MAGIC or rec_size != _REC_BYTES:
            raise native.RmError(0x65, "journal header mismatch")
        self.version = version
        self.cap = cap
        self.cursor = widx          # start at head: tail new records
        self.lost = 0
        lib.tpurmJournalSubscribe()
        self._subscribed = True

    # -- header fields straight off the shared mapping ------------------

    @property
    def head(self) -> int:
        return struct.unpack_from("<Q", self._map, 16)[0]

    @property
    def dropped(self) -> int:
        return struct.unpack_from("<Q", self._map, 24)[0]

    def emitted(self, rec_type: RecType) -> int:
        return struct.unpack_from("<Q", self._map,
                                  40 + 8 * int(rec_type))[0]

    # -- record flow ----------------------------------------------------

    def raw_record(self, idx: int) -> Record:
        """Decode ring slot ``idx & (cap-1)`` straight from the mapping
        (no commit validation — diagnostic peek)."""
        off = _HDR_BYTES + (idx & (self.cap - 1)) * _REC_BYTES
        seq, ts, flow, a0, a1, status, rtype, dev = _REC.unpack_from(
            self._map, off)
        return Record(seq, ts, flow, a0, a1, status, rtype, dev)

    def consume(self, max_records: int = 256) -> List[Record]:
        """Drain committed records past the cursor (seqlock-validated
        by the native copy loop; wrap losses accumulate in ``lost``)."""
        buf = ctypes.create_string_buffer(max_records * _REC_BYTES)
        cur = ctypes.c_uint64(self.cursor)
        lost = ctypes.c_uint64(0)
        n = _lib().tpurmJournalConsume(ctypes.byref(cur),
                                       ctypes.cast(buf, ctypes.c_void_p),
                                       max_records, ctypes.byref(lost))
        self.cursor = cur.value
        self.lost += lost.value
        out = []
        for i in range(n):
            seq, ts, flow, a0, a1, status, rtype, dev = _REC.unpack_from(
                buf, i * _REC_BYTES)
            out.append(Record(seq, ts, flow, a0, a1, status, rtype, dev))
        return out

    def wait(self, timeout_ns: int = 10**9) -> bool:
        """Block on the doorbell futex until the journal advances past
        the cursor; True when there is something to consume."""
        return bool(_lib().tpurmJournalWait(self.cursor, timeout_ns))

    def __iter__(self) -> Iterator[Record]:
        while True:
            batch = self.consume()
            if not batch:
                return
            yield from batch

    def close(self) -> None:
        if getattr(self, "_subscribed", False):
            _lib().tpurmJournalUnsubscribe()
            self._subscribed = False
        if getattr(self, "_map", None) is not None:
            self._map.close()
            self._map = None
        if getattr(self, "_fd", -1) >= 0:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self) -> "Subscriber":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
