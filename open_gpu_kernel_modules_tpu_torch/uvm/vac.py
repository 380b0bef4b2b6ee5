"""tpuvac — health-driven live evacuation of KV records between chips.

The port's copy of the JAX package's ``uvm/vac.py``: the face of
native/src/health.c plus the drain-and-migrate protocol over the multichip
KV pool (``models/multichip.py`` provides the mechanism: staged record
allocation, home-map flips, charge rebinds).

``state`` / ``score`` / ``info`` / ``note`` / ``clear``
    The per-device hysteretic health scorer (HEALTHY -> DEGRADED ->
    EVACUATING); ``note`` feeds synthetic evidence.

``evac_pending`` / ``evac_ack`` / ``request`` / ``pick_target``
    The evacuation rendezvous: the reset watchdog's EVACUATE rung (or an
    operator's planned move through ``request``) posts a request; the
    scheduler polls ``evac_pending`` between decode rounds,
    drains the chip, and ``evac_ack``s inside the grace window.

``migrate_pages``
    The transactional shipping engine: a generation-stamped native manifest
    (tpurmVacBegin) brackets the move; records ship as PEER_COPY ops on a
    ring of their own, in windows of ``window`` records, each window
    dep-joined on its predecessor and reaped before the next (the throttle
    that keeps co-tenant traffic ahead of the migration); every record copy
    sits behind the ``vac.migrate`` inject site with bounded retry (exact
    invariant: site hits == ``vac_inject_retries`` + ``vac_inject_aborts``);
    shipped bytes are CRC-verified against the source before the commit.
    tpurmVacCommit re-validates generation, target liveness and route; ANY
    failure aborts the whole move back to the source, whose records were
    never released.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import utils as _utils
from ..runtime import native
from . import inject as _inject
from . import memring as _memring
from . import shield as _shield

#: Retries of one record's copy while the vac.migrate site fires, before
#: the move aborts.
RETRIES = 3
#: Re-ships of one record whose shipped bytes fail the CRC check, before the
#: move aborts.
RESHIPS = 2


class HealthState(enum.IntEnum):
    """Device health states (health.h TPU_HEALTH_*)."""

    HEALTHY = 0
    DEGRADED = 1
    EVACUATING = 2


class Event(enum.IntEnum):
    """Reportable health events (health.h TPU_HEALTH_EV_*)."""

    RC_RESET = 0
    WD_NUDGE = 1
    LINK_FLAP = 2
    RETRAIN_FAIL = 3
    PAGE_QUARANTINE = 4
    STALE_COMPLETION = 5
    DEADLINE_EXPIRED = 6
    DEVICE_RESET = 7


AUTO_TARGET = 0xFFFFFFFF        # let the engine pick (health.h ~0u)


class _Info(ctypes.Structure):
    _fields_ = [
        ("state", ctypes.c_uint32),
        ("evacPending", ctypes.c_uint32),
        ("score", ctypes.c_uint64),
        ("transitions", ctypes.c_uint64),
        ("lastEventNs", ctypes.c_uint64),
        ("events", ctypes.c_uint64 * len(Event)),
        ("evacTarget", ctypes.c_uint32),
        ("evacReqId", ctypes.c_uint64),
    ]


@dataclasses.dataclass(frozen=True)
class HealthInfo:
    """Snapshot of one device's health (health.h TpuHealthInfo); ``events``
    counts each Event, keyed by its lower-case name."""

    state: HealthState
    score: int
    transitions: int
    events: Dict[str, int]
    evac_pending: bool
    evac_target: int
    evac_req_id: int

_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is not None:
        return _bound
    lib = native.load()
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    lib.tpurmHealthNote.argtypes = [u32, u32]
    lib.tpurmHealthNote.restype = None
    lib.tpurmDeviceHealthState.argtypes = [u32]
    lib.tpurmDeviceHealthState.restype = u32
    lib.tpurmHealthClear.argtypes = [u32]
    lib.tpurmHealthClear.restype = None
    lib.tpurmDeviceHealthScore.argtypes = [u32]
    lib.tpurmDeviceHealthScore.restype = u64
    lib.tpurmHealthInfo.argtypes = [u32, ctypes.POINTER(_Info)]
    lib.tpurmHealthInfo.restype = u32
    lib.tpurmHealthEvacRequestClient.argtypes = [u32, u32]
    lib.tpurmHealthEvacRequestClient.restype = u32
    lib.tpurmHealthEvacPending.argtypes = [u32, ctypes.POINTER(u32),
                                           ctypes.POINTER(u64)]
    lib.tpurmHealthEvacPending.restype = ctypes.c_bool
    lib.tpurmHealthEvacAck.argtypes = [u32, u64, ctypes.c_bool]
    lib.tpurmHealthEvacAck.restype = u32
    lib.tpurmHealthPickTarget.argtypes = [u32, ctypes.POINTER(u32)]
    lib.tpurmHealthPickTarget.restype = u32
    lib.tpurmVacBegin.argtypes = [u32, u32, ctypes.POINTER(u64)]
    lib.tpurmVacBegin.restype = u32
    lib.tpurmVacCommit.argtypes = [u64]
    lib.tpurmVacCommit.restype = u32
    lib.tpurmVacAbort.argtypes = [u64]
    lib.tpurmVacAbort.restype = u32
    lib.tpurmVacActive.argtypes = []
    lib.tpurmVacActive.restype = u32
    lib.tpuCounterAdd.argtypes = [ctypes.c_char_p, u64]
    lib.tpuCounterAdd.restype = None
    _bound = lib
    return lib


def _check(status: int, what: str) -> None:
    if status != 0:
        raise native.RmError(status, what)


def _counter_add(name: str, delta: int = 1) -> None:
    _lib().tpuCounterAdd(name.encode(), delta)


#: Native trace span of the ``vac.migrate`` site: ``_span(site, obj=0,
#: bytes_=0)``, a no-op while tracing is disarmed.
_span = _utils._site_span


# ------------------------------------------------------------- health


def state(dev: int) -> HealthState:
    return HealthState(_lib().tpurmDeviceHealthState(dev))


def note(dev: int, event: Event) -> None:
    """Feed one health event (tests / operator evidence injection)."""
    _lib().tpurmHealthNote(dev, int(event))


def clear(dev: int) -> None:
    _lib().tpurmHealthClear(dev)


def score(dev: int) -> int:
    """The decayed health score (integer points)."""
    return _lib().tpurmDeviceHealthScore(dev)


def info(dev: int) -> HealthInfo:
    raw = _Info()
    _check(_lib().tpurmHealthInfo(dev, ctypes.byref(raw)), "tpurmHealthInfo")
    return HealthInfo(
        state=HealthState(raw.state), score=raw.score,
        transitions=raw.transitions,
        events={e.name.lower(): raw.events[e.value] for e in Event},
        evac_pending=bool(raw.evacPending), evac_target=raw.evacTarget,
        evac_req_id=raw.evacReqId)


# ------------------------------------------------- evacuation rendezvous


def evac_pending(dev: int) -> Optional[Tuple[int, int]]:
    """(target, req_id) when an evacuation of ``dev`` is requested and
    inside its grace window; None otherwise."""
    target, req_id = ctypes.c_uint32(), ctypes.c_uint64()
    if _lib().tpurmHealthEvacPending(dev, ctypes.byref(target),
                                     ctypes.byref(req_id)):
        return target.value, req_id.value
    return None


def evac_ack(dev: int, req_id: int, success: bool) -> None:
    _check(_lib().tpurmHealthEvacAck(dev, req_id, success),
           "tpurmHealthEvacAck")


def request(src: int, target: Optional[int] = None) -> None:
    """Post an operator's planned move of ``src`` (a brokered client's
    request lands in the engine host's rendezvous); ``target=None`` lets the
    engine pick a healthy peer with headroom (AUTO_TARGET)."""
    _check(_lib().tpurmHealthEvacRequestClient(
        src, AUTO_TARGET if target is None else target),
        "tpurmHealthEvacRequest")


def pick_target(src: int) -> Optional[int]:
    """The engine's choice of evacuation target (healthy peer with HBM
    headroom, nearest first); None when no viable target exists."""
    out = ctypes.c_uint32()
    if _lib().tpurmHealthPickTarget(src, ctypes.byref(out)) != 0:
        return None
    return out.value


# ---------------------------------------------------- vac transactions


class VacTxn:
    """Generation-stamped migration manifest (health.h tpurmVac*)."""

    def __init__(self, src: int, dst: int):
        self.src, self.dst = src, dst
        txn = ctypes.c_uint64()
        _check(_lib().tpurmVacBegin(src, dst, ctypes.byref(txn)),
               "tpurmVacBegin")
        self._txn = txn.value

    def commit(self) -> None:
        """Validate and close the manifest.  Raises (and LEAVES THE
        TRANSACTION OPEN: call abort) when the device generation moved
        under the migration, the target died, or the fabric
        partitioned."""
        _check(_lib().tpurmVacCommit(self._txn), "tpurmVacCommit")
        self._txn = 0

    def abort(self) -> None:
        if self._txn:
            _lib().tpurmVacAbort(self._txn)
            self._txn = 0


class VacAbort(Exception):
    """A migration aborted back to the source (zero corruption: the source
    records were never released)."""


@dataclasses.dataclass
class MigrationReport:
    src: int
    dst: int
    pages: int
    bytes_moved: int
    ship_s: float
    retries: int
    committed: bool


def migrate_pages(backing, src: int, dst: int,
                  pages: Optional[Sequence[int]] = None,
                  window: int = 4,
                  flow: Optional[int] = None) -> MigrationReport:
    """Transactionally re-home ``pages`` (default: everything homed on
    ``src``) from ``src`` to ``dst`` over an ``IciPoolBacking``.

    The caller must have made the backing authoritative for those pages
    first (the scheduler preempts and flushes the owning sequences: the
    drain half of drain-and-migrate).  On ANY failure (inject-site
    exhaustion, copy error, CRC mismatch past its re-ships, manifest
    rejection) every staged target record is freed, the native transaction
    aborts, and :class:`VacAbort` (or the engine's RmError) raises; the
    source mapping was never touched.

    ``flow`` attributes the shipping windows to an EXISTING flow (a serving
    request's: tpusplit charges the request that caused the ship) instead of
    minting the 0xFFFF infrastructure sentinel; the caller owns that flow's
    lifecycle."""
    pages = backing.pages_homed(src, pages)
    t0 = time.perf_counter()
    rec_bytes = backing.record_bytes
    if not pages:
        return MigrationReport(src, dst, 0, 0, 0.0, 0, True)

    span = _span("vac.migrate", obj=(src << 32) | dst,
                 bytes_=len(pages) * rec_bytes)
    # The shipping ring comes FIRST: a ring-create failure before the
    # manifest exists leaves nothing to clean up, whereas the reverse order
    # would leak the transaction open.
    ring = _memring.MemRing(None, entries=max(64, 2 * window))
    try:
        txn = VacTxn(src, dst)
    except BaseException:
        ring.close()
        raise
    # The migration is one flow (sentinel tenant 0xFFFF, request id = the
    # manifest token); each dep-joined window bumps the flow's HOP field.
    owns_flow = flow is None
    if owns_flow:
        flow = _utils.flow_mint(0xFFFF, txn._txn & 0xFFFFFFFF)
        _utils.flow_open(flow)
    # The native engine journals the manifest lifecycle off thread-local
    # flow context.
    _utils.flow_set(flow)
    staged: List[Tuple[int, int, ctypes.c_void_p]] = []  # (page, off, h)
    total_retries = 0
    try:
        with span:
            for page in pages:
                off, handle = backing.stage_rehome(page, dst)
                staged.append((page, off, handle))

            # Dep-joined windows: every record of window N+1 carries an
            # ORDERED dep on window N's last seq, so the manifest lands in
            # order while at most `window` records are in flight.
            prev_join = None
            in_flight = 0
            for i, (page, off, _handle) in enumerate(staged):
                src_off = int(backing.home_offset[page])
                # vac.migrate inject site: bounded retry per record, then
                # transactional abort.  Every hit is either a
                # vac_inject_retries or the one vac_inject_aborts.
                attempt = 0
                while _inject.should_fail(_inject.Site.VAC_MIGRATE):
                    if attempt >= RETRIES:
                        _counter_add("vac_inject_aborts")
                        raise VacAbort(
                            f"vac.migrate inject exhausted {RETRIES} "
                            f"retries shipping page {page}")
                    attempt += 1
                    total_retries += 1
                    _counter_add("vac_inject_retries")
                    time.sleep(0.0002 * (1 << min(attempt, 6)))
                deps = ([_memring.dep(ring.ring_id, prev_join,
                                      ordered=True)]
                        if prev_join is not None else None)
                ring.peer_copy(src, dst, src_off, off, rec_bytes,
                               deps=deps,
                               flow=flow | ((i // window) & 0xFFFF))
                in_flight += 1
                if in_flight >= window or i + 1 == len(staged):
                    prev_join = ring.last_seq
                    ring.submit_and_wait(None)
                    ring.completions(max_cqes=4 * window, check=True)
                    in_flight = 0

            # Wire verification: a CRC32C sealed at the SOURCE, checked on
            # the SHIPPED bytes after one mem.corrupt evaluation; a mismatch
            # re-ships the record from the intact source, bounded.
            for page, off, _handle in staged:
                src_off = int(backing.home_offset[page])
                seal = _shield.crc32c(backing.record_raw(src, src_off))
                b = backing.record_raw(dst, off)
                scope = (src << 32) | dst
                _counter_add("vac_crc_verifies")
                _shield.inject_wire(b, scope)
                reshipped = 0
                while not _shield.verify_wire(b, seal, scope):
                    _counter_add("vac_crc_mismatches")
                    if reshipped >= RESHIPS:
                        raise VacAbort(
                            f"page {page} CRC mismatch persisted after "
                            f"{reshipped} re-ships (src {src} -> dst {dst})")
                    reshipped += 1
                    _counter_add("vac_crc_reships")
                    ring.peer_copy(src, dst, src_off, off, rec_bytes,
                                   flow=flow)
                    ring.submit_and_wait(None)
                    ring.completions(max_cqes=8, check=True)
                    b = backing.record_raw(dst, off)

            # The manifest decides: generation moved / target lost / route
            # gone all reject here, and the source stays the only truth.
            try:
                txn.commit()
            except native.RmError as e:
                raise VacAbort(
                    f"manifest rejected: {e} (aborting to source)") from e

            for page, off, handle in staged:
                backing.commit_rehome(page, dst, off, handle)
            staged = []
            _counter_add("vac_pages_moved", len(pages))
            _counter_add("vac_bytes_moved", len(pages) * rec_bytes)
    except BaseException:
        for _page, _off, handle in staged:
            backing.abort_rehome(dst, handle)
        txn.abort()
        raise
    finally:
        _utils.flow_set(0)
        if owns_flow:
            _utils.flow_close(flow)
        ring.close()
    return MigrationReport(src, dst, len(pages), len(pages) * rec_bytes,
                           time.perf_counter() - t0, total_retries, True)


def txns_active() -> int:
    """Open migration manifests."""
    return _lib().tpurmVacActive()
