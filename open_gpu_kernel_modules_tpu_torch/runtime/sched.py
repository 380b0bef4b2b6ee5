"""tpusched — multi-tenant continuous-batching serving scheduler.

Port of the JAX package's ``runtime/sched.py``: the policy layer that turns
the tiered KV cache into a *server*.  Many concurrent request streams share
one oversubscribed :class:`~..models.serving.TieredKVCache`, Orca-style
(iteration-level scheduling: the decode batch re-forms EVERY round from
the currently runnable sequences), with vLLM-style paged admission (a
request is admitted only when its projected page need fits the device slot
pool).

Shape of the loop (one :meth:`Scheduler.step` = one decode round):

  retire    — sequences that hit their token budget leave the batch and
              free their device pages IMMEDIATELY (cold-end LRU reinsert,
              ``TieredKVCache.release_sequence``), so the next admission
              reclaims them before anything warm.
  admit     — restores first (preempted sequences re-enter via ONE batched
              memring PREFETCH submission that warms their backing pages),
              then queued requests in arrival order, each gated on
              projected page need vs. free device pages and on its tenant's
              scheduler page quota.  The whole pass sits behind the
              ``sched.admit`` inject site with bounded retry; exhaustion
              DEGRADES TO PREEMPT (load shed), never an error.
  preempt   — when the runnable set's projected pages outgrow the slot pool
              (decode grew the sequences), victims are chosen SLO-aware —
              over-quota tenants first, then lowest priority, then coldest,
              then largest resident footprint — flushed to the backing, and
              parked; their seq slot (and so their backing pages) stays
              reserved for the restore.
  decode    — one ``decode_scan`` for the whole batch (padded to a power of
              two by repeating row 0, so the paged-decode kernel's split
              plan and the cuBLAS shapes stay fixed within a bucket), host
              length arithmetic, one readback of the round's tokens,
              per-token latency sampled per stream.

``configure_tenant`` also programs the tenant's priority into the native
tenant table, which governs arena eviction for VA spaces bound to a
tenant; the cache's single shared backing space stays on the default
tenant, its QoS enforced here.

Observability: ``sched.round`` / ``sched.admit`` / ``sched.preempt`` trace
spans on the engine's sites and the ``sched.readback`` application span
around the round's token readback, where the host waits on the card (arm
with ``utils.trace_start()``); within a round, serving's ``serve.*`` and
``tier.*`` spans (``models.serving``), those of an admission under the
request's flow id.  ``tpusched_*`` counters in the Prometheus exposition,
and tpuflow: every request mints a flow id that rides the memring ops its
pages travel on; the scheduler charges the queued, preempted and reset
blame buckets and feeds the per-tenant TTFT and inter-token-latency
histograms.

Over a multichip cache (``models.multichip``: pages homed on several device
arenas, moved over ICI) two more branches run: chip EVACUATION
(``evacuate_device``, and the poll at the top of every round that serves
the reset watchdog's EVACUATE requests) drains the streams owning pages of a
chip and re-homes those pages with a vac transaction; and prefill/decode
DISAGGREGATION (``disagg=tpusplit.DisaggConfig``) ships each admitted
stream's KV to a decode chip after its prefill and reclaims a slot's records
before the next stream prefills into it.  A managed backing
(``ManagedKVBacking``, the default) restores preempted streams through a
fused evict/prefetch submission on a tier ring and probes poisoned pages; a
multichip one restores through the plain activation, as in JAX.

The streams are SIMULATED (prompts in, greedy tokens out).  The decode runs
on ``device`` (the CUDA card unless the caller passes ``device="cpu"``, or
the device of the ``cache`` the caller passes); prompts and tokens stay
numpy on the host.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import utils as _utils
from ..device import DeviceLike, resolve
from ..models import llama, multichip, serving
from ..uvm import hot as _hot
from ..uvm import inject as _inject
from ..uvm import journal as _journal
from ..uvm import managed as _managed
from ..uvm import memring as _memring
from ..uvm import reset as _reset
from ..uvm import shield as _shield
from ..uvm import vac as _vac
from . import native
from . import tpusplit as _tpusplit

# --------------------------------------------------------------- plumbing

def _counter_add(name: str, delta: int = 1) -> None:
    native.load().tpuCounterAdd(name.encode(), delta)


#: Round budget of :meth:`Scheduler.run`.
MAX_ROUNDS = 100000

#: Native trace span of a ``sched.*`` site: ``_span(site, obj=0)``, a no-op
#: while tracing is disarmed.
_span = _utils._site_span


def _pad_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# ----------------------------------------------------------------- model


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    #: Poison containment: a KV page of THIS stream was poisoned (silent
    #: corruption detected with no recovery source) — the stream retires
    #: terminal-with-error and its sequence slot retires with it (the
    #: poisoned backing pages must never serve a new stream).
    ERROR = "error"


@dataclasses.dataclass
class Request:
    """One simulated stream: a prompt and a token budget."""

    rid: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int
    tenant: int = 0
    state: RequestState = RequestState.QUEUED
    seq: Optional[int] = None       # cache sequence slot while admitted
    decoded: int = 0                # tokens decoded so far (rounded up
                                    # to round granularity internally)
    tokens: Optional[np.ndarray] = None   # [max_new_tokens] on finish
    preempts: int = 0
    flow: int = 0                   # tpuflow id, minted at submission
    _chunks: List[np.ndarray] = dataclasses.field(default_factory=list)
    _token_lat_s: List[float] = dataclasses.field(default_factory=list)
    _submit_ns: int = 0             # queue entry (monotonic ns)
    _last_emit_ns: int = 0          # last token emission
    _park_ns: int = 0               # preempt park start (0 = running)
    _park_reset: bool = False       # park caused by a device reset
    _queued_charged: bool = False   # queued wait accounted (1st admit)

    @property
    def token_latencies_s(self) -> List[float]:
        """Per-token decode latency samples (round wall time amortized over
        the round's tokens; stalls between a stream's rounds show in
        aggregate throughput and in the ITL histogram, not here)."""
        return self._token_lat_s


@dataclasses.dataclass
class SchedTenant:
    """Scheduler-level QoS identity: preemption priority (higher =
    preempted later) and a device slot-pool page quota (0 = unlimited)."""

    tenant: int
    priority: int = 100
    device_page_quota: int = 0


class Scheduler:
    """Continuous-batching engine over a :class:`TieredKVCache`.

    ``max_seqs`` bounds concurrent admitted sequences (the cache's
    sequence-slot dimension); the device slot pool holds
    ``max_seqs * pages_per_seq / oversub`` pages, so at oversub > 1 the
    admitted set can outgrow device residency — that pressure drives
    preemption, and the backing (UVM managed memory, preferred CXL, or the
    multichip ICI pool) is where preempted sequences park.  ``device`` holds
    the slot pool and runs the decode (``device.resolve``: the CUDA card by
    default).  ``cache`` serves over a cache the caller made (a multichip
    one, ``models.multichip.make_multichip_cache``) instead of a new
    managed one; the shape arguments are then the cache's, and so is the
    device.  ``disagg`` (a ``tpusplit.DisaggConfig``) needs a multichip
    cache.  ``blame_tokens`` records, for every emitted token gap, its
    stall-inclusive ITL and the blame that landed in it (``token_blame``).
    """

    def __init__(self, cfg: llama.LlamaConfig, params,
                 max_seqs: int = 8, max_len: int = 512,
                 page_size: int = 64, oversub: int = 1,
                 tokens_per_round: int = 8,
                 admit_retries: int = 3,
                 cache: Optional[serving.TieredKVCache] = None,
                 blame_tokens: bool = False,
                 disagg: Optional[_tpusplit.DisaggConfig] = None,
                 device: DeviceLike = None):
        if cache is None:
            cache = serving.TieredKVCache(
                cfg, batch=max_seqs, max_len=max_len, page_size=page_size,
                oversub=oversub, device=resolve(device))
        elif device is not None and resolve(device) != cache.device:
            raise ValueError(f"device {device} is not the cache's device "
                             f"({cache.device})")
        self.cfg = cfg
        self.params = params
        self.tokens_per_round = tokens_per_round
        self.admit_retries = admit_retries
        # Device-generation watch: a bump between rounds means a full
        # device reset ran under the scheduler — see _check_generation.
        self._gen = _reset.generation()
        self.cache = cache
        # The backing's kind, decided once: a managed backing gets the tier
        # ring, the fused evict/prefetch restore, the poison probe and the
        # flow_of_page hook; a multichip one gets chip evacuation, tenant
        # charges per arena and disaggregation.
        backing = cache.backing
        self._managed = isinstance(backing, serving.ManagedKVBacking)
        self._multichip = isinstance(backing, multichip.IciPoolBacking)
        self.max_seqs = self.cache.batch
        self.max_len = self.cache.pages_per_seq * self.cache.page_size

        self._free_seqs: List[int] = list(range(self.max_seqs))
        # Fused evict+upload batches: _preempt stages the victim's backing
        # spans here; the next _restore publishes them ahead of its
        # dep-joined PREFETCHes on the dedicated tier ring, and step()
        # flushes any leftovers at round end.
        self._pending_evicts: List[tuple] = []
        self._tier_ring = None
        self._tier_ring_tried = False
        self._queue: List[Request] = []
        self._running: Dict[int, Request] = {}     # seq -> request
        self._preempted: List[Request] = []
        self._by_rid: Dict[int, Request] = {}
        self._next_rid = 1
        self._cur_tok = np.zeros((self.max_seqs,), np.int32)
        self.tenants: Dict[int, SchedTenant] = {
            0: SchedTenant(tenant=0)}
        self.stats = {"admitted": 0, "retired": 0, "preempted": 0,
                      "restored": 0, "rounds": 0, "cancelled": 0,
                      "admit_retries": 0, "admit_sheds": 0,
                      "round_errors": 0, "decoded_tokens": 0,
                      "device_resets_observed": 0,
                      "evacuations": 0, "evac_aborts": 0,
                      "evac_pages_moved": 0}
        # Per-evacuation blackout windows (park -> manifest commit), in s.
        self.evac_blackouts_s: List[float] = []
        # tpuflow: per-page flow resolution for the managed backing's
        # batched fault pass (read_pages stamps each page's prefetch SQEs
        # with its owning request's flow).
        if self._managed:
            backing.flow_of_page = self._flow_of_page
        # Per-token blame capture (the bench's "where did the p99 token's
        # milliseconds go"): one flow_report and a dict diff per round.
        self._blame_tokens = blame_tokens
        self.token_blame: List[Dict] = []
        self._blame_snap: Dict[int, Dict[str, int]] = {}
        # tpusplit: each admitted stream prefills against
        # disagg.prefill_dev, then its slot's records SHIP (a vac
        # transaction riding the request's flow) to its decode home.
        self._disagg = disagg
        if disagg is not None:
            if not self._multichip:
                raise ValueError(
                    "disagg needs a multichip backing "
                    "(models.multichip.IciPoolBacking)")
            bad = [d for d in (disagg.prefill_dev,) +
                   tuple(disagg.decode_devs) if d >= backing.n_devices]
            if bad:
                raise ValueError(f"disagg devices {bad} out of range "
                                 f"(pool has {backing.n_devices})")
            for k in ("disagg_ships", "disagg_ship_aborts",
                      "disagg_reclaims", "disagg_pages_shipped"):
                self.stats[k] = 0
        # Per-ship-leg wall times (vac MigrationReport.ship_s), and the
        # slot -> decode home map (deterministic; an EVACUATION of a decode
        # chip rewrites the entries it moved).
        self.disagg_ship_s: List[float] = []
        self._disagg_home: Dict[int, int] = {}

    # ------------------------------------------------------------ tenants

    def configure_tenant(self, tenant: int, priority: int = 100,
                         device_page_quota: int = 0) -> None:
        """Register a tenant at BOTH policy layers: the scheduler's
        slot-pool quota/priority here, and its priority in the native
        tenant table (managed.tenant_configure).  The native table governs
        VA spaces bound to a tenant; the shared slot pool's QoS is enforced
        here (admission deferral + SLO-ordered preemption)."""
        self.tenants[tenant] = SchedTenant(tenant, priority,
                                           device_page_quota)
        _managed.tenant_configure(tenant, priority=priority)

    def _tenant(self, tid: int) -> SchedTenant:
        return self.tenants.get(tid) or self.tenants[0]

    # ---------------------------------------------------------- tpuflow

    def _flow_of_page(self, page: int) -> int:
        """Flow id owning a backing page (slot-pool layout: seq-major), 0
        when the page's slot has no running request."""
        req = self._running.get(page // self.cache.pages_per_seq)
        return req.flow if req is not None else 0

    def _park_account(self, req: Request) -> None:
        """Close a preemption park window: charge preempted (or reset when
        a device reset caused the park).  The window runs from the preempt
        to the stream's NEXT TOKEN, restore warm-up and re-dispatch wait
        included."""
        if not req._park_ns:
            return
        ns = time.monotonic_ns() - req._park_ns
        bucket = "reset" if req._park_reset else "preempted"
        if req.flow:
            _utils.flow_account(req.flow, bucket, ns)
        req._park_ns = 0
        req._park_reset = False

    # ------------------------------------------------------------ intake

    def submit(self, prompt, max_new_tokens: int,
               tenant: int = 0) -> Request:
        """Enqueue one stream.  Admission happens inside step()."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        need = prompt.size + self._round_up(max_new_tokens)
        if need > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) rounded to {need} exceeds max_len "
                f"({self.max_len})")
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, tenant=tenant)
        req._submit_ns = time.monotonic_ns()
        # The ledger opens at SUBMIT: its wall covers the queued wait, so a
        # closed flow's bucket sum stays within wall by construction.
        req.flow = _utils.flow_mint(tenant, self._next_rid)
        _utils.flow_open(req.flow)
        self._next_rid += 1
        self._by_rid[req.rid] = req
        self._queue.append(req)
        _counter_add("tpusched_submitted")
        return req

    def cancel(self, rid: int) -> bool:
        """Cancel a stream in any live state; frees its pages at once.
        ERROR is terminal too: a poison-retired stream already gave up its
        (retired) slot and closed its ledger."""
        req = self._by_rid.get(rid)
        if req is None or req.state in (RequestState.FINISHED,
                                        RequestState.CANCELLED,
                                        RequestState.ERROR):
            return False
        if req.state is RequestState.QUEUED:
            self._queue.remove(req)
        elif req.state is RequestState.RUNNING:
            del self._running[req.seq]
            self._park_account(req)
            self.cache.release_sequence(req.seq)
            self._free_seqs.append(req.seq)
            req.seq = None
        elif req.state is RequestState.PREEMPTED:
            self._preempted.remove(req)
            self._park_account(req)
            self.cache.release_sequence(req.seq)
            self._free_seqs.append(req.seq)
            req.seq = None
        req.state = RequestState.CANCELLED
        if req.flow:
            _utils.flow_close(req.flow)
        self.stats["cancelled"] += 1
        _counter_add("tpusched_cancelled")
        return True

    # ------------------------------------------------------- projections

    def _round_up(self, tokens: int) -> int:
        r = self.tokens_per_round
        return (tokens + r - 1) // r * r

    def _pages_for(self, length: int) -> int:
        P = self.cache.page_size
        return max(1, min(self.cache.pages_per_seq,
                          (min(length, self.max_len) + P - 1) // P))

    def _seq_pages(self, req: Request) -> int:
        """Projected device pages req needs for ONE more round (the cache's
        covered-working-set walker is the single source of truth)."""
        return len(self.cache.pages_of(req.seq, self.tokens_per_round))

    def _projected_pages(self, extra: int = 0) -> int:
        return sum(self._seq_pages(r) for r in self._running.values()) \
            + extra

    def _tenant_pages(self, tid: int) -> int:
        return sum(self._seq_pages(r) for r in self._running.values()
                   if r.tenant == tid)

    def free_device_pages(self) -> int:
        """Slot-pool headroom the admission gate checks against."""
        return self.cache.n_slots - self._projected_pages()

    # -------------------------------------------------------- preemption

    def _seq_coldness(self, req: Request) -> float:
        """Coldness for the victim choice: the cache-level activation heat
        of the sequence's covered pages PLUS, on a managed backing, the
        native tracker's decayed score over its backing span.  Lower =
        colder."""
        heat = self.cache.seq_heat(req.seq)
        if not self._managed:
            return heat
        backing = self.cache.backing
        off = req.seq * self.cache.pages_per_seq * backing.rec_bytes
        span = self._seq_pages(req) * backing.rec_bytes
        # /1024: the native score is <<10 fixed-point per page touch.
        return heat + _hot.span_score(backing.k_buf.address + off,
                                      span) / 1024.0

    def _pick_victim(self) -> Optional[Request]:
        """SLO ordering, mirroring the native arena walk: over-quota
        tenants first, then lowest priority, then COLDEST, then largest
        footprint as the final tie-break (frees the most pages)."""
        best = None
        best_key = None
        for req in self._running.values():
            t = self._tenant(req.tenant)
            over = bool(t.device_page_quota and
                        self._tenant_pages(req.tenant) >
                        t.device_page_quota)
            key = (0 if over else 1, t.priority,
                   round(self._seq_coldness(req), 3),
                   -self._seq_pages(req))
            if best is None or key < best_key:
                best, best_key = req, key
        return best

    def _tier_ring_get(self):
        """Dedicated ring for the fused EVICT->PREFETCH submissions (the
        backing's read ring must stay quiesced between read_pages
        passes)."""
        if self._tier_ring is None and not self._tier_ring_tried:
            self._tier_ring_tried = True
            try:
                self._tier_ring = _memring.MemRing(self.cache.backing.vs,
                                                   entries=256)
            except native.RmError:
                self._tier_ring = None
        return self._tier_ring

    def _stage_evicts(self, req: Request) -> None:
        """Record the preempted victim's backing spans for a fused demote:
        clearing their device-side residency frees arena pages exactly
        where the next restore uploads (managed backing only)."""
        if not self._managed:
            return
        backing = self.cache.backing
        first = req.seq * self.cache.pages_per_seq
        npages = self._pages_for(int(self.cache.seq_lens[req.seq]))
        span = npages * backing.rec_bytes
        off = first * backing.rec_bytes
        self._pending_evicts.append((backing.k_buf.address + off, span,
                                     req.flow))
        self._pending_evicts.append((backing.v_buf.address + off, span,
                                     req.flow))

    def _flush_evicts(self, ring) -> None:
        """Publish leftover staged evicts (no restore fused them).
        Best-effort: a failed demote only costs the engine's own pressure
        path its head start."""
        evicts, self._pending_evicts = self._pending_evicts, []
        if not evicts or ring is None:
            return
        try:
            for addr, span, fl in evicts:
                if ring.sq_space < 1:
                    ring.submit_and_wait(None)
                    ring.completions(max_cqes=8192)
                ring.evict(addr, span, _managed.Tier.CXL, flow=fl)
            ring.submit_and_wait(None)
            ring.completions(max_cqes=8192)
        except native.RmError:
            self._quiesce_ring(ring)
            _counter_add("tpusched_evict_errors")

    def _preempt(self, req: Request, reset: bool = False) -> None:
        """Swap a sequence out: dirty pages flush to the backing (the seq
        keeps its slot index, i.e. its backing pages), device slots free,
        the request parks until a restore fits.  Its backing spans are
        STAGED for the next restore's fused demote.  ``reset=True`` charges
        the park to the flow's reset bucket, not preempted."""
        _utils.flow_set(req.flow)
        try:
            with _span("sched.preempt", obj=req.rid):
                # _cur_tok holds the stream's truth (updated every round);
                # only the KV pages need persisting.
                self.cache.flush_group([req.seq])
                self.cache.release_sequence(req.seq, keep_len=True)
                self._stage_evicts(req)
        finally:
            _utils.flow_set(0)
        del self._running[req.seq]
        req.state = RequestState.PREEMPTED
        req.preempts += 1
        # Keep the EARLIEST park start across restore->re-preempt ping-pong
        # (one blackout from the stream's view); reset taint is sticky.
        if req._park_ns == 0:
            req._park_ns = time.monotonic_ns()
        req._park_reset = req._park_reset or reset
        self._preempted.append(req)
        self.stats["preempted"] += 1
        _counter_add("tpusched_preempted")
        _journal.emit(_journal.RecType.SCHED_PREEMPT, a0=req.seq or 0,
                      a1=req.preempts, flow=req.flow or 0)

    @staticmethod
    def _quiesce_ring(ring) -> None:
        """Drain + reap everything on ``ring`` tolerantly: leftover SQEs or
        CQEs would skew later passes' completion accounting."""
        if ring is None:
            return
        try:
            ring.submit_and_wait(None)
        except native.RmError:
            pass
        ring.completions(max_cqes=8192)

    @staticmethod
    def _check_prefetch_cqes(cqes) -> None:
        """Raise on a failed PREFETCH completion only: the evict half of a
        fused submission is best-effort by contract."""
        for c in cqes:
            if not c.ok and c.opcode == _memring.Op.PREFETCH:
                raise native.RmError(
                    c.status, f"restore prefetch user_data={c.user_data}")

    def _restore(self, req: Request) -> None:
        """Re-admit a preempted sequence.  ONE batched memring submission of
        fused work — staged victim EVICTs ahead of this sequence's
        PREFETCHes, each prefetch carrying an ordered dep on the last evict
        — frees the victims' device residency right where the restore
        uploads.  Runs on the dedicated tier ring; falls back to the
        backing ring, then to plain activation faulting, which is how a
        multichip backing restores (the activation reads its pages)."""
        backing = self.cache.backing
        ring = ((self._tier_ring_get() or backing.ring) if self._managed
                else None)
        # The park window stays OPEN through the restore: it closes at the
        # stream's next token emission (step) or cancel.
        try:
            self._restore_prefetch(backing, ring, req)
        except native.RmError:
            # The warm-up is an optimization: a failed PREFETCH just means
            # the activation faults the pages itself — UNLESS the failure
            # is a poisoned page of THIS stream, which retires here instead
            # of faulting into the same poison forever.
            self._quiesce_ring(ring)
            if self._seq_poisoned(req):
                self._retire_poisoned(req)
                return
            self.stats["round_errors"] += 1
            _counter_add("tpusched_round_errors")
        self._running[req.seq] = req
        req.state = RequestState.RUNNING
        self._preempted.remove(req)
        self.stats["restored"] += 1
        _counter_add("tpusched_restored")

    def _restore_prefetch(self, backing, ring, req: Request) -> None:
        if ring is None:
            return
        m = self.cache.pages_per_seq
        first_page = req.seq * m
        pages = range(first_page, first_page + self._pages_for(
            int(self.cache.seq_lens[req.seq])))
        # Staged victim demotes go down as INDEPENDENT evict ops; every
        # restore prefetch carries ONE ordered dep on the last demote's seq,
        # satisfied once all demotes retired.  A failed demote cancels
        # nothing (ordered deps never cancel).  A restore of the sequence
        # that was just preempted drops its own staged spans instead of
        # demoting data it is about to fault straight back.
        own_lo = first_page * backing.rec_bytes
        own_hi = (req.seq + 1) * m * backing.rec_bytes
        own = (backing.k_buf.address, backing.v_buf.address)
        evicts, self._pending_evicts = self._pending_evicts, []
        kept = [(a, s, f) for a, s, f in evicts
                if not any(base + own_lo <= a < base + own_hi
                           for base in own)]
        if kept:
            _counter_add("tpusched_fused_evict_chains")
        evict_join = None
        for addr, span, fl in kept:
            if ring.sq_space < 1:
                ring.submit_and_wait(None)
                self._check_prefetch_cqes(ring.completions(max_cqes=8192))
            # Demotes charge the VICTIM's flow (its bytes moving).
            ring.evict(addr, span, _managed.Tier.CXL, flow=fl)
            evict_join = ring.last_seq
        deps = ([_memring.dep(ring.ring_id, evict_join, ordered=True)]
                if evict_join is not None else None)
        for page in pages:
            off = page * backing.rec_bytes
            for base in own:
                if ring.sq_space < 1:
                    ring.submit_and_wait(None)
                    self._check_prefetch_cqes(ring.completions(
                        max_cqes=8192))
                ring.prefetch(base + off, backing.rec_bytes,
                              dev=backing.dev, deps=deps, flow=req.flow)
        ring.submit_and_wait(None)
        self._check_prefetch_cqes(ring.completions(max_cqes=8192))

    # ------------------------------------------------ tpusplit disagg

    def _slot_pages(self, seq: int) -> List[int]:
        m = self.cache.pages_per_seq
        return list(range(seq * m, (seq + 1) * m))

    def _disagg_reclaim(self, req: Request) -> None:
        """Bring the slot's records back to the prefill chip before the new
        stream prefills into it.  Best-effort: on abort the prefill's KV
        writes still reach a remote home over ICI — the reclaim buys
        locality, never correctness."""
        if self._disagg is None:
            return
        backing = self.cache.backing
        d = self._disagg
        pages = [p for p in self._slot_pages(req.seq)
                 if int(backing.home[p]) != d.prefill_dev]
        if not pages:
            return
        try:
            _tpusplit.reclaim_kv(backing, pages, d.prefill_dev,
                                 flow=req.flow, window=d.window)
            self.stats["disagg_reclaims"] += 1
        except (_vac.VacAbort, native.RmError, RuntimeError):
            pass

    def _disagg_ship(self, req: Request) -> None:
        """Ship the freshly prefilled slot to the stream's decode home
        (flushed first: the ship moves the KV truth).  The vac transaction
        rides the REQUEST's flow.  On abort the stream decodes CO-LOCATED
        from wherever its pages are — token-exact, only the placement
        degrades."""
        if self._disagg is None:
            return
        d = self._disagg
        home = self._disagg_home.get(req.seq, d.home_of(req.seq))
        self.cache.flush_group([req.seq])
        try:
            reps = _tpusplit.ship_kv(self.cache.backing,
                                     self._slot_pages(req.seq), home,
                                     flow=req.flow, window=d.window)
        except (_vac.VacAbort, native.RmError, RuntimeError):
            self.stats["disagg_ship_aborts"] += 1
            _counter_add("tpusplit_ship_aborts")
            return
        self._disagg_home[req.seq] = home
        self.stats["disagg_ships"] += 1
        self.stats["disagg_pages_shipped"] += sum(r.pages for r in reps)
        self.disagg_ship_s.extend(_tpusplit.ship_latencies_s(reps))

    # --------------------------------------------------------- admission

    def _admit_gate(self) -> bool:
        """The sched.admit inject site: bounded retry, then
        degrade-to-preempt — a failed gate sheds load (skips this round's
        admissions, preempting one victim under real pressure) instead of
        erroring the serving loop."""
        for attempt in range(self.admit_retries + 1):
            if not _inject.should_fail(_inject.Site.SCHED_ADMIT):
                return True
            if attempt < self.admit_retries:
                self.stats["admit_retries"] += 1
                _counter_add("tpusched_admit_retries")
                time.sleep(0.0005 * (1 << attempt))
        self.stats["admit_sheds"] += 1
        _counter_add("tpusched_admit_sheds")
        _journal.emit(_journal.RecType.SCHED_SHED,
                      a0=len(self._preempted) + len(self._queue))
        # Degrade-to-preempt only under REAL pressure: someone is waiting
        # AND the pool cannot fit them.
        waiting = self._preempted + self._queue
        if waiting and len(self._running) > 1:
            first = waiting[0]
            need = self._pages_for(
                (int(self.cache.seq_lens[first.seq]) if first.seq is not
                 None else first.prompt.size) + self.tokens_per_round)
            if self._projected_pages(extra=need) > self.cache.n_slots:
                victim = self._pick_victim()
                if victim is not None:
                    self._preempt(victim)
        return False

    def _admit_one(self, req: Request) -> bool:
        seq = self._free_seqs.pop(0)
        req.seq = seq
        self.cache.seq_lens[seq] = 0
        # Charge the queued wait at FIRST admission (the flow opened at
        # submit).  The per-request sched.admit span runs under the flow
        # context: it is the Perfetto flow START the worker spans end.
        now_ns = time.monotonic_ns()
        if not req._queued_charged:
            req._queued_charged = True
            queued = now_ns - req._submit_ns if req._submit_ns else 0
            _utils.flow_account(req.flow, "queued", queued)
        if self._multichip:
            # The slot's pages now charge to this tenant's per-device
            # columns (tpuvac rebinds them on migration).
            for page in self._slot_pages(seq):
                self.cache.backing.set_page_tenant(page, req.tenant)
        # tpusplit: records the slot's PREVIOUS stream parked on a decode
        # chip come home before prefill writes KV into them.
        self._disagg_reclaim(req)
        try:
            _utils.flow_set(req.flow)
            with _span("sched.admit", obj=req.rid):
                serving.prefill_group(
                    self.cfg, self.params, self.cache, [seq],
                    torch.as_tensor(req.prompt[None, :],
                                    device=self.cache.device))
        except native.RmError:
            # Transient backing fault past the engine's bounded retries:
            # the activation rolled itself back — requeue at the head and
            # let a later round retry.  A slot whose own backing span holds
            # a poisoned page (a flip in the KV this prefill just parked)
            # would fail every later admission: it is retired, as a
            # poisoned stream's slot is, and the stream, whose prompt is
            # intact, waits for another.
            poisoned = self._seq_poisoned(req)
            try:
                self.cache.release_sequence(seq)
            except native.RmError:
                if not poisoned:
                    raise
            if poisoned:
                self._retire_free_slot(seq)
            else:
                self._free_seqs.append(seq)
            req.seq = None
            self.stats["round_errors"] += 1
            _counter_add("tpusched_round_errors")
            return False
        finally:
            _utils.flow_set(0)
        # tpusplit: ship the prefilled slot to its decode home (or decode
        # co-located on abort).
        self._disagg_ship(req)
        self._cur_tok[seq] = self.cache.last_token[seq]
        self._running[seq] = req
        req.state = RequestState.RUNNING
        self.stats["admitted"] += 1
        _counter_add("tpusched_admitted")
        return True

    def _try_admissions(self) -> None:
        with _span("sched.admit"):
            if (self._preempted or self._queue) and not self._admit_gate():
                return
            # Restores outrank fresh admissions (they were admitted first);
            # higher priority first, then oldest request.
            for req in sorted(self._preempted,
                              key=lambda r:
                              (-self._tenant(r.tenant).priority, r.rid)):
                need = self._pages_for(int(self.cache.seq_lens[req.seq]) +
                                       self.tokens_per_round)
                if self._projected_pages(extra=need) > self.cache.n_slots:
                    break
                self._restore(req)
            # Fresh admissions in arrival order, gated on projected page
            # need vs free device pages and the tenant quota.
            admitted_any = True
            while self._queue and self._free_seqs and admitted_any:
                admitted_any = False
                for req in list(self._queue):
                    if not self._free_seqs:
                        break
                    need = self._pages_for(req.prompt.size +
                                           self.tokens_per_round)
                    if self._projected_pages(extra=need) > \
                            self.cache.n_slots:
                        continue
                    t = self._tenant(req.tenant)
                    if t.device_page_quota and \
                            self._tenant_pages(req.tenant) + need > \
                            t.device_page_quota:
                        continue      # tenant at quota: stays queued
                    self._queue.remove(req)
                    if self._admit_one(req):
                        admitted_any = True
                    else:
                        self._queue.insert(0, req)
                        return

    # ------------------------------------------------------------ rounds

    def _retire(self, req: Request) -> None:
        toks = (np.concatenate(req._chunks) if req._chunks
                else np.zeros((0,), np.int32))
        req.tokens = toks[:req.max_new_tokens]
        req.state = RequestState.FINISHED
        if req.flow:
            _utils.flow_close(req.flow)
        # Finished sequences free their pages IMMEDIATELY: cold-end LRU
        # reinsert means the next activation reclaims them first.
        self.cache.release_sequence(req.seq)
        del self._running[req.seq]
        self._free_seqs.append(req.seq)
        req.seq = None
        self.stats["retired"] += 1
        _counter_add("tpusched_retired")

    # ------------------------------------------------------- poison

    def _seq_poisoned(self, req: Request) -> bool:
        """Containment probe: does this stream's managed backing span hold
        a poisoned page?"""
        if req.seq is None or not self._managed:
            return False
        backing = self.cache.backing
        off = req.seq * self.cache.pages_per_seq * backing.rec_bytes
        span = self.cache.pages_per_seq * backing.rec_bytes
        return any(_shield.span_poisoned(base + off, span)
                   for base in (backing.k_buf.address,
                                backing.v_buf.address))

    def _retire_poisoned(self, req: Request) -> None:
        """Retire ONE stream on a poisoned page: terminal-with-error, its
        sequence slot retired with it (never freed, so the poisoned backing
        span never serves a new stream), flow ledger closed.  Everything
        else keeps decoding; no reset."""
        req.state = RequestState.ERROR
        flow0 = req.flow or 0
        if req.flow:
            _utils.flow_close(req.flow)
            req.flow = None         # close() must not re-close the ledger
        seq = req.seq
        if seq is not None:
            try:
                self.cache.release_sequence(seq)
            except native.RmError:
                pass             # the poison itself may trip the drain
            self._running.pop(seq, None)
            if req in self._preempted:
                self._preempted.remove(req)
            req.seq = None
        self.stats["poisoned"] = self.stats.get("poisoned", 0) + 1
        _counter_add("tpusched_poisoned_retired")
        _journal.emit(_journal.RecType.SCHED_RETIRE,
                      status=_shield.PAGE_POISONED,
                      a0=seq if seq is not None else 0, flow=flow0)
        _counter_add("tpusched_seq_slots_retired")

    def _retire_free_slot(self, seq: int) -> None:
        """Retire a sequence slot whose backing span is poisoned before any
        stream holds it: never freed again."""
        self.stats["free_slots_retired"] = \
            self.stats.get("free_slots_retired", 0) + 1
        _journal.emit(_journal.RecType.SCHED_RETIRE,
                      status=_shield.PAGE_POISONED, a0=seq)

    def _fail_unservable(self) -> None:
        """Every sequence slot is retired on a poisoned page: nothing can
        serve the queue any more, so its streams end terminal-with-error
        instead of waiting forever."""
        if not self._queue or self._free_seqs or self._running or \
                self._preempted:
            return
        for req in self._queue:
            req.state = RequestState.ERROR
            if req.flow:
                _utils.flow_close(req.flow)
                req.flow = None
            self.stats["unservable"] = self.stats.get("unservable", 0) + 1
        self._queue.clear()

    def _handle_poisoned_round(self) -> bool:
        """A round failed with PAGE_POISONED: retire exactly the owning
        stream(s).  True when at least one was identified."""
        victims = [r for r in list(self._running.values()) +
                   list(self._preempted) if self._seq_poisoned(r)]
        for r in victims:
            self._retire_poisoned(r)
        return bool(victims)

    def _check_generation(self) -> None:
        """Full-device reset detection: the native engine saved device
        residency to the host backing and restored it, but the scheduler's
        own slot pool sits ABOVE the arenas, so every running sequence is
        preempted (its dirty pages flush to the preserved backing) and
        restored from the backing over the next rounds — token-exact by
        the preempt/restore bit-identity guarantee."""
        gen = _reset.generation()
        if gen == self._gen:
            return
        self._gen = gen
        self.stats["device_resets_observed"] += 1
        _counter_add("tpusched_device_resets")
        for seq in list(self._running):
            req = self._running.get(seq)
            if req is not None:
                self._preempt(req, reset=True)

    # ------------------------------------------------------- evacuation

    def evacuate_device(self, src: int, dst: Optional[int] = None,
                        tenant: Optional[int] = None
                        ) -> Optional[_vac.MigrationReport]:
        """Drain-and-migrate: move the KV records homed on chip ``src`` to
        ``dst`` (``None``: the engine's pick) while co-tenants keep
        decoding.

        DRAIN: every RUNNING sequence owning an affected page is preempted
        (dirty slots flush, victim-ring entries materialize: the backing
        becomes authoritative for the moving pages).  MIGRATE:
        vac.migrate_pages, whose home maps flip only after the manifest
        commits.  The parked sequences restore over the next rounds from
        the new home, token-exact.

        On abort the source was never touched: this returns None and the
        parked sequences resume ON THE SOURCE.  ``tenant`` restricts the
        move to one tenant's sequences.  Returns the vac.MigrationReport, or
        None when the move aborted or nothing was homed on ``src``."""
        if not self._multichip:
            raise ValueError("evacuation needs a multichip backing "
                             "(models.multichip.IciPoolBacking)")
        backing = self.cache.backing
        if dst is None:
            dst = _vac.pick_target(src)
            if dst is None:
                raise RuntimeError(
                    f"no viable evacuation target for device {src} "
                    f"(no healthy peer with HBM headroom)")
        cand = None
        if tenant is not None:
            seqs = [r.seq for r in list(self._running.values()) +
                    self._preempted
                    if r.tenant == tenant and r.seq is not None]
            cand = [p for s in seqs for p in self._slot_pages(s)]
        pages = backing.pages_homed(src, cand)
        if not pages:
            return None

        t0 = time.perf_counter()
        m = self.cache.pages_per_seq
        affected = {p // m for p in pages}
        for seq, req in list(self._running.items()):
            if seq in affected:
                self._preempt(req)
        try:
            rep = _vac.migrate_pages(backing, src, dst, pages)
        except (_vac.VacAbort, native.RmError, RuntimeError):
            # VacAbort is the protocol's own abort; RmError/RuntimeError
            # cover target-side allocation exhaustion and a PEER_COPY error
            # CQE.  The source mapping was never touched, so the parked
            # sequences restore from it as after a plain preemption.
            self.stats["evac_aborts"] += 1
            _counter_add("tpusched_evac_aborts")
            return None
        self.evac_blackouts_s.append(time.perf_counter() - t0)
        self.stats["evacuations"] += 1
        self.stats["evac_pages_moved"] += rep.pages
        _counter_add("tpusched_evacuations")
        # tpusplit: an evacuated decode chip's streams now live on the
        # target; later ships and reclaims follow the pages.
        if self._disagg is not None:
            for s in affected:
                if self._disagg_home.get(s) == src:
                    self._disagg_home[s] = dst
        return rep

    def _check_evacuation(self) -> None:
        """Poll the native evacuation rendezvous: the watchdog's EVACUATE
        rung (or an operator) posted a request for some chip — serve it
        inside the grace window and ack, or ack failure so the ladder can
        escalate.  Other backings ignore requests (they hold no per-chip
        pages; the request expires to the ladder)."""
        if not self._multichip:
            return
        backing = self.cache.backing
        for dev in range(backing.n_devices):
            pending = _vac.evac_pending(dev)
            if pending is None:
                continue
            target, req_id = pending
            try:
                rep = self.evacuate_device(
                    dev, None if target == _vac.AUTO_TARGET else target)
                # None with nothing homed there: nothing to move.
                ok = rep is not None or not backing.pages_homed(dev)
            except (native.RmError, RuntimeError, ValueError):
                ok = False
            try:
                _vac.evac_ack(dev, req_id, ok)
            except native.RmError:
                pass             # request expired under us: ladder owns it

    def step(self) -> Dict[str, int]:
        """One scheduling round: admit/restore, fit-check (preempting
        SLO-ordered victims if decode growth outgrew the pool), ONE batched
        decode, retire.  Returns live counts."""
        with _span("sched.round", obj=self.stats["rounds"]):
            self._check_generation()
            self._check_evacuation()
            self._try_admissions()
            self._fail_unservable()
            # Evicts staged by preempts fuse into the next restore's
            # submission; once no restore can consume them, publish them
            # on their own (tier ring only).
            if self._pending_evicts and not (self._queue or
                                             self._preempted):
                self._flush_evicts(self._tier_ring_get())
            # Decode growth can push the runnable set past the slot pool:
            # preempt until the round fits (never below one).
            while (self._running and
                   self._projected_pages() > self.cache.n_slots and
                   len(self._running) > 1):
                victim = self._pick_victim()
                if victim is None:
                    break
                self._preempt(victim)
            if not self._running:
                return self.live_counts()

            ids = sorted(self._running)
            tpr = self.tokens_per_round
            t0 = time.perf_counter()
            try:
                view = self.cache.activate(ids, new_tokens=tpr)
            except native.RmError as e:
                # Poison containment: retire exactly the owning stream(s)
                # and keep decoding everyone else.
                if (e.status == _shield.PAGE_POISONED and
                        self._handle_poisoned_round()):
                    return self.live_counts()
                # Backing fault past the engine's bounded retries: the
                # activation rolled back, so the round simply retries.
                self.stats["round_errors"] += 1
                _counter_add("tpusched_round_errors")
                return self.live_counts()
            # Pad the batch to a power of two by REPEATING row 0: the
            # duplicate decodes identical tokens and writes identical bytes
            # to the same slots, and the batch shapes stay fixed per bucket.
            pad = _pad_pow2(len(ids))
            toks_in = self._cur_tok[np.array(ids)]
            if pad != len(ids):
                reps = pad - len(ids)
                view = dataclasses.replace(
                    view,
                    page_table=torch.cat(
                        [view.page_table,
                         view.page_table[:1].expand(reps, -1)]),
                    seq_lens=torch.cat(
                        [view.seq_lens, view.seq_lens[:1].expand(reps)]))
                toks_in = np.concatenate(
                    [toks_in, np.repeat(toks_in[:1], reps)])
            _, view, toks = serving.decode_scan(
                self.cfg, self.params,
                torch.as_tensor(toks_in, device=self.cache.device), view,
                tpr)
            # The round's one readback: [tpr, B] tokens.
            with _utils.span("sched.readback", obj=len(ids)):
                toks = toks[:, :len(ids)].cpu().numpy().astype(np.int32)
            self.cache.sync_from(view, ids, decoded=tpr)
            dt = time.perf_counter() - t0

            per_tok = dt / tpr
            emit_ns = time.monotonic_ns()
            per_tok_ns = max(int(per_tok * 1e9), 1)
            # Close park windows at the stream's first token after them.
            for seq in ids:
                self._park_account(self._running[seq])
            blame_now = None
            if self._blame_tokens:
                blame_now = {f["flow"]: f["blame_ns"]
                             for f in _utils.flow_report(256)}
            for i, seq in enumerate(ids):
                req = self._running[seq]
                req._chunks.append(toks[:, i])
                req._token_lat_s.extend([per_tok] * tpr)
                # Per-tenant SLO feed: TTFT once, on the stream's first
                # token; ITL once per token — the round's tokens at the
                # amortized latency, except the round's FIRST token, whose
                # sample is the stall-inclusive gap since the stream's
                # previous emission.  itl_count(tenant) == tokens decoded.
                if req.decoded == 0 and req._submit_ns:
                    _utils.slo_record(req.tenant, "ttft",
                                      emit_ns - req._submit_ns)
                base_ns = req._last_emit_ns or req._submit_ns or emit_ns
                gap_ns = max(emit_ns - base_ns, tpr * per_tok_ns)
                if req._last_emit_ns:
                    stall_itl = max(gap_ns - (tpr - 1) * per_tok_ns,
                                    per_tok_ns)
                else:
                    stall_itl = per_tok_ns
                _utils.slo_record(req.tenant, "itl", stall_itl)
                if tpr > 1:
                    _utils.slo_record(req.tenant, "itl", per_tok_ns,
                                      tpr - 1)
                req._last_emit_ns = emit_ns
                if req.flow:
                    _utils.flow_tokens(req.flow, tpr)
                if blame_now is not None:
                    # The native ledger is the one blame source: the gap's
                    # breakdown is its delta since the stream's previous
                    # emission.
                    key = req.flow & ~0xFFFF
                    cur = blame_now.get(key, {})
                    prev = self._blame_snap.get(key, {})
                    gap = {b: cur.get(b, 0) - prev.get(b, 0) for b in cur
                           if cur.get(b, 0) > prev.get(b, 0)}
                    self._blame_snap[key] = dict(cur)
                    if len(self.token_blame) < 100000:
                        # blame_ns sums the buckets charged inside the
                        # stall-inclusive window gap_ns.
                        self.token_blame.append({
                            "rid": req.rid, "tenant": req.tenant,
                            "round": self.stats["rounds"],
                            "itl_ns": stall_itl, "gap_ns": gap_ns,
                            "blame_ns": gap,
                        })
                req.decoded += tpr
                self._cur_tok[seq] = toks[-1, i]
            self.stats["rounds"] += 1
            self.stats["decoded_tokens"] += tpr * len(ids)
            _counter_add("tpusched_rounds")
            _counter_add("tpusched_decoded_tokens", tpr * len(ids))

            for seq in list(ids):
                req = self._running.get(seq)
                if req is not None and req.decoded >= req.max_new_tokens:
                    self._retire(req)
        return self.live_counts()

    def live_counts(self) -> Dict[str, int]:
        return {"queued": len(self._queue),
                "running": len(self._running),
                "preempted": len(self._preempted)}

    @property
    def idle(self) -> bool:
        return not (self._queue or self._running or self._preempted)

    def run(self) -> Dict[str, float]:
        """Drive until every submitted stream finished (or MAX_ROUNDS
        rounds ran); returns the serving report."""
        t0 = time.perf_counter()
        rounds = 0
        while not self.idle and rounds < MAX_ROUNDS:
            before = self.stats["decoded_tokens"]
            self.step()
            rounds += 1
            if (self.stats["decoded_tokens"] == before and
                    not self._running and
                    (self._queue or self._preempted)):
                # Nothing ran and nothing could admit (e.g. a shed storm):
                # spin-guard so an armed inject site cannot livelock us.
                time.sleep(0.001)
        wall = time.perf_counter() - t0
        return self.report(wall)

    def report(self, wall_s: float) -> Dict[str, float]:
        lats = [s for r in self._by_rid.values()
                for s in r._token_lat_s]
        finished = [r for r in self._by_rid.values()
                    if r.state is RequestState.FINISHED]
        out = {
            "streams": len(self._by_rid),
            "finished": len(finished),
            "wall_s": round(wall_s, 3),
            "agg_toks_per_s": round(
                sum(min(r.decoded, r.max_new_tokens)
                    for r in finished) / wall_s, 2) if wall_s else 0.0,
            "p50_token_ms": round(
                1e3 * float(np.percentile(lats, 50)), 3) if lats else 0.0,
            "p99_token_ms": round(
                1e3 * float(np.percentile(lats, 99)), 3) if lats else 0.0,
        }
        out.update(self.stats)
        # Per-tenant SLO summary from the native histograms (process-wide:
        # callers isolate runs with utils.flow_reset).
        slo = {}
        q = _utils.slo_quantile_ns
        for t in sorted({r.tenant for r in self._by_rid.values()}):
            n_itl = _utils.slo_count(t, "itl")
            if n_itl == 0 and _utils.slo_count(t, "ttft") == 0:
                continue
            slo[str(t)] = {
                "ttft_ms_p50": round(q(t, "ttft", 0.50) / 1e6, 3),
                "ttft_ms_p99": round(q(t, "ttft", 0.99) / 1e6, 3),
                "itl_ms_p50": round(q(t, "itl", 0.50) / 1e6, 3),
                "itl_ms_p99": round(q(t, "itl", 0.99) / 1e6, 3),
                "tokens": int(n_itl),
                "blame_ms": {b: round(_utils.slo_blame_ns(t, b) / 1e6, 3)
                             for b in _utils.FLOW_BUCKETS},
            }
        out["slo"] = slo
        return out

    # ---------------------------------------------------------- teardown

    def close(self) -> None:
        # Close the ledgers of non-terminal streams: the flow table
        # recycles CLOSED slots only.
        for req in self._by_rid.values():
            if req.flow and req.state not in (RequestState.FINISHED,
                                              RequestState.CANCELLED):
                self._park_account(req)
                _utils.flow_close(req.flow)
        # The tier ring must go before the cache (it is bound to the
        # backing's VA space).
        if self._tier_ring is not None:
            self._tier_ring.close()
            self._tier_ring = None
        if self.cache is not None:
            self.cache.close()
            self.cache = None

    def __enter__(self) -> "Scheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
