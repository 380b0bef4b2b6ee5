"""Tracing, metrics and request-flow surface of the native engine.

The port's own copy of the JAX package's ``utils/__init__.py``, with the
same names:

- diagnostics (native/src/diag.c, procfs.c): the journal text ring
  (``journal_dump``), named counters, registry knobs as the engine reads
  them (``registry_get``), and the procfs nodes (``procfs_read``,
  ``procfs_list``, ``metrics_text``, the Prometheus exposition).  Beside
  the engine's named counters the port keeps its own layers' counters
  (``port_counter_add``), read by ``counter`` and rendered by
  ``metrics_text`` as samples of the same ``tpurm_counter`` family;
- tputrace (native/src/trace.c): arm, disarm and clear the span rings,
  emit an application span under any name (``span``, site ``app.span``),
  read a site's latency histogram (count and quantiles), the ring
  accounting, and the Chrome trace-event JSON export (as text, parsed, or
  saved to a file).  The rings stamp ``CLOCK_MONOTONIC``; the parsed export
  carries two clock anchors (``CLOCK_ANCHORS``), so that its events can be
  set on another timeline, such as ``torch.profiler``'s Unix-epoch one;
- tpuflow (native/src/flow.c): mint flow ids (tenant << 48 | request <<
  16), open and close per-request blame ledgers, charge blame buckets, set
  the calling thread's flow context, feed and read the per-tenant TTFT and
  inter-token-latency histograms, and the top-K slow-flow report;

All of it is process-wide state in the native library, but for the port's
own counters, which are process-wide state of this module.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .runtime import native

#: Blame buckets, in native TPU_FLOW_B_* order (tpurm/flow.h).
FLOW_BUCKETS = ("queued", "preempted", "fault", "copy", "ici", "reset")

#: SLO histogram kinds, in native TPU_SLO_* order.
SLO_KINDS = ("ttft", "itl")

#: Buffer sizes for the trace export (its least: the buffer grows with the
#: records the rings hold, ``TRACE_EVENT_BYTES`` each, so that no export is
#: cut), the metrics exposition, the journal text ring, a procfs node, the
#: procfs listing and the slow-flow report.
TRACE_EXPORT_BYTES = 16 << 20
#: Export bytes a record may take (the native exporter's reserve for a span
#: event and its flow event), and those of the document's head and tail.
TRACE_EVENT_BYTES = 512
TRACE_EXPORT_TAIL = 1024
METRICS_BYTES = 1 << 20
JOURNAL_BYTES = 1 << 16
PROCFS_BYTES = 1 << 16
PROCFS_LIST_BYTES = 4096
FLOW_REPORT_MAX = 64

_bound = None

#: Key of ``trace_export()``'s clock anchors: {"armed": [mono_ns, real_ns],
#: "exported": [mono_ns, real_ns]}, each a ``clock_anchor()`` taken when
#: tracing was last armed and when the export was read ("armed" is None if
#: this process never armed it).  A span's ``ts`` (µs of CLOCK_MONOTONIC)
#: maps onto CLOCK_REALTIME by linear interpolation between the two.
CLOCK_ANCHORS = "clockAnchors"
_armed_anchor: Optional[Tuple[int, int]] = None

#: Trace site name -> id (trace.h TpuTraceSite order, read from the native
#: table so the two cannot drift).
_TRACE_SITES: Dict[str, int] = {}


class _FlowRec(ctypes.Structure):
    """tpurm/flow.h TpuFlowRec."""

    _fields_ = [("flow", ctypes.c_uint64),
                ("tenant", ctypes.c_uint32),
                ("state", ctypes.c_uint32),
                ("openNs", ctypes.c_uint64),
                ("wallNs", ctypes.c_uint64),
                ("tokens", ctypes.c_uint64),
                ("bucketNs", ctypes.c_uint64 * len(FLOW_BUCKETS))]


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is not None:
        return _bound
    # The loader declares the journal, procfs, counter and trace calls.
    lib = native.load()
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    for name in ("tpurmTraceStart", "tpurmTraceStop", "tpurmTraceReset"):
        getattr(lib, name).restype = None
    lib.tpurmTraceBegin.argtypes = []
    lib.tpurmTraceBegin.restype = u64
    lib.tpurmTraceEnd.argtypes = [u32, u64, u64, u64]
    lib.tpurmTraceEnd.restype = None
    lib.tpurmTraceNowNs.argtypes = []
    lib.tpurmTraceNowNs.restype = u64
    lib.tpurmTraceAppSpan.argtypes = [ctypes.c_char_p, u64, u64, u64]
    lib.tpurmTraceAppSpan.restype = None
    lib.tpurmFlowMint.argtypes = [u32, u32]
    lib.tpurmFlowMint.restype = u64
    lib.tpurmFlowOpen.argtypes = [u64]
    lib.tpurmFlowOpen.restype = u32
    lib.tpurmFlowAccount.argtypes = [u64, u32, u64]
    lib.tpurmFlowAccount.restype = None
    lib.tpurmFlowTokens.argtypes = [u64, u64]
    lib.tpurmFlowTokens.restype = None
    lib.tpurmFlowClose.argtypes = [u64, ctypes.POINTER(u64)]
    lib.tpurmFlowClose.restype = u32
    lib.tpurmFlowResetAll.argtypes = []
    lib.tpurmFlowResetAll.restype = None
    lib.tpurmFlowReport.argtypes = [ctypes.c_void_p, u32]
    lib.tpurmFlowReport.restype = u32
    lib.tpurmSloRecordN.argtypes = [u32, u32, u64, u64]
    lib.tpurmSloRecordN.restype = None
    lib.tpurmSloQuantileNs.argtypes = [u32, u32, ctypes.c_double]
    lib.tpurmSloQuantileNs.restype = u64
    lib.tpurmSloCount.argtypes = [u32, u32]
    lib.tpurmSloCount.restype = u64
    lib.tpurmSloBlameNs.argtypes = [u32, u32]
    lib.tpurmSloBlameNs.restype = u64
    lib.tpurmTraceFlowSet.argtypes = [u64]
    lib.tpurmTraceFlowSet.restype = None
    lib.tpurmTraceFlowGet.argtypes = []
    lib.tpurmTraceFlowGet.restype = u64
    _bound = lib
    return lib


def _read(fn, *args, size: int) -> str:
    """Text that a native render call writes into a buffer of ``size``
    bytes."""
    buf = ctypes.create_string_buffer(size)
    n = fn(*args, buf, size)
    return buf.raw[:n].decode(errors="replace")


# -------------------------------------------------------------- diagnostics

def journal_dump() -> List[str]:
    """The native journal's text ring, one line per entry."""
    return [line for line in _read(_lib().tpurmJournalDump,
                                   size=JOURNAL_BYTES).splitlines()
            if line]


#: Counters of the port's own layers (the tier's ``tputier_*`` in
#: ``models.serving``): kept here, not in the engine's registry, which is
#: one per process and shared with the JAX package when both are loaded,
#: so that its exposition lists only the names the engine and the JAX
#: package register.
_port_counters: Dict[str, int] = {}
_port_lock = threading.Lock()


def port_counter_add(name: str, delta: int = 1) -> None:
    """Add to one of the port's own monotonic counters."""
    with _port_lock:
        _port_counters[name] = _port_counters.get(name, 0) + delta


def counter(name: str) -> int:
    """Monotonic named counter: the port's own, else the engine's."""
    if name in _port_counters:
        return _port_counters[name]
    return _lib().tpurmCounterGet(name.encode())


def counters(names) -> Dict[str, int]:
    return {n: counter(n) for n in names}


def registry_get(key: str, default: Optional[int] = None) -> Optional[int]:
    """A registry knob read as the native engine reads it: the environment
    variable ``TPUMEM_<KEY>`` (decimal or 0x hex); ``default`` when it is
    unset or not a number."""
    raw = os.environ.get("TPUMEM_" + key.upper())
    if raw is None:
        return default
    try:
        return int(raw, 0)
    except ValueError:
        return default


def procfs_read(path: str) -> str:
    """Render a procfs node (/proc/driver/tpurm/..., also the reference's
    /proc/driver/nvidia* spellings); empty for unknown or debug-gated
    nodes."""
    return _read(_lib().tpurmProcfsRead, path.encode(), size=PROCFS_BYTES)


def procfs_list() -> List[str]:
    return [p for p in _read(_lib().tpurmProcfsList,
                             size=PROCFS_LIST_BYTES).splitlines() if p]


# ------------------------------------------------------------------ tracing

def _trace_site(name: str) -> int:
    """A registered trace site's id by name ("sched.round",
    "fault.latency", ...)."""
    if not _TRACE_SITES:
        lib = _lib()
        i = 0
        while True:
            s = lib.tpurmTraceSiteName(i)
            if s is None:
                break
            _TRACE_SITES[s.decode()] = i
            i += 1
    return _TRACE_SITES[name]


class span:
    """An application span in the trace rings (site ``app.span``, exported
    under ``name``, at most 23 characters), with an object id and a byte
    count, which the body may set before the span closes::

        with utils.span("tokenize") as sp:
            sp.nbytes = len(blob)
            ...

    The start is ``tpurmTraceBegin``'s: while tracing is disarmed a span
    costs that one relaxed load, reads no clock and emits nothing.  Before
    the port has loaded the engine it costs nothing and loads nothing."""

    def __init__(self, name: str, obj: int = 0, nbytes: int = 0):
        self._name = name.encode()
        self.obj = obj
        self.nbytes = nbytes
        self._t0 = 0

    def __enter__(self) -> "span":
        self._t0 = _lib().tpurmTraceBegin() if native.loaded() else 0
        return self

    def __exit__(self, *exc) -> None:
        if self._t0:
            _lib().tpurmTraceAppSpan(self._name, self._t0, self.obj,
                                     self.nbytes)


class _site_span:
    """A span of a registered engine site (``sched.round``,
    ``vac.migrate``, ...), with an object id and a byte count; a no-op while
    tracing is disarmed (tpurmTraceBegin's relaxed-load fast path).  The
    Scheduler's and vac's ``_span`` helpers are this class."""

    def __init__(self, site: str, obj: int = 0, bytes_: int = 0):
        self._site = _trace_site(site)
        self._obj = obj
        self.bytes = bytes_

    def __enter__(self) -> "_site_span":
        self._t0 = _lib().tpurmTraceBegin()
        return self

    def __exit__(self, *exc) -> None:
        _lib().tpurmTraceEnd(self._site, self._t0, self._obj, self.bytes)


def clock_anchor() -> Tuple[int, int]:
    """(CLOCK_MONOTONIC, CLOCK_REALTIME) ns at one moment: of five realtime
    reads, each between two monotonic ones, the one whose monotonic pair
    lies closest, with their midpoint."""
    best = None
    for _ in range(5):
        a = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        real = time.clock_gettime_ns(time.CLOCK_REALTIME)
        b = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, real)
    return best[1], best[2]


def trace_start() -> None:
    """Arm tracing (every engine site starts emitting spans) and take the
    export's first clock anchor."""
    global _armed_anchor
    _lib().tpurmTraceStart()
    _armed_anchor = clock_anchor()


def trace_stop() -> None:
    _lib().tpurmTraceStop()


def trace_reset() -> None:
    """Clear rings, drop accounting and site histograms."""
    _lib().tpurmTraceReset()


def trace_armed() -> bool:
    return bool(_lib().tpurmTraceIsArmed())


def _site_id(site) -> int:
    return _trace_site(site) if isinstance(site, str) else int(site)


def trace_hist_count(site) -> int:
    """Samples in a site's latency histogram (``site``: name or id)."""
    return _lib().tpurmTraceHistCountNs(_site_id(site))


def trace_quantile_ns(site, q: float) -> int:
    """Latency quantile ``q`` from a site's log-linear histogram (about 1%
    relative error); ``site`` is a name ("fault.latency", ...) or an id.
    0 when the histogram is empty."""
    return _lib().tpurmTraceHistQuantileNs(_site_id(site), float(q))


def trace_stats() -> Dict[str, int]:
    """Ring accounting: records emitted, records lost, live rings."""
    rec, drop, rings = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint32()
    _lib().tpurmTraceStats(ctypes.byref(rec), ctypes.byref(drop),
                           ctypes.byref(rings))
    return {"recorded": rec.value, "dropped": drop.value,
            "rings": rings.value}


def trace_export_json() -> str:
    """The Chrome trace-event JSON (Perfetto, chrome://tracing), in a
    buffer sized for every record the rings hold (``trace_stats()``)."""
    st = trace_stats()
    held = max(st["recorded"] - st["dropped"], 0)
    size = max(TRACE_EXPORT_BYTES,
               held * TRACE_EVENT_BYTES + TRACE_EXPORT_TAIL)
    return _read(_lib().tpurmTraceExportJson, size=size)


def trace_export() -> dict:
    """The Chrome trace-event export, parsed: {"traceEvents": [...]}, and
    under ``CLOCK_ANCHORS`` the clock anchors taken when tracing was armed
    and now."""
    doc = json.loads(trace_export_json())
    doc[CLOCK_ANCHORS] = {
        "armed": list(_armed_anchor) if _armed_anchor else None,
        "exported": list(clock_anchor())}
    return doc


def trace_save(path: str) -> str:
    """Write the JSON export to ``path``; returns ``path``."""
    text = trace_export_json()
    with open(path, "w") as f:
        f.write(text)
    return path


def metrics_text() -> str:
    """The Prometheus exposition (/proc/driver/tpurm/metrics body), with
    the port's own counters after the engine's ``tpurm_counter`` samples."""
    text = _read(_lib().tpurmProcfsRead, b"/proc/driver/tpurm/metrics",
                 size=METRICS_BYTES)
    with _port_lock:
        own = [f'tpurm_counter{{name="{n}"}} {v}'
               for n, v in sorted(_port_counters.items())]
    if not own:
        return text
    lines = text.splitlines()
    at = lines.index("# TYPE tpurm_counter counter") + 1
    while at < len(lines) and lines[at].startswith("tpurm_counter{"):
        at += 1
    return "\n".join(lines[:at] + own + lines[at:]) + "\n"


# ------------------------------------------------------------------ tpuflow

def _bucket_idx(bucket) -> int:
    return FLOW_BUCKETS.index(bucket) if isinstance(bucket, str) \
        else int(bucket)


def _kind_idx(kind) -> int:
    return SLO_KINDS.index(kind) if isinstance(kind, str) else int(kind)


def flow_mint(tenant: int, request: int) -> int:
    """Mint a hop-0 flow id (tenant << 48 | request << 16)."""
    return _lib().tpurmFlowMint(tenant, request)


def flow_open(flow: int) -> None:
    _lib().tpurmFlowOpen(flow)


def flow_set(flow: int) -> None:
    """Set the calling thread's flow context: spans it emits and CPU faults
    it takes now carry the request identity (0 clears it)."""
    _lib().tpurmTraceFlowSet(flow)


def flow_get() -> int:
    """The calling thread's flow context (0: none)."""
    return _lib().tpurmTraceFlowGet()


def flow_account(flow: int, bucket, ns: int) -> None:
    """Accumulate ``ns`` into a blame bucket (name or index)."""
    if ns > 0:
        _lib().tpurmFlowAccount(flow, _bucket_idx(bucket), ns)


def flow_tokens(flow: int, tokens: int = 1) -> None:
    _lib().tpurmFlowTokens(flow, tokens)


def flow_close(flow: int) -> int:
    """Close the flow's ledger; returns its wall time in ns."""
    wall = ctypes.c_uint64()
    _lib().tpurmFlowClose(flow, ctypes.byref(wall))
    return wall.value


def flow_reset() -> None:
    """Clear the flow table, SLO histograms and blame counters."""
    _lib().tpurmFlowResetAll()


def flow_report(max_flows: int = FLOW_REPORT_MAX) -> List[Dict]:
    """Top-K slow flows (K = ``max_flows``), most-blamed first: one dict
    per flow with the ledger fields and a per-bucket blame map (ns)."""
    buf = (_FlowRec * max_flows)()
    n = _lib().tpurmFlowReport(ctypes.cast(buf, ctypes.c_void_p),
                               max_flows)
    return [{"flow": r.flow,
             "tenant": r.tenant,
             "request": (r.flow >> 16) & 0xFFFFFFFF,
             "state": "closed" if r.state == 2 else "open",
             "wall_ns": r.wallNs,
             "tokens": r.tokens,
             "blame_ns": {b: r.bucketNs[i]
                          for i, b in enumerate(FLOW_BUCKETS)}}
            for r in buf[:n]]


def slo_record(tenant: int, kind, ns: int, count: int = 1) -> None:
    """Feed the per-tenant SLO histogram ("ttft" / "itl")."""
    _lib().tpurmSloRecordN(tenant, _kind_idx(kind), ns, count)


def slo_quantile_ns(tenant: int, kind, q: float) -> int:
    return _lib().tpurmSloQuantileNs(tenant, _kind_idx(kind), float(q))


def slo_count(tenant: int, kind) -> int:
    return _lib().tpurmSloCount(tenant, _kind_idx(kind))


def slo_blame_ns(tenant: int, bucket) -> int:
    return _lib().tpurmSloBlameNs(tenant, _bucket_idx(bucket))
