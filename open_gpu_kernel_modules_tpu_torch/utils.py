"""Tracing, metrics and request-flow surface of the native engine.

The port's copy of the part of the JAX package's ``utils/__init__.py`` that
the scheduler and its tests use, with the same names:

- tputrace (native/src/trace.c): arm, disarm and clear the span rings,
  emit a span of a named site (``span``), read a site's latency histogram
  count, export the Chrome trace-event JSON, and the Prometheus exposition
  (``metrics_text``);
- tpuflow (native/src/flow.c): mint flow ids (tenant << 48 | request <<
  16), open and close per-request blame ledgers, charge blame buckets, set
  the calling thread's flow context, feed and read the per-tenant TTFT and
  inter-token-latency histograms, and the top-K slow-flow report;
- ``counter``: one monotonic named engine counter (vac, tpusplit, ...).

All of it is process-wide state in the native library.
"""

from __future__ import annotations

import ctypes
import json
from typing import Dict, List

from .runtime import native

#: Blame buckets, in native TPU_FLOW_B_* order (tpurm/flow.h).
FLOW_BUCKETS = ("queued", "preempted", "fault", "copy", "ici", "reset")

#: SLO histogram kinds, in native TPU_SLO_* order.
SLO_KINDS = ("ttft", "itl")

#: Buffer sizes for the trace export, the metrics exposition and the
#: slow-flow report.
TRACE_EXPORT_BYTES = 16 << 20
METRICS_BYTES = 1 << 20
FLOW_REPORT_MAX = 64

_bound = None

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
    lib = native.load()
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    cp, sz = ctypes.c_char_p, ctypes.c_size_t
    for name in ("tpurmTraceStart", "tpurmTraceStop", "tpurmTraceReset"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = None
    lib.tpurmTraceExportJson.argtypes = [cp, sz]
    lib.tpurmTraceExportJson.restype = sz
    lib.tpurmTraceHistCountNs.argtypes = [u32]
    lib.tpurmTraceHistCountNs.restype = u64
    lib.tpurmTraceSiteName.argtypes = [u32]
    lib.tpurmTraceSiteName.restype = cp
    lib.tpurmTraceBegin.argtypes = []
    lib.tpurmTraceBegin.restype = u64
    lib.tpurmTraceEnd.argtypes = [u32, u64, u64, u64]
    lib.tpurmTraceEnd.restype = None
    lib.tpurmProcfsRead.argtypes = [cp, cp, sz]
    lib.tpurmProcfsRead.restype = sz
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
    lib.tpurmCounterGet.argtypes = [cp]
    lib.tpurmCounterGet.restype = u64
    _bound = lib
    return lib


def counter(name: str) -> int:
    """Monotonic named engine counter."""
    return _lib().tpurmCounterGet(name.encode())


# ------------------------------------------------------------------ tracing

def trace_site(name: str) -> int:
    """A trace site's id by name ("sched.round", "fault.latency", ...)."""
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
    """A native trace span of a named site (``sched.round``,
    ``vac.migrate``, ...), with an object id and a byte count; a no-op
    while tracing is disarmed (tpurmTraceBegin's relaxed-load fast
    path)."""

    def __init__(self, site: str, obj: int = 0, bytes_: int = 0):
        self._site = trace_site(site)
        self._obj = obj
        self.bytes = bytes_

    def __enter__(self) -> "span":
        self._t0 = _lib().tpurmTraceBegin()
        return self

    def __exit__(self, *exc) -> None:
        _lib().tpurmTraceEnd(self._site, self._t0, self._obj, self.bytes)


def trace_start() -> None:
    """Arm tracing (every engine site starts emitting spans)."""
    _lib().tpurmTraceStart()


def trace_stop() -> None:
    _lib().tpurmTraceStop()


def trace_reset() -> None:
    """Clear rings, drop accounting and site histograms."""
    _lib().tpurmTraceReset()


def trace_hist_count(site) -> int:
    """Samples in a site's latency histogram (``site``: name or id)."""
    sid = trace_site(site) if isinstance(site, str) else int(site)
    return _lib().tpurmTraceHistCountNs(sid)


def trace_export() -> dict:
    """The Chrome trace-event export, parsed: {"traceEvents": [...]}."""
    buf = ctypes.create_string_buffer(TRACE_EXPORT_BYTES)
    n = _lib().tpurmTraceExportJson(buf, TRACE_EXPORT_BYTES)
    return json.loads(buf.raw[:n].decode(errors="replace"))


def metrics_text() -> str:
    """The Prometheus exposition (/proc/driver/tpurm/metrics body)."""
    buf = ctypes.create_string_buffer(METRICS_BYTES)
    n = _lib().tpurmProcfsRead(b"/proc/driver/tpurm/metrics", buf,
                               METRICS_BYTES)
    return buf.raw[:n].decode(errors="replace")


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


def flow_report() -> List[Dict]:
    """Top-K slow flows (K = FLOW_REPORT_MAX), most-blamed first: one dict
    per flow with the ledger fields and a per-bucket blame map (ns)."""
    buf = (_FlowRec * FLOW_REPORT_MAX)()
    n = _lib().tpurmFlowReport(ctypes.cast(buf, ctypes.c_void_p),
                               FLOW_REPORT_MAX)
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
