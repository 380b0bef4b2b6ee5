"""The port's own trace against the device's: where the card idles, by the
span of the port open on the host, and what arming the trace costs.

    python3 -m portbench.program --workload <cell> --seed <n> --pairs 100

A tool beside the benchmark's runs, not a part of them.  In one process it
makes the set-up a run makes (weights on the card from the seed, the
``Scheduler``, every client's first request admitted), serves
``WARM_SECONDS`` of whole rounds, then:

1. The program stretch (``stretch``): whole rounds for about
   ``run.TRACE_SECONDS`` under ``torch.profiler`` with the device's
   activity alone, as the window's ``trace.CardTime`` profiles it, the
   port's trace (tputrace, ``utils.trace_start``) reset and armed across
   them, inside the tool's own span ``STRETCH_SPAN``, whose first and last
   device ops are fills the host waits for.  ``Program`` reads it.  Its
   lines: ``program_trace`` (the facts below) and ``idle_gaps_program``.
2. ``--pairs`` pairs of whole rounds, one round with the port's trace armed
   and the other disarmed, the order alternating from pair to pair, so
   that both sides of a pair serve the same streams at nearly the same
   lengths.  Each round prints its host seconds, the host ms a decode
   step took inside ``decode_scan`` (``harness.Probes``), the streams
   admitted in it and the records the rings took.  Then the host ns of one
   empty application span, disarmed and armed, over ``SPANS`` of them.

The last line gives the program stretch's readings and, over the pairs,
the armed round's figure over the disarmed one's: the host ms a decode
step, and the round's seconds (which a round's admissions move more than
arming does); each as the median, the quartiles and the spread (the
quartiles' distance over the median).

``Program`` sets the export's spans, stamped on ``CLOCK_MONOTONIC``, onto
the profiler's Unix-epoch timeline by the export's two clock anchors
(``utils.CLOCK_ANCHORS``, ``ClockMap``).  The card idles before
``STRETCH_SPAN`` opens and after it closes, so each of its ops has to fall
inside the mapped span, which checks the mapping.  It gives:

- ``idle_gaps``: the device's idle time inside ``STRETCH_SPAN`` charged to
  the innermost span of the port open on the thread that drives the
  Scheduler: serving's ``serve.prefill_group``, ``serve.prefill``,
  ``serve.decode_scan`` and ``serve.decode_step``; the tier's
  ``tier.activate``, ``tier.upload``, ``tier.read_pages``,
  ``tier.fault_pass``, ``tier.gather``, ``tier.sync_from``,
  ``tier.flush``, ``tier.download``, ``tier.writeback`` and
  ``tier.release``; the Scheduler's ``sched.round``, ``sched.admit``,
  ``sched.preempt`` and ``sched.readback``; the engine's own sites on that
  thread (``fault.*``, ``memring.*``).  Where none is open, to
  ``host.other``;
- ``idle_ms_per_step``: the idle charged to ``serve.decode_step`` over the
  steps begun in the stretch;
- ``fault_worker_share``: the share of the driving thread's
  ``tier.fault_pass`` time in which some other thread, an engine worker,
  has a ``memring.op`` span open;
- ``facts``: records and records dropped by the rings, events the export
  cut, how far a device op falls outside ``STRETCH_SPAN`` once mapped (the
  containment error) and the drift between the anchors.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import os
import statistics
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import _on_device, _union

#: The tool's own application span around the program stretch: it bounds
#: the stretch, checks the clock mapping and is charged nothing.
STRETCH_SPAN = "portbench.stretch"
DECODE_STEP = "serve.decode_step"
FAULT_PASS = "tier.fault_pass"
WORKER_OP = "memring.op"
# Records a thread's trace ring holds (the engine's ``trace_ring`` knob):
# enough that the program stretch and the armed rounds drop none.
TRACE_RING = 1 << 20
SPANS = 200000
WARM_SECONDS = 30.0     # whole rounds served before the program stretch


class ClockMap:
    """CLOCK_MONOTONIC ns onto CLOCK_REALTIME ns, linear between two anchors
    (``torch.profiler`` stamps its events in Unix-epoch ns)."""

    def __init__(self, first: Sequence[int], last: Sequence[int]):
        (m0, r0), (m1, r1) = first, last
        self.m0 = int(m0)
        self.off0 = int(r0) - int(m0)
        self.drift_ns = (int(r1) - int(m1)) - self.off0
        self.slope = self.drift_ns / (m1 - m0) if m1 != m0 else 0.0

    def __call__(self, t: int) -> int:
        return t + self.off0 + round(self.slope * (t - self.m0))


def native_spans(doc: dict) -> List[Tuple[int, int, int, str]]:
    """(tid, start ns, end ns, name) of the export's complete events, on
    CLOCK_MONOTONIC (the export writes µs with three decimals)."""
    out = []
    for e in doc.get("traceEvents", ()):
        if e.get("ph") != "X":
            continue
        a = round(e["ts"] * 1000)
        out.append((e["tid"], a, a + round(e["dur"] * 1000), e["name"]))
    return out


def innermost(spans: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """Spans of one thread flattened to disjoint segments, each named by the
    innermost span open over it (the one begun last); a sweep, since one
    thread's spans nest."""
    spans = [x for x in spans if x[1] > x[0]]
    bounds = sorted([(a, 1, -b, i) for i, (a, b, _) in enumerate(spans)] +
                    [(b, 0, 0, i) for i, (_, b, _) in enumerate(spans)])
    segs: List[Tuple[int, int, str]] = []
    stack: List[int] = []
    last = None
    for t, is_start, _, i in bounds:
        if stack and last is not None and t > last:
            segs.append((last, t, spans[stack[-1]][2]))
        last = t
        if is_start:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        elif i in stack:
            stack.remove(i)
    return segs


def _charge(intervals, segs, by: Dict[str, int]):
    """Charge each interval's overlap with the disjoint, sorted ``segs`` to
    their names in ``by``; returns the pieces no segment covers."""
    starts = [a for a, _, _ in segs]
    rest = []
    for ga, gb in intervals:
        t = ga
        i = max(0, bisect.bisect_right(starts, ga) - 1)
        while i < len(segs) and segs[i][0] < gb:
            a, b, name = segs[i]
            lo, hi = max(a, ga), min(b, gb)
            if hi > lo:
                by[name] = by.get(name, 0) + hi - lo
                if lo > t:
                    rest.append((t, lo))
                t = max(t, hi)
            i += 1
        if t < gb:
            rest.append((t, gb))
    return rest


def _overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two unions of intervals."""
    a, b = _union(a), _union(b)
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class Program:
    """The program stretch: the profiler's device events and the port's
    export of the same stretch, ``doc``, with the export's clock anchors
    ``anchors`` ({"armed": [mono, real], "exported": [mono, real]}, as
    ``utils.trace_export`` gives them), taken on the thread ``thread`` (a
    native thread id) that drove the Scheduler.  ``stats`` is
    ``utils.trace_stats()`` at the stretch's end."""

    def __init__(self, events, doc: dict, thread: int, stats: dict,
                 anchors: dict):
        clock = ClockMap(anchors["armed"], anchors["exported"])
        spans = native_spans(doc)
        mine = [(clock(a), clock(b), n)
                for tid, a, b, n in spans if tid == thread]
        bounds = [(a, b) for a, b, n in mine if n == STRETCH_SPAN]
        if not bounds:
            raise RuntimeError(f"the export holds no {STRETCH_SPAN} span")
        t0, t1 = bounds[0]
        program = [x for x in mine if x[2] != STRETCH_SPAN]

        device = [(int(e.start_ns()),
                   int(e.start_ns()) + int(e.duration_ns()))
                  for e in events if _on_device(e)]
        busy = _union([(max(a, t0), min(b, t1)) for a, b in device
                       if b > t0 and a < t1])
        gaps, t = [], t0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < t1:
            gaps.append((t, t1))

        by: Dict[str, int] = {}
        rest = _charge(gaps, innermost(program), by)
        program_idle = sum(by.values())
        other = sum(b - a for a, b in rest)
        if other:
            by["host.other"] = other
        self._idle = by
        idle = sum(b - a for a, b in gaps)
        self.decode_steps = sum(1 for a, _, n in program
                                if n == DECODE_STEP and t0 <= a < t1)

        faults = [(a, b) for tid, a, b, n in spans
                  if tid == thread and n == FAULT_PASS]
        ops = [(a, b) for tid, a, b, n in spans
               if tid != thread and n == WORKER_OP]
        fault_ns = sum(b - a for a, b in _union(faults))
        self.fault_worker_share = (100.0 * _overlap_ns(faults, ops) /
                                   fault_ns if fault_ns else None)

        meta = [e for e in doc.get("traceEvents", ())
                if e.get("name") == "tpurm.export"]
        first = min((a for a, _ in device), default=None)
        last = max((b for _, b in device), default=None)
        self.facts = {
            "records": stats.get("recorded"),
            "dropped": stats.get("dropped"),
            "export_dropped": (meta[0]["args"].get("exportDropped")
                               if meta else None),
            "events": len(spans),
            # how far the device's ops reach outside the mapped stretch
            # span, and the span's lead on the first op and its lag after
            # the last
            "containment_err_us": (max(0, t0 - first, last - t1) / 1e3
                                   if device else None),
            "containment_margins_us": ([(first - t0) / 1e3,
                                        (t1 - last) / 1e3]
                                       if device else None),
            "clock_drift_us": clock.drift_ns / 1e3,
            "window_s": (t1 - t0) / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "idle_s": idle / 1e9,
            "program_idle_share": (100.0 * program_idle / idle
                                   if idle else None),
        }

    def idle_gaps(self) -> List[List]:
        """Idle seconds by the innermost span over them, every name."""
        rows = sorted(self._idle.items(), key=lambda kv: -kv[1])
        return [[n, ns / 1e9] for n, ns in rows]

    @property
    def idle_ms_per_step(self) -> Optional[float]:
        if not self.decode_steps:
            return None
        return self._idle.get(DECODE_STEP, 0) / 1e6 / self.decode_steps


def stretch(loop, device, seconds: float) -> Program:
    """Whole rounds for about ``seconds`` under the profiler with the
    device's activity alone (the host's on the CPU), the port's trace
    reset and armed across them, inside ``STRETCH_SPAN``.  The span's
    first and last device ops are one-element fills, each waited for, so
    that the mapping's check holds the span to within a launch of them."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from open_gpu_kernel_modules_tpu_torch import utils

    from . import harness

    act = (ProfilerActivity.CUDA if device.type == "cuda" else
           ProfilerActivity.CPU)
    harness.sync(device)
    utils.trace_stop()
    utils.trace_reset()
    with profile(activities=[act]) as prof:
        utils.trace_start()
        with utils.span(STRETCH_SPAN):
            mark = torch.zeros(1, device=device)
            harness.sync(device)
            t0 = harness.clock()
            while harness.clock() - t0 < seconds:
                loop.round()
            mark.fill_(1)
            harness.sync(device)
        utils.trace_stop()
    stats = utils.trace_stats()
    doc = utils.trace_export()
    utils.trace_reset()
    return Program(prof.profiler.kineto_results.events(), doc,
                   threading.get_native_id(), stats,
                   doc[utils.CLOCK_ANCHORS])


# ------------------------------------------------------ the cost of arming

def span_ns() -> dict:
    """Host ns of one empty ``utils.span``, disarmed and armed."""
    from open_gpu_kernel_modules_tpu_torch import utils

    from . import harness
    out = {}
    for armed in (False, True):
        utils.trace_reset()
        if armed:
            utils.trace_start()
        t = harness.clock()
        for _ in range(SPANS):
            with utils.span(DECODE_STEP, obj=64):
                pass
        out["armed" if armed else "disarmed"] = \
            1e9 * (harness.clock() - t) / SPANS
        utils.trace_stop()
        utils.trace_reset()
    return out


def one_round(loop, probes, armed: bool) -> dict:
    """One whole round, the port's trace armed or not across it."""
    from open_gpu_kernel_modules_tpu_torch import utils

    from . import harness
    stats = loop.sched.stats
    d0, n0 = probes.decode_s, probes.decode_steps
    a0 = stats["admitted"]
    r0 = utils.trace_stats()["recorded"]
    if armed:
        utils.trace_start()
    t = harness.clock()
    loop.round()
    s = harness.clock() - t
    if armed:
        utils.trace_stop()
    steps = probes.decode_steps - n0
    step_ms = 1e3 * (probes.decode_s - d0) / steps if steps else None
    return {"armed": armed, "s": s, "step_ms": step_ms,
            "admitted": stats["admitted"] - a0,
            "records": utils.trace_stats()["recorded"] - r0}


def quartiles(xs: List[float]) -> Optional[dict]:
    """Median, quartiles and spread ((q3 - q1) / median) of ``xs``."""
    if len(xs) < 2:
        return None
    q1, _, q3 = statistics.quantiles(xs, n=4)
    med = statistics.median(xs)
    return {"n": len(xs), "median": med, "q1": q1, "q3": q3,
            "spread": (q3 - q1) / med}


def cost(pairs: List[dict]) -> dict:
    """The armed round's figures over the disarmed one's, over ``pairs``
    ({True: armed round, False: disarmed round})."""
    step = [p[True]["step_ms"] / p[False]["step_ms"] for p in pairs
            if p[True]["step_ms"] and p[False]["step_ms"]]
    return {
        "armed_over_disarmed_step_ms": quartiles(step),
        "armed_over_disarmed_round_s": quartiles(
            [p[True]["s"] / p[False]["s"] for p in pairs]),
        "disarmed_step_ms": quartiles([p[False]["step_ms"] for p in pairs
                                       if p[False]["step_ms"]]),
        "disarmed_round_s": quartiles([p[False]["s"] for p in pairs]),
        "records_per_armed_round": (statistics.median(
            p[True]["records"] for p in pairs) if pairs else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=100)
    args = ap.parse_args(argv)

    from . import run
    run.set_env()
    os.environ["TPUMEM_TRACE_RING"] = str(TRACE_RING)
    import torch

    from open_gpu_kernel_modules_tpu_torch import utils

    from . import harness, loadgen, spec, weights
    if not torch.cuda.is_available():
        print("portbench.program: needs a CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    run.build()
    mix = cell.traffic
    m = spec.model_fields(cell.config)
    params = weights.make(m, args.seed, device)
    s = run.scheduler(mix, m, params, device)
    pairs = []
    try:
        loop = harness.Loop(s, loadgen.Traffic(mix, args.seed,
                                               m["vocab_size"]))
        loop.start()
        while not loop.admitted_all():
            loop.round()
        gc.collect()
        gc.freeze()
        placement = harness.Placement()
        placement.place()
        t0 = harness.clock()
        while harness.clock() - t0 < WARM_SECONDS:
            loop.round()
        placement.place()
        prog = stretch(loop, device, run.TRACE_SECONDS)
        print("program_trace " + json.dumps(prog.facts), flush=True)
        print("idle_gaps_program " + json.dumps(prog.idle_gaps()),
              flush=True)

        probes = harness.Probes(device=device)
        probes.install()
        probes.counting = True
        for i in range(args.pairs):
            placement.place()
            pair = {}
            for armed in ((False, True) if i % 2 == 0 else (True, False)):
                pair[armed] = one_round(loop, probes, armed)
                print(json.dumps(pair[armed]), flush=True)
            pairs.append(pair)
        dropped = utils.trace_stats()["dropped"]
        t = harness.clock()
        utils.trace_export()
        export_s = harness.clock() - t
        utils.trace_reset()
        placement.release()
        probes.remove()
        spans = span_ns()
        loop.open = False
    finally:
        s.close()
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "pairs": len(pairs),
        "card": run.power_limit(),
        "decode.idle_ms_per_step": prog.idle_ms_per_step,
        "decode_steps": prog.decode_steps,
        "tier.fault_worker_share": prog.fault_worker_share,
        "program_trace": prog.facts,
        **cost(pairs),
        "span_ns": spans, "dropped": dropped, "export_s": export_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
