"""The closed loop of clients over the port's ``Scheduler`` and what it records.

The port is driven through its public API only: ``Scheduler.submit`` and
``Scheduler.step`` over its ``TieredKVCache`` on a ``ManagedKVBacking``.  In
a traced run (``probes=True``) the harness wraps the calls into each layer
from here (``Probes.install``) to time them on the host clock and to name
them in the profiler's trace; it edits nothing of the program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import flops, loadgen
from .check import Served

clock = time.perf_counter


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------------ placement

def _loop_s(n: int) -> float:
    t = clock()
    x = 0
    for i in range(n):
        x += i * i
    return clock() - t


class Placement:
    """The driving thread on the fastest of the process's CPUs.

    The cell is paced by the host, and the host's cores run one fixed
    Python loop in times that differ up to twofold, from core to core and
    from minute to minute (the cores are shared with other work).  So the
    thread that drives the Scheduler is placed by a timed loop: ``place()``
    runs it on each CPU the process may use and pins the calling thread to
    the fastest; ``release()`` gives the thread its whole mask back.  The
    threads that the port started before keep their own masks.
    """

    LOOP = 30000            # ~1.5 ms on a core of the H100's host

    def __init__(self):
        self.cpus = sorted(os.sched_getaffinity(0))
        self.picks: List[Tuple[int, float, float]] = []

    def place(self) -> None:
        if len(self.cpus) < 2:
            return
        times = {}
        for c in self.cpus:
            os.sched_setaffinity(0, {c})
            times[c] = min(_loop_s(self.LOOP) for _ in range(2))
        best = min(times, key=times.get)
        os.sched_setaffinity(0, {best})
        self.picks.append((best, 1e3 * times[best],
                           1e3 * float(np.median(list(times.values())))))

    def release(self) -> None:
        os.sched_setaffinity(0, set(self.cpus))


# ------------------------------------------------------------------ probes

@dataclasses.dataclass
class Probes:
    """Host-clock sums of the wrapped calls while ``counting``; profiler
    annotations while ``annotating``; B1's contexts while ``tracing``."""

    device: torch.device
    running: Callable[[], List[int]] = lambda: []
    max_len: int = 0
    counting: bool = False
    sync_prefill: bool = False
    annotating: bool = False
    tracing: bool = False
    prefill_s: float = 0.0
    prefill_tokens: int = 0
    decode_s: float = 0.0
    decode_steps: int = 0
    tier_s: float = 0.0
    b1_contexts: List[List[int]] = dataclasses.field(default_factory=list)
    _tier_depth: int = 0
    _tier_t0: float = 0.0
    _undo: List[Tuple[object, str, object]] = dataclasses.field(
        default_factory=list)

    def _annot(self, name: str):
        if self.annotating:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _tier(self, fn, name: str):
        probes = self

        def wrapped(*a, **k):
            with probes._annot(name):
                if probes._tier_depth == 0:
                    probes._tier_t0 = clock()
                probes._tier_depth += 1
                try:
                    return fn(*a, **k)
                finally:
                    probes._tier_depth -= 1
                    if probes._tier_depth == 0 and probes.counting:
                        probes.tier_s += clock() - probes._tier_t0
        return wrapped

    def _prefill_group(self, fn):
        probes = self

        def wrapped(cfg, params, cache, seq_ids, prompt):
            with probes._annot("bench.prefill_group"):
                if probes.sync_prefill and probes.counting:
                    sync(probes.device)
                t0 = clock()
                out = fn(cfg, params, cache, seq_ids, prompt)
                if probes.sync_prefill and probes.counting:
                    sync(probes.device)
                if probes.counting:
                    probes.prefill_s += clock() - t0
                    probes.prefill_tokens += int(prompt.numel())
                return out
        return wrapped

    def _decode_scan(self, fn):
        probes = self

        def wrapped(cfg, params, tokens, cache, n):
            if probes.tracing:
                lens = probes.running()
                for j in range(n):
                    probes.b1_contexts.append(
                        [min(x + j + 1, probes.max_len) for x in lens])
            with probes._annot("bench.decode_scan"):
                t0 = clock()
                out = fn(cfg, params, tokens, cache, n)
                if probes.counting:
                    probes.decode_s += clock() - t0
                    probes.decode_steps += n
                return out
        return wrapped

    def _named(self, fn, name: str):
        probes = self

        def wrapped(*a, **k):
            with probes._annot(name):
                return fn(*a, **k)
        return wrapped

    def _patch(self, owner, attr: str, make) -> None:
        old = getattr(owner, attr)
        self._undo.append((owner, attr, old))
        setattr(owner, attr, make(old))

    def install(self) -> None:
        from open_gpu_kernel_modules_tpu_torch.models import serving
        self._patch(serving, "prefill_group", self._prefill_group)
        self._patch(serving, "prefill",
                    lambda f: self._named(f, "bench.prefill"))
        self._patch(serving, "decode_scan", self._decode_scan)
        for cls, attr, name in (
                (serving.TieredKVCache, "activate", "bench.activate"),
                (serving.TieredKVCache, "sync_from", "bench.sync_from"),
                (serving.TieredKVCache, "flush_group", "bench.flush"),
                (serving.TieredKVCache, "release_sequence", "bench.release"),
                (serving.ManagedKVBacking, "read_pages", "bench.read_pages")):
            self._patch(cls, attr, lambda f, n=name: self._tier(f, n))

    def remove(self) -> None:
        while self._undo:
            owner, attr, old = self._undo.pop()
            setattr(owner, attr, old)


# ------------------------------------------------------------------ loop

@dataclasses.dataclass
class Rec:
    """One request as its client saw it."""
    req: object
    client: int
    submit_t: float
    emits: List[Tuple[float, int]] = dataclasses.field(default_factory=list)
    seen: int = 0
    end_t: Optional[float] = None
    first: Optional[int] = None     # the prefill's greedy token


class Loop:
    """``clients`` closed-loop clients over one Scheduler."""

    def __init__(self, sched, traffic: loadgen.Traffic):
        from open_gpu_kernel_modules_tpu_torch.runtime.sched import (
            RequestState)
        self.sched = sched
        self.traffic = traffic
        self.state = RequestState
        self.recs: List[Rec] = []
        self.live: Dict[int, Rec] = {}
        self.rounds: List[Tuple[float, float]] = []
        self.open = True        # clients resubmit while open

    def submit(self, client: int) -> Rec:
        spec = self.traffic.next(client)
        prompt = self.traffic.tokens(spec)
        t = clock()
        rec = Rec(self.sched.submit(prompt, spec.max_new_tokens), client, t)
        self.recs.append(rec)
        self.live[client] = rec
        return rec

    def start(self) -> None:
        for c in range(self.traffic.clients):
            self.submit(c)

    def running_lens(self) -> List[int]:
        """Cache lengths of the running requests, before this round."""
        lens = self.sched.cache.seq_lens
        return [int(lens[r.req.seq]) for r in self.live.values()
                if r.req.state is self.state.RUNNING and r.req.seq is not None]

    def round(self) -> float:
        t0 = clock()
        self.sched.step()
        t1 = clock()
        self.rounds.append((t0, t1))
        terminal = (self.state.FINISHED, self.state.ERROR,
                    self.state.CANCELLED)
        last = self.sched.cache.last_token
        for client, rec in list(self.live.items()):
            req = rec.req
            if rec.first is None and req.seq is not None:
                # Until the first decode round moves past it, the cache's
                # last token of an admitted stream is its prefill's greedy
                # token (the Scheduler feeds it to the first decode step).
                rec.first = int(last[req.seq])
            d = min(req.decoded, req.max_new_tokens)
            if d > rec.seen:
                rec.emits.append((t1, d - rec.seen))
                rec.seen = d
            if req.state in terminal:
                rec.end_t = t1
                del self.live[client]
                if self.open:
                    self.submit(client)
        return t1

    def admitted_all(self) -> bool:
        return all(r.req.state is not self.state.QUEUED
                   for r in self.live.values())


# ------------------------------------------------------------------ record

@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""
    model: Dict[str, object]
    t_open: float
    t_close: float
    recs: List[Rec]
    rounds: List[Tuple[float, float]]
    setup_s: float
    stats_delta: Dict[str, int]
    probes: Optional[Probes] = None
    trace: Optional[object] = None
    b1_trace_bytes: int = 0
    card: Optional[object] = None      # trace.CardTime of the window

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def inside(self, t: float) -> bool:
        return self.t_open < t <= self.t_close

    def emitted(self) -> int:
        return sum(n for r in self.recs for t, n in r.emits
                   if self.inside(t))

    def ttft_s(self) -> List[float]:
        return [r.emits[0][0] - r.submit_t for r in self.recs
                if r.emits and self.inside(r.emits[0][0])]

    def itl_s(self) -> List[float]:
        out = []
        for r in self.recs:
            for (ta, _), (tb, n) in zip(r.emits, r.emits[1:]):
                if self.inside(tb):
                    out.append((tb - ta) / n)
        return out

    def round_s(self) -> List[float]:
        return [b - a for a, b in self.rounds if self.inside(b)]

    def window_flops(self) -> int:
        """Model operations of the prompts prefilled and the tokens emitted
        in the window (a request's prompt counts when its first token
        comes in the window)."""
        m = self.model
        total = 0
        for r in self.recs:
            plen = int(r.req.prompt.size)
            done = 0
            for t, n in r.emits:
                if self.inside(t):
                    if done == 0:
                        total += flops.prefill_flops(m, plen)
                    # the prefill's own greedy token is fed, not emitted:
                    # emitted token k is decoded over plen + 1 + k keys
                    ctx = [plen + 1 + k for k in range(done, done + n)]
                    total += flops.decode_flops(m, ctx)
                done += n
        return total


def p95(x: List[float]) -> Optional[float]:
    return float(np.percentile(np.asarray(x), 95)) if x else None


def median(x: List[float]) -> Optional[float]:
    return float(np.median(np.asarray(x))) if x else None


def served_in_window(run: Run) -> List[Served]:
    """Requests that finished inside the window, with what they served."""
    out = []
    for r in run.recs:
        req = r.req
        if r.end_t is not None and run.inside(r.end_t) and \
                req.tokens is not None and r.first is not None:
            out.append(Served(req.rid, np.asarray(req.prompt), r.first,
                              np.asarray(req.tokens), req.max_new_tokens))
    return out
