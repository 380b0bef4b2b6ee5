"""Reading a ``torch.profiler`` trace of a steady stretch of serving.

The harness opens one ``bench.window`` annotation over the traced stretch
and a ``bench.<layer>`` annotation around each call it wraps.  From the
trace this module takes:

- ``busy_s``: the union of the device's kernels, copies and fills inside
  the window; ``window_s``: the window's length;
- ``device_ops``: device seconds by operation name, largest first;
- ``idle_gaps``: the device's idle time inside the window, charged to the
  innermost ``bench.*`` annotation the host was in over each stretch of it
  (``host.other`` where it was in none);
- ``kernel_s(substring)``: device seconds of the kernels whose name holds
  the substring.

``CardTime`` profiles every round of a measured window, a few rounds at a
time, for the card's own time: its kernels, fills and copies, less the
copies from or to pageable host memory.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

PREFIX = "bench."
WINDOW = "bench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# A copy from or to pageable host memory: CUDA stages it through pinned
# buffers by the host's own memcpy, so its span on the card's timeline is
# the host's time.
PAGEABLE = "Pageable"


def _on_device(e) -> bool:
    """A kernel, copy or fill on the device.  Older PyTorch (2.11, on the
    card's machine) has no ``activity_type``: there a device event is any
    CUDA event but the GPU side of the harness's own annotations."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind()) in DEVICE_KINDS
    return "CUDA" in str(e.device_type()) and not e.name().startswith(PREFIX)


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Summary:
    def __init__(self, events):
        spans: List[Tuple[int, int, str]] = []
        device: List[Tuple[int, int, str]] = []
        for e in events:
            a = int(e.start_ns())
            b = a + int(e.duration_ns())
            name = e.name()
            if _on_device(e):
                device.append((a, b, name))
            elif name.startswith(PREFIX) and "CUDA" not in str(
                    e.device_type()):
                spans.append((a, b, name))
        windows = [(a, b) for a, b, n in spans if n == WINDOW]
        if not windows:
            raise RuntimeError("the trace holds no bench.window annotation")
        self.t0, self.t1 = windows[0]
        self.window_s = (self.t1 - self.t0) / 1e9
        self.device = [(max(a, self.t0), min(b, self.t1), n)
                       for a, b, n in device if b > self.t0 and a < self.t1]
        self.spans = [s for s in spans if s[2] != WINDOW]
        busy = _union([(a, b) for a, b, _ in self.device])
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        self._gaps = []
        t = self.t0
        for a, b in busy:
            if a > t:
                self._gaps.append((t, a))
            t = max(t, b)
        if t < self.t1:
            self._gaps.append((t, self.t1))

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for a, b, n in self.device:
            by[n] = by.get(n, 0) + (b - a)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, ns / 1e9] for n, ns in rows]

    def kernel_s(self, part: str) -> float:
        return sum(b - a for a, b, n in self.device if part in n) / 1e9

    def _innermost(self) -> List[Tuple[int, int, str]]:
        """The annotations flattened to disjoint segments, each named by
        the innermost annotation over it."""
        spans = sorted(self.spans)
        cuts = sorted({x for a, b, _ in spans for x in (a, b)})
        segs: List[Tuple[int, int, str]] = []
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            inner = [s for s in spans if s[0] <= mid < s[1]]
            if inner:
                segs.append((a, b, max(inner, key=lambda s: (s[0], -s[1]))[2]))
        return segs

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds by the innermost annotation over them."""
        segs = self._innermost()
        starts = [a for a, _, _ in segs]
        by: Dict[str, int] = {}
        for ga, gb in self._gaps:
            covered = 0
            i = max(0, bisect.bisect_right(starts, ga) - 1)
            while i < len(segs) and segs[i][0] < gb:
                a, b, name = segs[i]
                ov = min(b, gb) - max(a, ga)
                if ov > 0:
                    by[name] = by.get(name, 0) + ov
                    covered += ov
                i += 1
            if covered < gb - ga:
                by["host.other"] = by.get("host.other", 0) + (gb - ga -
                                                               covered)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, ns / 1e9] for n, ns in rows]


def card_ns(events) -> Tuple[int, int]:
    """(card, pageable) nanoseconds of one profile: the union of the
    device's kernels, fills and copies other than pageable ones; and the
    union of the pageable copies."""
    card: List[Tuple[int, int]] = []
    pageable: List[Tuple[int, int]] = []
    for e in events:
        if _on_device(e):
            a = int(e.start_ns())
            iv = (a, a + int(e.duration_ns()))
            (pageable if PAGEABLE in e.name() else card).append(iv)
    return (sum(b - a for a, b in _union(card)),
            sum(b - a for a, b in _union(pageable)))


class CardTime:
    """The card's time over every round of a window.

    ``start()`` before the window's first round, ``lap(sync)`` between
    rounds every ``ROUNDS`` rounds, ``stop(sync)`` after the last: each
    lap waits for the card (``sync``), closes one profile of the device's
    activity alone and opens the next, so that no profile holds more than
    a few rounds' events.  ``card_s`` sums ``card_ns`` of every profile,
    ``pageable_s`` the pageable copies beside it.
    """

    ROUNDS = 4

    def __init__(self):
        self.card_s = 0.0
        self.pageable_s = 0.0
        self.profiles = 0
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self, sync) -> None:
        sync()
        self._prof.stop()
        card, pageable = card_ns(self._prof.profiler.kineto_results.events())
        self._prof = None
        self.card_s += card / 1e9
        self.pageable_s += pageable / 1e9
        self.profiles += 1

    def lap(self, sync) -> None:
        self.stop(sync)
        self.start()


def summarize(prof) -> Summary:
    return Summary(prof.profiler.kineto_results.events())
