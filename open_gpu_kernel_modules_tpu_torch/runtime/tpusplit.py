"""tpusplit — prefill/decode disaggregation over the multichip KV pool.

Port of the JAX package's ``runtime/tpusplit.py``.  PREFILL is
compute-bound (one attention pass builds the whole prompt's KV) and DECODE
is memory-bound (every token re-reads the KV).  The disaggregated layout
prefills against one chip and parks each stream's KV on an assigned DECODE
chip, so decode-side HBM scales with the number of decode chips.

This module is the MECHANISM, KV shipping as tpuvac manifest transactions:

  ship     — after prefill, the stream's slot records move prefill ->
             decode home as vac.migrate_pages legs (manifest, dep-joined
             PEER_COPY windows, wire CRC, abort-to-source), riding the
             REQUEST's flow, so the shipping cost lands in that request's
             ``ici`` blame bucket.
  reclaim  — before a NEW stream prefills into a slot, records the previous
             stream left on a decode chip come back to the prefill chip.

On ANY abort the source mapping was never touched: the stream decodes
CO-LOCATED from wherever its pages are, token-exact.  The POLICY half (which
streams ship where, reset and evacuation recovery) is
:class:`~.sched.Scheduler`'s, through ``DisaggConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from ..uvm import vac as _vac


def _counter_add(name: str, delta: int = 1) -> None:
    # Imported here: the scheduler imports this module.
    from . import sched as _sched
    _sched._counter_add(name, delta)


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """Prefill/decode split for a multichip scheduler.

    ``decode_devs``: chips that hold decoding streams' KV (a stream's home
    is ``decode_devs[seq % len(decode_devs)]``, deterministic, so a restore
    after a reset lands on the same home).  ``prefill_dev``: the chip
    prefill writes its KV to.  ``window``: in-flight PEER_COPY records per
    shipping window (vac's dep-join throttle)."""

    decode_devs: Tuple[int, ...]
    prefill_dev: int = 0
    window: int = 4

    def __post_init__(self):
        if not self.decode_devs:
            raise ValueError("disagg needs at least one decode chip")
        if self.prefill_dev in self.decode_devs:
            raise ValueError(
                f"prefill chip {self.prefill_dev} cannot also be a "
                f"decode home (the split is the point)")

    def home_of(self, seq: int) -> int:
        return self.decode_devs[seq % len(self.decode_devs)]


def _move(backing, pages: Sequence[int], dst: int, flow: int, window: int):
    """One logical move = one vac transaction per source chip the pages sit
    on (normally one; after an aborted leg a slot can be split across
    chips).  Legs already committed stay committed on a later leg's
    failure: every page has exactly one home at all times, so a partial
    move is co-location for the remainder, never corruption."""
    reports = []
    srcs = sorted({int(backing.home[p]) for p in pages} - {dst})
    for src in srcs:
        sub = [p for p in pages if int(backing.home[p]) == src]
        reports.append(_vac.migrate_pages(backing, src, dst, sub,
                                          window=window, flow=flow or None))
    return reports


def ship_kv(backing, pages: Sequence[int], dst: int, flow: int = 0,
            window: int = 4):
    """Ship ``pages`` to decode home ``dst``.  Returns the committed
    :class:`vac.MigrationReport` list; raises :class:`vac.VacAbort` (or
    RmError) on the first failed leg."""
    reports = _move(backing, pages, dst, flow, window)
    _counter_add("tpusplit_ships")
    _counter_add("tpusplit_pages_shipped", sum(r.pages for r in reports))
    return reports


def reclaim_kv(backing, pages: Sequence[int], prefill_dev: int,
               flow: int = 0, window: int = 4):
    """Bring ``pages`` back to the prefill chip before a new stream reuses
    their slot; counted as ``tpusplit_reclaims`` (the overhead a co-located
    layout never pays)."""
    reports = _move(backing, pages, prefill_dev, flow, window)
    _counter_add("tpusplit_reclaims")
    return reports


def ship_latencies_s(reports) -> List[float]:
    """Per-leg ship wall times from a list of MigrationReports."""
    return [r.ship_s for r in reports]
