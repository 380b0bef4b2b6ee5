"""Span-coldness probe of the native hotness tracker (native/src/hot.c).

The port's copy of the one call of the JAX package's ``uvm/hot.py`` that
the scheduler uses: ``span_score``, the mean decayed hotness of the managed
blocks covering a span (half-life ``hot_decay_ms``, 250 ms by default).
The scheduler's preemption victim choice reads it: lower is colder.
"""

from __future__ import annotations

import ctypes

from ..runtime import native

_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = native.load()
        lib.tpurmHotSpanScore.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.tpurmHotSpanScore.restype = ctypes.c_uint64
        _bound = lib
    return _bound


def span_score(addr: int, length: int) -> int:
    """Mean decayed hotness of the managed blocks covering
    ``[addr, addr+length)``; 0 for spans that are not managed."""
    return int(_lib().tpurmHotSpanScore(addr, length))
