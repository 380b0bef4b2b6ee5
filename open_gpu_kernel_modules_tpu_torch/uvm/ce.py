"""tpuce, the multi-channel copy-engine pool of the native engine
(native/src/ce.c).

The port's own copy of the JAX package's ``uvm/ce.py``: per-channel bytes,
busy time and outstanding work, the striping and compression counters, a
drain of every channel, and the channel-count knob.

Every bulk copy of the engine (block migration, tier evict and promote,
memring coalesced runs, ICI peer copies, memdesc transfers) goes through
this pool: a copy splits into stripes (registry ``tpuce_stripe_bytes``),
and each stripe lands on the logical channel with the fewest outstanding
bytes.  Registry ``tpuce_channels`` (default 4, capped at the online CPUs:
each channel is an executor thread) sizes the pool; :func:`set_channels`
changes it at run time.  Compression is opt-in per VA range through
:meth:`~.managed.ManagedBuffer.set_compressible`.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import List

from ..runtime import native

#: Registry key (env TPUMEM_TPUCE_CHANNELS) sizing the channel pool.
CHANNELS_KEY = "TPUMEM_TPUCE_CHANNELS"
DEFAULT_CHANNELS = 4
MAX_CHANNELS = 8

_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is not None:
        return _bound
    lib = native.load()
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    vp = ctypes.c_void_p
    lib.tpuCeMgrGet.argtypes = [u32]
    lib.tpuCeMgrGet.restype = vp
    lib.tpuCeMgrChannels.argtypes = [vp]
    lib.tpuCeMgrChannels.restype = u32
    lib.tpuCeChannelStats.argtypes = [vp, u32, ctypes.POINTER(u64),
                                      ctypes.POINTER(u64),
                                      ctypes.POINTER(u64)]
    lib.tpuCeChannelStats.restype = u32
    lib.tpuCeMgrDrain.argtypes = [vp]
    lib.tpuCeMgrDrain.restype = u32
    lib.tpuRegistryBump.argtypes = []
    lib.tpuRegistrySet.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.tpuRegistrySet.restype = None
    _bound = lib
    return lib


def _counter(name: str) -> int:
    return native.load().tpurmCounterGet(name.encode())


@dataclass(frozen=True)
class ChannelStats:
    """One logical channel's accounting."""

    index: int
    bytes: int           # bytes its executor moved (tpuce_ch{N}_bytes)
    busy_ns: int         # executor busy time (tpuce_ch{N}_busy_ns)
    outstanding: int     # submitted, not yet retired


@dataclass(frozen=True)
class CeStats:
    """Manager-wide snapshot (device 0 unless told otherwise)."""

    channels: List[ChannelStats]
    stripe_splits: int
    retries: int
    stripe_errors: int
    lossless_fallbacks: int
    compressed_bytes_in: int      # wire bytes, host->HBM uploads
    compressed_bytes_out: int     # wire bytes, HBM->host downloads
    compressed_bytes_raw: int     # raw bytes the compressed copies carried

    @property
    def total_bytes(self) -> int:
        return sum(c.bytes for c in self.channels)

    @property
    def compression_ratio(self) -> float:
        """Raw bytes per wire byte over every compressed copy (~4.0)."""
        wire = self.compressed_bytes_in + self.compressed_bytes_out
        return self.compressed_bytes_raw / wire if wire else 0.0


def channels(dev: int = 0) -> int:
    """Schedulable channel count (registry tpuce_channels, clamped)."""
    lib = _lib()
    m = lib.tpuCeMgrGet(dev)
    return int(lib.tpuCeMgrChannels(m)) if m else 0


def stats(dev: int = 0) -> CeStats:
    lib = _lib()
    m = lib.tpuCeMgrGet(dev)
    chans: List[ChannelStats] = []
    if m:
        n = lib.tpuCeMgrChannels(m)
        b = ctypes.c_uint64()
        busy = ctypes.c_uint64()
        out = ctypes.c_uint64()
        for i in range(n):
            if lib.tpuCeChannelStats(m, i, ctypes.byref(b),
                                     ctypes.byref(busy),
                                     ctypes.byref(out)) == 0:
                chans.append(ChannelStats(i, b.value, busy.value,
                                          out.value))
    return CeStats(
        channels=chans,
        stripe_splits=_counter("tpuce_stripe_splits"),
        retries=_counter("tpuce_retries"),
        stripe_errors=_counter("tpuce_stripe_errors"),
        lossless_fallbacks=_counter("tpuce_lossless_fallbacks"),
        compressed_bytes_in=_counter("tpuce_compressed_bytes_in"),
        compressed_bytes_out=_counter("tpuce_compressed_bytes_out"),
        compressed_bytes_raw=_counter("tpuce_compressed_bytes_raw"),
    )


def drain(dev: int = 0) -> None:
    """Fence every channel: work submitted before the call completes
    before this returns."""
    lib = _lib()
    m = lib.tpuCeMgrGet(dev)
    if not m:
        raise native.RmError(1, "tpuCeMgrGet")
    st = lib.tpuCeMgrDrain(m)
    if st != 0:
        raise native.RmError(st, "tpuCeMgrDrain")


def set_channels(n: int) -> int:
    """Resize the schedulable pool at runtime (bench A/B): writes the
    registry key through the native tpuRegistrySet (serialized against
    the rc/reset watchdogs' background polls, bumps the generation) so
    the next copy re-reads it.  Returns the count now in force."""
    if not 1 <= n <= MAX_CHANNELS:
        raise ValueError(f"channels must be 1..{MAX_CHANNELS}")
    lib = _lib()
    lib.tpuRegistrySet(CHANNELS_KEY.encode(), str(n).encode())
    return channels()
