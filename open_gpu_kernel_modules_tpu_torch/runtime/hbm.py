"""Real-HBM arena runtime: the consumer side of the native mirror stream,
on the card.

This is the piece that connects the native engine to the card.  The native
side (native/src/hbm.c) keeps the host arena as the coherent shadow of
device HBM and publishes dirty ranges on a per-device msgq (the GSP-msgq
analog).  Here a drain thread applies every dirty range to one persistent
uint8 tensor on the card, block by block, so the bytes the UVM engine
faulted into its HBM tier are resident in the card's memory and can be
read by any torch computation there.

Coherence protocol (the JAX package's ``runtime/hbm.py``, kept as it is):

- the engine writes the shadow and publishes [off, off+len) dirty;
- the drain thread coalesces dirty ranges to blocks and uploads whole
  blocks from the shadow (the shadow is coherent, so over-upload is safe);
  a block that still holds card-computed bytes (chip-dirty) is read back
  into the shadow first, so an upload never overwrites them;
- a dropped notify (the engine found the queue full, or its producer lock
  busy) latches an overflow, which degrades to a whole-arena resync,
  counted apart in ``resync_bytes``; the engine never blocks on this
  thread (fault service must not depend on it);
- the drain thread serves the engine's READBACK requests (card to shadow)
  in its loop; a readback covers whole dirty granules and skips blocks
  that were never uploaded (they hold nothing newer);
- ``fence()`` blocks until everything published so far is on the card.

On the card:

- The shadow (the engine's memfd arena) is page-locked with
  ``cudaHostRegister`` for the runtime's life, so block copies to and from
  it are asynchronous DMA.  A failed registration raises; there is no
  pageable fallback.  ``close()`` unregisters it.
- Every copy into or out of the card's arena runs on one copy stream of the
  runtime's own, so uploads, readbacks and installs keep their order.  The
  drain thread waits for that stream before it completes a batch, so
  ``fence()`` returns only once the covered bytes are on the card; a
  readback waits for it before the engine's dirty bits are cleared.
- Snapshot semantics.  ``read_arena`` and ``block`` return a new tensor,
  copied on the copy stream (so no later upload can change it) and handed
  to the caller's current stream through a stream wait and
  ``record_stream``.  ``write_arena`` makes the copy stream wait for the
  caller's current stream before it reads ``data``.
- The drain thread sets the card as its CUDA device.  Its waits on the copy
  stream release the GIL.

With ``device="cpu"`` (the tests) the same code runs with synchronous
copies into a host tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve
from . import native


class MsgqCmd(ctypes.Structure):
    """Mirror of TpuMsgqCmd (native/include/tpurm/msgq.h)."""

    _fields_ = [
        ("op", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("seq", ctypes.c_uint64),
        ("dst", ctypes.c_uint64),
        ("src", ctypes.c_uint64),
        ("bytes", ctypes.c_uint64),
        ("devInst", ctypes.c_uint32),
        ("_pad", ctypes.c_uint32),
        ("pbEnd", ctypes.c_uint64),
    ]


OP_HBM_MIRROR = 2
OP_FENCE = 3
OP_HBM_READBACK = 6

#: Mirror commands taken from the queue in one receive: the fault engine
#: runs far ahead of the uploads, so deep drains make few large batches.
RECEIVE_BATCH = 8192

#: Default upload block: the native copy engine's stripe
#: (``tpuce_stripe_bytes``, 512 KiB unless the registry sets it;
#: native/src/ce.c).  The engine publishes one dirty range per stripe it
#: copies, so blocks of that size upload each published range once.  With
#: 1 MiB blocks (the JAX package's default) a block is uploaded again for
#: each of its halves that arrives in another drain batch, and the bytes
#: uploaded exceed the bytes published.
BLOCK_BYTES = 512 << 10

_hbm_bound = False


def _lib() -> ctypes.CDLL:
    global _hbm_bound
    lib = native.load()
    if not _hbm_bound:
        u32, u64 = ctypes.c_uint32, ctypes.c_uint64
        lib.tpurmDeviceRegisterHbm.argtypes = [u32]
        lib.tpurmDeviceRegisterHbm.restype = u32
        lib.tpurmDeviceUnregisterHbm.argtypes = [u32]
        lib.tpurmDeviceUnregisterHbm.restype = None
        lib.tpurmDeviceArenaIsReal.argtypes = [u32]
        lib.tpurmDeviceArenaIsReal.restype = ctypes.c_int
        lib.tpurmHbmMirrorReceive.argtypes = [u32, ctypes.POINTER(MsgqCmd),
                                              u32]
        lib.tpurmHbmMirrorReceive.restype = u32
        lib.tpurmHbmMirrorComplete.argtypes = [u32, u64]
        lib.tpurmHbmMirrorComplete.restype = None
        lib.tpurmHbmMirrorConsumeOverflow.argtypes = [u32]
        lib.tpurmHbmMirrorConsumeOverflow.restype = ctypes.c_int
        lib.tpurmHbmFence.argtypes = [u32]
        lib.tpurmHbmFence.restype = u64
        lib.tpurmHbmWaitSeq.argtypes = [u32, u64]
        lib.tpurmHbmWaitSeq.restype = u32
        lib.tpurmHbmMarkChipDirty.argtypes = [u32, u64, u64]
        lib.tpurmHbmMarkChipDirty.restype = None
        lib.tpurmHbmChipDirtyTest.argtypes = [u32, u64, u64]
        lib.tpurmHbmChipDirtyTest.restype = ctypes.c_int
        lib.tpurmHbmChipDirtyNextSpan.argtypes = [
            u32, u64, u64, ctypes.POINTER(u64), ctypes.POINTER(u64)]
        lib.tpurmHbmChipDirtyNextSpan.restype = ctypes.c_int
        lib.tpurmHbmChipDirtyClear.argtypes = [u32, u64, u64]
        lib.tpurmHbmChipDirtyClear.restype = None
        lib.tpurmHbmReadback.argtypes = [u32, u64, u64]
        lib.tpurmHbmReadback.restype = u32
        lib.uvmHbmDeviceWroteRange.argtypes = [u32, u64, u64]
        lib.uvmHbmDeviceWroteRange.restype = u64
        lib.tpurmHbmMirrorIdle.argtypes = [u32]
        lib.tpurmHbmMirrorIdle.restype = ctypes.c_int
        lib.tpurmHbmChipDirtyGranule.argtypes = []
        lib.tpurmHbmChipDirtyGranule.restype = u64
        lib.tpuHbmMirrorNotify.argtypes = [ctypes.c_void_p, u64]
        lib.tpuHbmMirrorNotify.restype = None
        _hbm_bound = True
    return lib


def pin_host(base: int, size: int) -> None:
    """Page-lock [base, base+size) for the CUDA driver
    (``cudaHostRegister``); raises with CUDA's error when it fails."""
    cudart = torch.cuda.cudart()
    err = cudart.cudaHostRegister(base, size, 0)
    if int(err) != 0:
        raise RuntimeError(
            f"cudaHostRegister(0x{base:x}, {size}) failed: error "
            f"{int(err)} ({cudart.cudaGetErrorString(err)})")


def unpin_host(base: int) -> None:
    cudart = torch.cuda.cudart()
    err = cudart.cudaHostUnregister(base)
    if int(err) != 0:
        raise RuntimeError(
            f"cudaHostUnregister(0x{base:x}) failed: error {int(err)} "
            f"({cudart.cudaGetErrorString(err)})")


def _runs(ids: Iterable[int]) -> List[Tuple[int, int]]:
    """Sorted block ids as [first, last] runs of consecutive ids."""
    runs: List[Tuple[int, int]] = []
    for b in sorted(ids):
        if runs and runs[-1][1] == b - 1:
            runs[-1] = (runs[-1][0], b)
        else:
            runs.append((b, b))
    return runs


class HbmRuntime:
    """Registers a device arena as REAL and drains its mirror stream into a
    persistent uint8 tensor of the arena's size on ``device``.

    ``device=None`` means the CUDA card (raises without CUDA); the tests
    pass ``device="cpu"``.  Whole-block uploads from the coherent shadow
    keep the copies large; consecutive blocks go in one copy.
    """

    def __init__(self, dev: int = 0, block_bytes: int = BLOCK_BYTES,
                 device: DeviceLike = None):
        self.device = resolve(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._lib = _lib()
        self.dev = dev
        self.block_bytes = block_bytes

        base, size = native.hbm_view(dev)
        self.arena_bytes = size
        self._base = base
        self._shadow = np.frombuffer(
            (ctypes.c_char * size).from_address(base), dtype=np.uint8)
        self._shadow_t = torch.from_numpy(self._shadow)
        self._granule = int(self._lib.tpurmHbmChipDirtyGranule())
        self.n_blocks = math.ceil(size / block_bytes)
        self._arena = torch.empty(size, dtype=torch.uint8,
                                  device=self.device)
        # False = never uploaded: uploaded lazily from the shadow on first
        # read, and skipped by readbacks (it holds nothing newer).
        self._present = [False] * self.n_blocks
        # Serializes whole coherence transactions (merge+upload on the
        # drain side, install+mark on the write_arena side) so a stale-
        # shadow upload can never clobber a just-installed card write.
        # RLock: _ensure -> _upload_blocks nests under write_arena.
        self._coh_lock = threading.RLock()
        self.mirrored_bytes = 0
        self.resync_bytes = 0    # whole-arena resync uploads (overflow)
        self.resyncs = 0
        self.drain_batches = 0
        self.upload_calls = 0
        self.upload_seconds = 0.0
        self.readbacks = 0
        self.readback_bytes = 0
        self._drain_error: Optional[BaseException] = None
        self._drain_thread: Optional[threading.Thread] = None

        self._stream = None
        self._pinned = False
        if self._cuda:
            self._stream = torch.cuda.Stream(device=self.device)
            pin_host(base, size)
            self._pinned = True
        st = self._lib.tpurmDeviceRegisterHbm(dev)
        if st != 0:
            self._release()
            raise native.RmError(st, "tpurmDeviceRegisterHbm")
        self._drain_thread = threading.Thread(
            target=self._drain, name=f"hbm-mirror-{dev}", daemon=True)
        self._drain_thread.start()

    # ------------------------------------------------------------ copies

    def _on_copy_stream(self):
        return (torch.cuda.stream(self._stream) if self._cuda
                else contextlib.nullcontext())

    def _wait_copies(self) -> None:
        """Block until every copy queued on the copy stream has finished
        (the wait releases the GIL)."""
        if self._cuda:
            self._stream.synchronize()

    def _span(self, first: int, last: int) -> Tuple[int, int]:
        """Arena bytes of blocks first..last."""
        return (first * self.block_bytes,
                min((last + 1) * self.block_bytes, self.arena_bytes))

    def _snapshot(self, lo: int, hi: int) -> torch.Tensor:
        """A new tensor holding the card's arena [lo, hi), copied on the
        copy stream after every upload queued so far, and ready on the
        caller's current stream."""
        if not self._cuda:
            return self._arena[lo:hi].clone()
        caller = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            out = self._arena[lo:hi].clone()
        caller.wait_stream(self._stream)
        out.record_stream(caller)
        return out

    # ------------------------------------------------------------- drain

    def _upload_blocks(self, block_ids: Iterable[int]) -> None:
        ids = sorted(set(block_ids))
        if not ids:
            return
        t0 = time.perf_counter()
        nbytes = 0
        with self._coh_lock:
            # Card->host direction first: a block that still holds card-
            # computed pages must have them read back into the shadow
            # before a whole-block upload republishes it, or the upload
            # would overwrite the card's bytes with stale shadow bytes.
            for b in ids:
                lo, hi = self._span(b, b)
                if self._lib.tpurmHbmChipDirtyTest(self.dev, lo, hi - lo):
                    self._readback_merge(lo, hi - lo)
            # Straight from the pinned shadow, no staging copy.  The engine
            # may redirty a span while its copy is in flight, but a redirty
            # REPUBLISHES the range, so a later upload (behind this one on
            # the same stream) supersedes whatever torn bytes this one
            # carried.
            with self._on_copy_stream():
                for first, last in _runs(ids):
                    lo, hi = self._span(first, last)
                    self._arena[lo:hi].copy_(self._shadow_t[lo:hi],
                                             non_blocking=self._cuda)
                    nbytes += hi - lo
            self._wait_copies()
            for b in ids:
                self._present[b] = True
            # Under the lock: a caller's lazy upload can race the drain's.
            self.mirrored_bytes += nbytes
            self.upload_calls += 1
            self.upload_seconds += time.perf_counter() - t0

    def _ensure(self, first: int, last: int) -> None:
        """Upload the blocks of first..last that were never uploaded."""
        missing = [b for b in range(first, last + 1) if not self._present[b]]
        if missing:
            self._upload_blocks(missing)

    def _readback_merge(self, offset: int, length: int) -> None:
        """Copy the chip-dirty pages of [offset, offset+length) from the
        card into the shadow and clear their dirty bits: the card->host op
        the native engine blocks on."""
        u64 = ctypes.c_uint64
        # Round the request out to dirty-granule boundaries: the native
        # clear below is granule-granular, so merging only a byte
        # sub-range of a granule would clear its bit while leaving
        # card-newer bytes outside the sub-range untracked (data loss).
        gran = self._granule
        start = (offset // gran) * gran
        end = min(-(-(offset + length) // gran) * gran, self.arena_bytes)
        spans: List[Tuple[int, int]] = []
        pos = start
        lo, hi = u64(), u64()
        with self._coh_lock:
            while pos < end and self._lib.tpurmHbmChipDirtyNextSpan(
                    self.dev, pos, end, ctypes.byref(lo),
                    ctypes.byref(hi)):
                spans.append((lo.value, hi.value))
                pos = hi.value
            if not spans:
                return
            with self._on_copy_stream():
                for s_lo, s_hi in spans:
                    b_first = s_lo // self.block_bytes
                    b_last = (s_hi - 1) // self.block_bytes
                    for b in range(b_first, b_last + 1):
                        # A block never uploaded holds nothing newer; either
                        # way the span is coherent once its bits clear.
                        if not self._present[b]:
                            continue
                        blk_lo, blk_hi = self._span(b, b)
                        c_lo, c_hi = max(s_lo, blk_lo), min(s_hi, blk_hi)
                        # Card truth -> shadow (direct write, no mirror
                        # notify: shadow == card afterwards by construction).
                        self._shadow_t[c_lo:c_hi].copy_(
                            self._arena[c_lo:c_hi], non_blocking=self._cuda)
                        self.readback_bytes += c_hi - c_lo
            # The bytes must be in the shadow before the engine, released
            # by the cleared bits, reads it.
            self._wait_copies()
            for s_lo, s_hi in spans:
                self._lib.tpurmHbmChipDirtyClear(self.dev, s_lo, s_hi - s_lo)
            self.readbacks += 1

    def _drain(self) -> None:
        buf = (MsgqCmd * RECEIVE_BATCH)()
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            while True:
                n = self._lib.tpurmHbmMirrorReceive(self.dev, buf,
                                                    RECEIVE_BATCH)
                if n == 0:      # queue shut down (unregister/close)
                    return
                self.drain_batches += 1
                if self._lib.tpurmHbmMirrorConsumeOverflow(self.dev):
                    # A notify was dropped: everything is suspect.  Resync
                    # the whole arena from the coherent shadow, accounted
                    # apart so it never inflates workload throughput.
                    self.resyncs += 1
                    pre = self.mirrored_bytes
                    self._upload_blocks(range(self.n_blocks))
                    self.resync_bytes += self.mirrored_bytes - pre
                dirty = set()
                for i in range(n):
                    cmd = buf[i]
                    if cmd.op == OP_HBM_MIRROR:
                        first = cmd.dst // self.block_bytes
                        last = (cmd.dst + cmd.bytes - 1) // self.block_bytes
                        dirty.update(range(int(first), int(last) + 1))
                    elif cmd.op == OP_HBM_READBACK:
                        # The engine is blocked on card->host coherence:
                        # pull the chip-dirty pages into the shadow.  Safe
                        # before this batch's uploads: a mirror of the same
                        # span can only be queued AFTER the requester sees
                        # completion (it holds the write until then).
                        self._readback_merge(int(cmd.dst), int(cmd.bytes))
                    # OP_FENCE carries no payload: completing the batch
                    # (below, after the uploads) releases its waiters.
                self._upload_blocks(dirty)
                self._lib.tpurmHbmMirrorComplete(self.dev, buf[n - 1].seq)
        except BaseException as exc:   # noqa: BLE001 — must not die silent
            # A dead consumer must fail fast, not hang fences forever:
            # record the error and close the stream (shutdown wakes every
            # tpurmHbmWaitSeq, which then returns an error status).
            self._drain_error = exc
            self._lib.tpurmDeviceUnregisterHbm(self.dev)

    # --------------------------------------------------------------- API

    def fence(self) -> None:
        """Block until every dirty range published so far is on the card."""
        if self._drain_error is not None:
            raise RuntimeError("HBM mirror drain thread died"
                               ) from self._drain_error
        if self._lib.tpurmHbmMirrorIdle(self.dev):
            return          # nothing outstanding: skip the round trip
        seq = self._lib.tpurmHbmFence(self.dev)
        st = self._lib.tpurmHbmWaitSeq(self.dev, seq)
        if self._drain_error is not None:
            raise RuntimeError("HBM mirror drain thread died"
                               ) from self._drain_error
        if st != 0:
            raise native.RmError(st, "tpurmHbmWaitSeq")

    def block(self, idx: int) -> torch.Tensor:
        """A snapshot of arena block ``idx`` on the device (lazy upload)."""
        self._ensure(idx, idx)
        return self._snapshot(*self._span(idx, idx))

    def read_arena(self, offset: int, length: int) -> torch.Tensor:
        """Arena [offset, offset+length) as a new uint8 tensor on the
        device.

        Fences first so every dirty range published by the engine up to
        this call is applied; the bytes come from the card's arena, not the
        shadow, and include card writes installed by ``write_arena``.  No
        later upload changes the returned tensor."""
        if offset < 0 or length < 0 or offset + length > self.arena_bytes:
            raise ValueError("arena range out of bounds")
        self.fence()
        if length:
            self._ensure(offset // self.block_bytes,
                         (offset + length - 1) // self.block_bytes)
        return self._snapshot(offset, offset + length)

    def write_arena(self, offset: int, data, sync: bool = True) -> None:
        """Install device-computed bytes as the new content of arena
        [offset, offset+len(data)): the card->host direction of the
        boundary.

        ``data`` is anything ``torch.as_tensor(..., dtype=torch.uint8)``
        takes, flattened and moved to the device (a tensor already there
        stays there: no host round trip for the install).  The span is
        marked CHIP-DIRTY in the native engine: until read back,
        evictions, CPU-fault service, CXL DMA and RDMA pinning over it
        block on a READBACK op instead of trusting the shadow.

        sync=True (default) performs that readback before returning
        (ctypes releases the GIL, so the drain thread can serve it);
        sync=False leaves the window open, and engine reads pull the bytes
        on demand.  NOTE: with sync=False, OTHER Python threads must not
        CPU-touch managed pages backed by this span until a sync point: a
        faulting thread parks holding the GIL, which starves the drain
        thread.  Touch them through ctypes (``ctypes.memmove``, ``migrate``),
        which releases the GIL."""
        data = torch.as_tensor(data, dtype=torch.uint8).reshape(-1)
        length = data.numel()
        if offset < 0 or offset + length > self.arena_bytes:
            raise ValueError("arena range out of bounds")
        if length == 0:
            return
        # Apply everything the engine published before this install;
        # otherwise a queued (older) host write could later be uploaded over
        # the card's bytes without the merge seeing a dirty bit.
        self.fence()
        data = data.to(self.device)
        # Chip-dirty marking must never cover bytes the device did NOT
        # write: the bitmap is granule-granular, and a whole-granule mark
        # over a partial write would let a later merge revert a concurrent
        # engine write elsewhere in the same granule.  So the granule-
        # ALIGNED interior is installed on the device and marked, while
        # partial boundary granules take the host path (shadow write +
        # mirror notify, immediately authoritative).
        gran = self._granule
        end = offset + length
        a_lo = min(-(-offset // gran) * gran, end)
        a_hi = max((end // gran) * gran, a_lo)
        if a_hi > a_lo:
            with self._coh_lock:
                # The rest of a partly covered block must be valid on the
                # card before part of it is replaced.
                self._ensure(a_lo // self.block_bytes,
                             (a_hi - 1) // self.block_bytes)
                piece = data[a_lo - offset:a_hi - offset]
                if self._cuda:
                    self._stream.wait_stream(
                        torch.cuda.current_stream(self.device))
                    piece.record_stream(self._stream)
                with self._on_copy_stream():
                    self._arena[a_lo:a_hi].copy_(piece,
                                                 non_blocking=self._cuda)
                self._lib.tpurmHbmMarkChipDirty(self.dev, a_lo, a_hi - a_lo)
        for s_lo, s_hi in ((offset, a_lo), (a_hi, end)):
            if s_lo >= s_hi:
                continue
            # If an earlier device write left this granule chip-dirty, read
            # it back first so the shadow write + republish can't revert
            # those bytes.
            g_lo = (s_lo // gran) * gran
            g_hi = min(-(-s_hi // gran) * gran, self.arena_bytes)
            if self._lib.tpurmHbmChipDirtyTest(self.dev, g_lo, g_hi - g_lo):
                self._lib.tpurmHbmReadback(self.dev, g_lo, g_hi - g_lo)
            self._shadow_t[s_lo:s_hi] = data[s_lo - offset:s_hi - offset].cpu()
            self._lib.tpuHbmMirrorNotify(self._base + s_lo, s_hi - s_lo)
        # OUTSIDE _coh_lock (the walk takes engine block locks, and an
        # engine thread may hold one while blocked on a readback that needs
        # _coh_lock): drop stale CPU/CXL duplicates of managed pages backed
        # by the span, since the device write takes exclusivity.
        self._lib.uvmHbmDeviceWroteRange(self.dev, offset, length)
        if sync and a_hi > a_lo:
            st = self._lib.tpurmHbmReadback(self.dev, a_lo, a_hi - a_lo)
            if st != 0:
                raise native.RmError(st, "tpurmHbmReadback")

    @contextlib.contextmanager
    def hold_drain(self):
        """Test hook: the drain thread stops before its next upload until
        the block exits, so ranges published meanwhile pile up in the
        mirror queue (how a test forces its overflow).  The engine never
        waits on the drain thread, so publishing here cannot block."""
        with self._coh_lock:
            yield

    @property
    def is_real(self) -> bool:
        return bool(self._lib.tpurmDeviceArenaIsReal(self.dev))

    @property
    def shadow_pinned(self) -> bool:
        """Whether the CUDA driver sees the shadow as page-locked."""
        return self._cuda and self._shadow_t.is_pinned()

    def _release(self) -> None:
        """Finish the copy stream's work, unpin the shadow and free the
        card's arena."""
        if self._cuda:
            self._stream.synchronize()
        if self._pinned:
            unpin_host(self._base)
            self._pinned = False
        self._arena = None

    def close(self) -> None:
        if self._drain_thread is None:
            return
        # Save semantics: card-computed bytes must survive the detach, so
        # read every chip-dirty page back into the shadow before the arena
        # falls back to FAKE.  A dead drain thread skips it.
        if self._drain_error is None:
            self._lib.tpurmHbmReadback(self.dev, 0, self.arena_bytes)
        self._lib.tpurmDeviceUnregisterHbm(self.dev)
        self._drain_thread.join(timeout=10)
        if self._drain_thread.is_alive():
            raise RuntimeError("HBM mirror drain thread did not stop")
        self._drain_thread = None
        self._release()

    def __enter__(self) -> "HbmRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
