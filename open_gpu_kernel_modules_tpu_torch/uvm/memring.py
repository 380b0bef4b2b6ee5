"""tpumemring — io_uring-style async memory-op rings (native/src/memring.c).

The port's own copy of the part of the JAX package's ``uvm/memring.py``
that the tiered KV backing, the scheduler and the vac migration engine use: a
``MemRing`` bound to a VA space (or to none, for ICI peer copies only) that
stages device-access PREFETCH, tier-demote EVICT and ICI PEER_COPY ops,
publishes them with one doorbell, waits for the batch and reaps per-op
completions.  The native worker pool coalesces contiguous spans into
block-granular engine calls.  Errors come back per op;
``completions(check=True)`` raises :class:`native.RmError` on the first
error completion.

Ordering: every staged op gets a submission seq (:attr:`MemRing.last_seq`
right after its prep), and a later op may carry up to 4 ``deps=[...]``
handles built with :func:`dep`.  ``dep(ring, seq, ordered=True)`` waits
for the ring's retirement frontier to pass ``seq`` (every op up to it
retired): the scheduler's restore prefetches wait so on the victims'
demotes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
from typing import List, Optional

from ..runtime import native
from .managed import Tier


class Op(enum.IntEnum):
    """Opcodes (memring.h TPU_MEMRING_OP_*)."""

    NOP = 0
    MIGRATE = 1
    PREFETCH = 2
    EVICT = 3
    ADVISE = 4
    PEER_COPY = 5
    FENCE = 6


NDEPS = 4                      # dep slots per SQE (memring.h)
DEP_SEQ_BITS = 47
DEP_ORDERED_FLAG = 1 << DEP_SEQ_BITS
DEP_RING_SHIFT = 48


def dep(ring, seq: int, ordered: bool = False) -> int:
    """A dependency handle on (``ring``, ``seq``): ``ring`` is a
    :class:`MemRing` or a raw ring id (``MemRing.ring_id``), ``seq`` the
    target op's submission seq (``MemRing.last_seq`` after its prep).
    ``ordered=True`` waits for the retirement frontier to pass the target:
    every seq up to it retired."""
    rid = ring.ring_id if isinstance(ring, MemRing) else int(ring)
    h = ((rid & 0xFFFF) << DEP_RING_SHIFT) | (seq & ((1 << DEP_SEQ_BITS) - 1))
    if ordered:
        h |= DEP_ORDERED_FLAG
    return h


class _Sqe(ctypes.Structure):
    # 128-byte SQE128 layout (memring.h).
    _fields_ = [
        ("opcode", ctypes.c_uint8),
        ("flags", ctypes.c_uint8),
        ("dstTier", ctypes.c_uint16),
        ("devInst", ctypes.c_uint32),
        ("addr", ctypes.c_uint64),
        ("len", ctypes.c_uint64),
        ("userData", ctypes.c_uint64),
        ("peerInst", ctypes.c_uint32),
        ("arg0", ctypes.c_uint32),
        ("peerOff", ctypes.c_uint64),
        ("arg1", ctypes.c_uint64),
        ("deadlineNs", ctypes.c_uint64),
        ("deps", ctypes.c_uint64 * NDEPS),
        ("depCount", ctypes.c_uint32),
        ("rsvd0", ctypes.c_uint32),
        ("seq", ctypes.c_uint64),
        ("flowId", ctypes.c_uint64),
        ("rsvd1", ctypes.c_uint64),
    ]


class _Cqe(ctypes.Structure):
    _fields_ = [
        ("userData", ctypes.c_uint64),
        ("status", ctypes.c_uint32),
        ("opcode", ctypes.c_uint32),
        ("bytes", ctypes.c_uint64),
        ("seq", ctypes.c_uint64),
        ("startNs", ctypes.c_uint64),
        ("endNs", ctypes.c_uint64),
        ("pad", ctypes.c_uint64 * 2),
    ]


@dataclasses.dataclass(frozen=True)
class Completion:
    """One reaped CQE."""

    user_data: int
    status: int
    opcode: Op
    bytes: int
    seq: int
    start_ns: int
    end_ns: int

    @property
    def ok(self) -> bool:
        return self.status == 0


_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is not None:
        return _bound
    lib = native.load()
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    vp = ctypes.c_void_p
    lib.tpurmMemringCreate.argtypes = [vp, u32, u32, ctypes.POINTER(vp)]
    lib.tpurmMemringCreate.restype = u32
    lib.tpurmMemringDestroy.argtypes = [vp]
    lib.tpurmMemringDestroy.restype = None
    lib.tpurmMemringPrep.argtypes = [vp, ctypes.POINTER(_Sqe)]
    lib.tpurmMemringPrep.restype = u32
    lib.tpurmMemringSubmit.argtypes = [vp]
    lib.tpurmMemringSubmit.restype = u32
    lib.tpurmMemringReap.argtypes = [vp, ctypes.POINTER(_Cqe), u32]
    lib.tpurmMemringReap.restype = u32
    lib.tpurmMemringWait.argtypes = [vp, u32, u64]
    lib.tpurmMemringWait.restype = u32
    lib.tpurmMemringWaitDrain.argtypes = [vp, u64]
    lib.tpurmMemringWaitDrain.restype = u32
    lib.tpurmMemringSqSpace.argtypes = [vp]
    lib.tpurmMemringSqSpace.restype = u32
    lib.tpurmMemringId.argtypes = [vp]
    lib.tpurmMemringId.restype = u32
    _bound = lib
    return lib


def _check(status: int, what: str) -> None:
    if status != 0:
        raise native.RmError(status, what)


class MemRing:
    """An async memory-op ring bound to a UVM VA space, or to none
    (``vs=None``: a ring that ships only ICI peer copies).

    Destroy the ring before closing the space.  The prep methods stage
    SQEs; nothing reaches the workers until :meth:`submit`.  Unlinked ops
    run concurrently on the worker pool.
    """

    def __init__(self, vs, entries: int = 256):
        self._lib = _lib()
        handle = ctypes.c_void_p()
        # workers=0: the engine's default worker pool.
        vs_handle = vs._handle if vs is not None else None
        _check(self._lib.tpurmMemringCreate(vs_handle, entries, 0,
                                            ctypes.byref(handle)),
               "tpurmMemringCreate")
        self._handle = handle
        self._auto_cookie = 0
        self._last_seq: Optional[int] = None

    def _prep(self, sqe: _Sqe, deps=None) -> int:
        self._auto_cookie += 1
        sqe.userData = self._auto_cookie
        if deps:
            if len(deps) > NDEPS:
                raise ValueError(f"at most {NDEPS} deps per op")
            for i, d in enumerate(deps):
                sqe.deps[i] = d
            sqe.depCount = len(deps)
        _check(self._lib.tpurmMemringPrep(self._handle, ctypes.byref(sqe)),
               "tpurmMemringPrep")
        self._last_seq = sqe.seq
        return sqe.userData

    @property
    def ring_id(self) -> int:
        """This ring's dep-handle identity (for :func:`dep`)."""
        return self._lib.tpurmMemringId(self._handle)

    @property
    def last_seq(self) -> Optional[int]:
        """Submission seq of the most recently prepped op."""
        return self._last_seq

    def prefetch(self, addr: int, length: int, dev: int = 0,
                 deps=None, flow: int = 0) -> int:
        """Stage a device-access (read) prefetch: fault the span onto
        ``dev``'s HBM through the batch service loop.  ``deps`` holds up to
        4 :func:`dep` handles the op waits on; ``flow`` tags the op with a
        tpuflow request identity.  Returns the op's cookie."""
        s = _Sqe(opcode=Op.PREFETCH, devInst=dev, addr=addr, len=length,
                 flowId=flow)
        return self._prep(s, deps)

    def evict(self, addr: int, length: int, tier: Tier,
              flow: int = 0) -> int:
        """Stage a tier demote of [addr, addr+length) to ``tier`` (HOST or
        CXL only)."""
        s = _Sqe(opcode=Op.EVICT, dstTier=int(tier), addr=addr, len=length,
                 flowId=flow)
        return self._prep(s)

    def peer_copy(self, dev: int, peer: int, local_off: int,
                  peer_off: int, length: int, read: bool = False,
                  deps=None, flow: int = 0) -> int:
        """Stage an ICI peer copy between HBM arena offsets (write:
        ``dev``'s ``local_off`` -> ``peer``'s ``peer_off``; ``read=True``
        the other way).  The vac migration engine puts an ordered dep on
        the previous shipping window in ``deps``, so page records land in
        manifest order."""
        s = _Sqe(opcode=Op.PEER_COPY, devInst=dev, peerInst=peer,
                 addr=local_off, peerOff=peer_off, len=length,
                 arg0=1 if read else 0, flowId=flow)
        return self._prep(s, deps)

    def submit(self) -> int:
        """Publish every staged SQE (one doorbell); returns the count."""
        return self._lib.tpurmMemringSubmit(self._handle)

    def submit_and_wait(self, wait_for: Optional[int] = None) -> int:
        """Submit, then park until the work completes: every op submitted
        so far (``wait_for=None``), or ``wait_for`` reapable CQEs.  RmError
        on a wait timeout or a dropped-CQE bail."""
        n = self.submit()
        if wait_for is None:
            self.drain()
        elif wait_for:
            self.wait(wait_for)
        return n

    def drain(self) -> None:
        """Park until every op submitted so far has completed."""
        _check(self._lib.tpurmMemringWaitDrain(self._handle, 0),
               "tpurmMemringWaitDrain")

    def wait(self, n: int) -> None:
        """Park until ``n`` CQEs are reapable."""
        _check(self._lib.tpurmMemringWait(self._handle, n, 0),
               "tpurmMemringWait")

    def completions(self, max_cqes: int = 1024,
                    check: bool = False) -> List[Completion]:
        """Reap up to ``max_cqes``.  ``check=True`` raises RmError on the
        first error completion (after draining the batch)."""
        buf = (_Cqe * max_cqes)()
        n = self._lib.tpurmMemringReap(self._handle, buf, max_cqes)
        out = [Completion(c.userData, c.status, Op(c.opcode), c.bytes,
                          c.seq, c.startNs, c.endNs) for c in buf[:n]]
        if check:
            for c in out:
                if not c.ok:
                    raise native.RmError(
                        c.status, f"memring op {c.opcode.name} "
                                  f"user_data={c.user_data}")
        return out

    @property
    def sq_space(self) -> int:
        return self._lib.tpurmMemringSqSpace(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.tpurmMemringDestroy(self._handle)
            self._handle = None
