"""tpumemring — io_uring-style async memory-op rings (native/src/memring.c).

The port's own copy of the JAX package's ``uvm/memring.py``: a ``MemRing``
bound to a VA space (or to none, for NOP, FENCE and ICI peer copies only)
that stages MIGRATE, device-access PREFETCH, tier-demote EVICT, ADVISE
(policy), PEER_COPY, FENCE and NOP ops, publishes them with one doorbell,
waits for the batch and reaps per-op completions carrying the ``user_data``
cookie, status and bytes moved. The native worker pool coalesces contiguous
spans into block-granular engine calls. Errors come back per op;
``completions(check=True)`` raises :class:`native.RmError` on the first
error completion.

Ordering: every staged op gets a submission seq (:attr:`MemRing.last_seq`
right after its prep), and a later op may carry up to 4 ``deps=[...]``
handles built with :func:`dep`.  ``dep(ring, seq, ordered=True)`` waits
for the ring's retirement frontier to pass ``seq`` (every op up to it
retired): the scheduler's restore prefetches wait so on the victims'
demotes.  :func:`dep_batch` names an earlier op of the batch being staged.
``link=True`` chains an op to the next (a failure cancels the rest of the
chain with error completions), and ``fence()`` completes only after every
op submitted before it has posted its completion.
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


class Advise(enum.IntEnum):
    """ADVISE subcodes."""

    PREFERRED = 1
    UNSET_PREFERRED = 2
    ACCESSED_BY = 3
    UNSET_ACCESSED_BY = 4
    READ_DUP = 5
    COMPRESSIBLE = 6     # arg1 = Compress format (UVM_ADVISE_COMPRESSIBLE)


SQE_LINK = 0x1
SQE_WRITE = 0x2

NDEPS = 4                      # dep slots per SQE (memring.h)
DEP_SEQ_BITS = 47
DEP_ORDERED_FLAG = 1 << DEP_SEQ_BITS
DEP_RING_SHIFT = 48
DEP_BATCH = 0xFFFF             # intra-batch index pseudo-ring


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


def dep_batch(index: int, ordered: bool = False) -> int:
    """A dependency on the ``index``-th op of the batch being staged (not yet
    published); the prep rewrites it to an absolute handle and refuses an
    index that does not point backwards."""
    return dep(DEP_BATCH, index, ordered)


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


@dataclasses.dataclass(frozen=True)
class RingCounts:
    submitted: int
    completed: int
    error_cqes: int
    cq_overflows: int


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
    lib.tpurmMemringCounts.argtypes = [vp, ctypes.POINTER(u64),
                                       ctypes.POINTER(u64),
                                       ctypes.POINTER(u64),
                                       ctypes.POINTER(u64)]
    lib.tpurmMemringCounts.restype = None
    lib.tpurmMemringShmFd.argtypes = [vp]
    lib.tpurmMemringShmFd.restype = ctypes.c_int
    lib.tpurmMemringNextSeq.argtypes = [vp]
    lib.tpurmMemringNextSeq.restype = u64
    _bound = lib
    return lib


def _check(status: int, what: str) -> None:
    if status != 0:
        raise native.RmError(status, what)


class MemRing:
    """An async memory-op ring bound to a UVM VA space, or to none
    (``vs=None``: a ring that ships only ICI peer copies).

    Destroy the ring before closing the space (or use it as a context
    manager).  The prep methods stage SQEs; nothing reaches the workers
    until :meth:`submit`.  Unlinked ops run concurrently on the worker pool
    (``workers=0``: the engine's default pool).
    """

    def __init__(self, vs=None, entries: int = 256, workers: int = 0):
        self._lib = _lib()
        handle = ctypes.c_void_p()
        vs_handle = vs._handle if vs is not None else None
        _check(self._lib.tpurmMemringCreate(vs_handle, entries, workers,
                                            ctypes.byref(handle)),
               "tpurmMemringCreate")
        self._handle = handle
        self._auto_cookie = 0
        self._last_seq: Optional[int] = None

    def _prep(self, sqe: _Sqe, deps=None) -> int:
        if sqe.userData == 0:
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

    @property
    def next_seq(self) -> int:
        """The seq the next prep will be assigned."""
        return self._lib.tpurmMemringNextSeq(self._handle)

    # Every prep returns the op's cookie: ``user_data``, or the next auto
    # cookie when it is 0.  ``link`` chains the op to the next one,
    # ``deadline_ns`` (absolute, the utils clock) fails the op with
    # RETRY_EXHAUSTED when it is claimed later, ``deps`` holds up to 4
    # :func:`dep` handles it waits on, and ``flow`` is the tpuflow request
    # identity it runs under (utils.flow_mint).

    def migrate(self, addr: int, length: int, tier: Tier, dev: int = 0,
                user_data: int = 0, link: bool = False,
                deadline_ns: int = 0, deps=None, flow: int = 0) -> int:
        """Stage a migrate of [addr, addr+length) to ``tier`` (on ``dev``
        for HBM)."""
        s = _Sqe(opcode=Op.MIGRATE, flags=SQE_LINK if link else 0,
                 dstTier=int(tier), devInst=dev, addr=addr, len=length,
                 userData=user_data, deadlineNs=deadline_ns, flowId=flow)
        return self._prep(s, deps)

    def prefetch(self, addr: int, length: int, dev: int = 0,
                 write: bool = False, user_data: int = 0,
                 link: bool = False, deadline_ns: int = 0,
                 deps=None, flow: int = 0) -> int:
        """Stage a device-access prefetch (a write access with ``write``):
        fault the span onto ``dev``'s HBM through the batch service
        loop."""
        flags = (SQE_LINK if link else 0) | (SQE_WRITE if write else 0)
        s = _Sqe(opcode=Op.PREFETCH, flags=flags, devInst=dev, addr=addr,
                 len=length, userData=user_data, deadlineNs=deadline_ns,
                 flowId=flow)
        return self._prep(s, deps)

    def evict(self, addr: int, length: int, tier: Tier = Tier.HOST,
              user_data: int = 0, link: bool = False,
              deadline_ns: int = 0, deps=None, flow: int = 0) -> int:
        """Stage a tier demote of [addr, addr+length) to ``tier`` (HOST or
        CXL only)."""
        s = _Sqe(opcode=Op.EVICT, flags=SQE_LINK if link else 0,
                 dstTier=int(tier), addr=addr, len=length,
                 userData=user_data, deadlineNs=deadline_ns, flowId=flow)
        return self._prep(s, deps)

    def advise(self, addr: int, length: int, advice: Advise,
               tier: Tier = Tier.HOST, dev: int = 0, on: bool = True,
               user_data: int = 0, link: bool = False,
               arg: Optional[int] = None) -> int:
        """Stage a policy op (preferred tier, accessed-by, read
        duplication, compressible).  ``arg`` replaces the on/off payload of
        a subcode that carries a value (COMPRESSIBLE: a Compress
        format)."""
        s = _Sqe(opcode=Op.ADVISE, flags=SQE_LINK if link else 0,
                 dstTier=int(tier), devInst=dev, addr=addr, len=length,
                 userData=user_data, arg0=int(advice),
                 arg1=(1 if on else 0) if arg is None else int(arg))
        return self._prep(s)

    def peer_copy(self, dev: int, peer: int, local_off: int,
                  peer_off: int, length: int, read: bool = False,
                  user_data: int = 0, link: bool = False,
                  deps=None, flow: int = 0) -> int:
        """Stage an ICI peer copy between HBM arena offsets (write:
        ``dev``'s ``local_off`` -> ``peer``'s ``peer_off``; ``read=True``
        the other way).  The vac migration engine puts an ordered dep on
        the previous shipping window in ``deps``, so page records land in
        manifest order."""
        s = _Sqe(opcode=Op.PEER_COPY, flags=SQE_LINK if link else 0,
                 devInst=dev, peerInst=peer, addr=local_off,
                 peerOff=peer_off, len=length, userData=user_data,
                 arg0=1 if read else 0, flowId=flow)
        return self._prep(s, deps)

    def fence(self, user_data: int = 0) -> int:
        """Stage a fence: it completes only after every op submitted before
        it has posted its completion, and later ops wait for it."""
        return self._prep(_Sqe(opcode=Op.FENCE, userData=user_data))

    def nop(self, user_data: int = 0, delay_ns: int = 0,
            deadline_ns: int = 0, deps=None, flow: int = 0) -> int:
        """Stage a NOP.  ``delay_ns`` makes the worker sleep that long before
        completing it (a deterministic hung op).  A NOP with ``deps`` joins
        its targets without fencing unrelated later traffic."""
        s = _Sqe(opcode=Op.NOP, userData=user_data, arg1=delay_ns,
                 deadlineNs=deadline_ns, flowId=flow)
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

    def drain(self, timeout_ns: int = 0) -> None:
        """Park until every op submitted so far has completed; RmError on a
        timeout (0: the engine's default)."""
        _check(self._lib.tpurmMemringWaitDrain(self._handle, timeout_ns),
               "tpurmMemringWaitDrain")

    def wait(self, n: int, timeout_ns: int = 0) -> None:
        """Park until ``n`` CQEs are reapable; RmError on a timeout."""
        _check(self._lib.tpurmMemringWait(self._handle, n, timeout_ns),
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

    @property
    def counts(self) -> RingCounts:
        sub, comp = ctypes.c_uint64(), ctypes.c_uint64()
        err, ovf = ctypes.c_uint64(), ctypes.c_uint64()
        self._lib.tpurmMemringCounts(self._handle, ctypes.byref(sub),
                                     ctypes.byref(comp), ctypes.byref(err),
                                     ctypes.byref(ovf))
        return RingCounts(sub.value, comp.value, err.value, ovf.value)

    def shm_fd(self) -> int:
        """The memfd backing the ring region (header, SQ and CQ)."""
        return self._lib.tpurmMemringShmFd(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.tpurmMemringDestroy(self._handle)
            self._handle = None

    def __enter__(self) -> "MemRing":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
