"""ctypes bindings for the native UVM engine (native/include/tpurm/uvm.h).

The port's own copy of the JAX package's ``uvm/managed.py``, with the same
names: tiers, compression formats and tools event types; VA spaces and
managed buffers (migrate, device access, policies: preferred location,
accessed-by, read duplication, compressible); residency, fault statistics
and their latency windows; PM suspend and resume; tenant QoS quotas; and
the tools event sessions, read through the engine or zero-copy from the
session's mapped queue.

A managed buffer's ``view`` is a numpy array over HOST memory that the
engine protects and services through its SIGSEGV fault handler: plain CPU
reads and writes fault and migrate transparently.  Never hand such an
address to CUDA (no ``cudaHostRegister``, no ``torch.from_numpy(view)
.cuda()``): copy the bytes out first.  The bytes the engine faults into
its HBM tier reach the card through ``runtime.hbm.HbmRuntime``.
"""

from __future__ import annotations

import ctypes
import enum
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence

import numpy as np

from ..runtime import native


class Tier(enum.IntEnum):
    """Memory tiers (uvm.h UvmTier)."""

    HOST = 0
    HBM = 1
    CXL = 2
    REMOTE = 3   # leased span of a lender chip's HBM (native UVM_TIER_REMOTE)


class Compress(enum.IntEnum):
    """UVM_ADVISE_COMPRESSIBLE formats (uvm.h / ce.h).

    A precision contract, not a hint: an advised span's float32 data
    round-trips through the tpuce quantize stage on host<->HBM copies
    (fp8 e4m3 or int8 with per-stripe scale).  Only payloads that
    tolerate reduced precision — KV-cache pages — may opt in; exact
    data must stay OFF.
    """

    OFF = 0
    FP8 = 1
    INT8 = 2


class EventType(enum.IntEnum):
    """Tools event types (uvm.h UvmEventType)."""

    CPU_FAULT = 0
    GPU_FAULT = 1
    MIGRATION = 2
    EVICTION = 3
    THRASHING = 4
    PREFETCH = 5
    READ_DUP = 6
    ACCESS_COUNTER = 7
    FATAL_FAULT = 8
    GPU_FAULT_REPLAY = 9
    FAULT_BUFFER_FLUSH = 10
    MAP_REMOTE = 11
    READ_DUP_INVALIDATE = 12
    PTE_UPDATE = 13
    TLB_INVALIDATE = 14
    CHANNEL_RC = 15
    WATCHDOG = 16
    PM_SUSPEND = 17
    PM_RESUME = 18
    EXTERNAL_MAP = 19
    EXTERNAL_UNMAP = 20
    HMM_ADOPT = 21
    ATS_ACCESS = 22


class _Location(ctypes.Structure):
    _fields_ = [("tier", ctypes.c_int), ("devInst", ctypes.c_uint32)]


class _ResidencyInfo(ctypes.Structure):
    _fields_ = [
        ("residentHost", ctypes.c_uint8),
        ("residentHbm", ctypes.c_uint8),
        ("residentCxl", ctypes.c_uint8),
        ("hbmDeviceInst", ctypes.c_uint32),
        ("cpuMapped", ctypes.c_uint8),
        ("devMapped", ctypes.c_uint8),
        ("cancelled", ctypes.c_uint8),
        ("pinnedTier", ctypes.c_int32),
        ("hbmOffset", ctypes.c_uint64),
        ("residentRemote", ctypes.c_uint8),
        ("remoteLenderInst", ctypes.c_uint32),
    ]


class _TenantInfo(ctypes.Structure):
    _fields_ = [
        ("priority", ctypes.c_uint32),
        ("hbmQuotaPages", ctypes.c_uint64),
        ("cxlQuotaPages", ctypes.c_uint64),
        ("hbmPages", ctypes.c_uint64),
        ("cxlPages", ctypes.c_uint64),
    ]


class _FaultStats(ctypes.Structure):
    _fields_ = [
        ("faultsCpu", ctypes.c_uint64),
        ("faultsDevice", ctypes.c_uint64),
        ("batches", ctypes.c_uint64),
        ("migratedBytes", ctypes.c_uint64),
        ("evictions", ctypes.c_uint64),
        ("serviceNsP50", ctypes.c_uint64),
        ("serviceNsP95", ctypes.c_uint64),
        ("wakeNsP50", ctypes.c_uint64),
        ("wakeNsP95", ctypes.c_uint64),
        ("svcOneNsP50", ctypes.c_uint64),
        ("svcOneNsP95", ctypes.c_uint64),
    ]


class _Event(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_uint32),
        ("srcTier", ctypes.c_uint32),
        ("dstTier", ctypes.c_uint32),
        ("devInst", ctypes.c_uint32),
        ("address", ctypes.c_uint64),
        ("bytes", ctypes.c_uint64),
        ("timestampNs", ctypes.c_uint64),
    ]


@dataclass(frozen=True)
class ResidencyInfo:
    host: bool
    hbm: bool
    cxl: bool
    hbm_device: int
    cpu_mapped: bool
    pinned_tier: Optional[Tier]
    dev_mapped: bool = False
    cancelled: bool = False
    hbm_offset: int = 0       # arena offset of the HBM backing (when hbm)
    remote: bool = False      # leased replica on a lender chip's HBM
    remote_lender: int = 0    # lender devInst (when remote)


@dataclass(frozen=True)
class FaultStats:
    faults_cpu: int
    faults_device: int
    batches: int
    migrated_bytes: int
    evictions: int
    service_ns_p50: int
    service_ns_p95: int
    # Phase decomposition: wake = enqueue->batch-pop (futex+scheduler),
    # svc_one = engine work for one service call.
    wake_ns_p50: int = 0
    wake_ns_p95: int = 0
    svc_one_ns_p50: int = 0
    svc_one_ns_p95: int = 0


@dataclass(frozen=True)
class Event:
    type: EventType
    src_tier: Optional[Tier]
    dst_tier: Optional[Tier]
    dev_inst: int
    address: int
    bytes: int
    timestamp_ns: int


@dataclass(frozen=True)
class TenantInfo:
    """Tenant QoS state (uvm.h UvmTenantInfo): eviction priority,
    per-tier page quotas (0 = unlimited) and the current charged
    usage."""

    priority: int
    hbm_quota_pages: int
    cxl_quota_pages: int
    hbm_pages: int
    cxl_pages: int


_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is not None:
        return _bound
    lib = native.load()
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    vp = ctypes.c_void_p

    lib.uvmVaSpaceCreate.argtypes = [ctypes.POINTER(vp)]
    lib.uvmVaSpaceCreate.restype = u32
    lib.uvmVaSpaceDestroy.argtypes = [vp]
    lib.uvmVaSpaceDestroy.restype = None
    lib.uvmRegisterDevice.argtypes = [vp, u32]
    lib.uvmRegisterDevice.restype = u32
    lib.uvmUnregisterDevice.argtypes = [vp, u32]
    lib.uvmUnregisterDevice.restype = u32
    lib.uvmMemAlloc.argtypes = [vp, u64, ctypes.POINTER(vp)]
    lib.uvmMemAlloc.restype = u32
    lib.uvmMemFree.argtypes = [vp, vp]
    lib.uvmMemFree.restype = u32
    lib.uvmMigrate.argtypes = [vp, vp, u64, _Location, u32]
    lib.uvmMigrate.restype = u32
    lib.uvmSetPreferredLocation.argtypes = [vp, vp, u64, _Location]
    lib.uvmSetPreferredLocation.restype = u32
    lib.uvmUnsetPreferredLocation.argtypes = [vp, vp, u64]
    lib.uvmUnsetPreferredLocation.restype = u32
    lib.uvmSetAccessedBy.argtypes = [vp, vp, u64, u32]
    lib.uvmSetAccessedBy.restype = u32
    lib.uvmUnsetAccessedBy.argtypes = [vp, vp, u64, u32]
    lib.uvmUnsetAccessedBy.restype = u32
    lib.uvmSetReadDuplication.argtypes = [vp, vp, u64, ctypes.c_int]
    lib.uvmSetReadDuplication.restype = u32
    lib.uvmSetCompressible.argtypes = [vp, vp, u64, u32]
    lib.uvmSetCompressible.restype = u32
    lib.uvmRangeGroupCreate.argtypes = [vp, ctypes.POINTER(u64)]
    lib.uvmRangeGroupCreate.restype = u32
    lib.uvmRangeGroupDestroy.argtypes = [vp, u64]
    lib.uvmRangeGroupDestroy.restype = u32
    lib.uvmRangeGroupSet.argtypes = [vp, u64, vp, u64]
    lib.uvmRangeGroupSet.restype = u32
    lib.uvmRangeGroupSetMigratable.argtypes = [vp, u64, ctypes.c_int]
    lib.uvmRangeGroupSetMigratable.restype = u32
    lib.uvmDeviceAccess.argtypes = [vp, u32, vp, u64, ctypes.c_int]
    lib.uvmDeviceAccess.restype = u32
    lib.uvmResidencyInfo.argtypes = [vp, vp, ctypes.POINTER(_ResidencyInfo)]
    lib.uvmResidencyInfo.restype = u32
    lib.uvmFaultStatsGet.argtypes = [ctypes.POINTER(_FaultStats)]
    lib.uvmFaultStatsGet.restype = None
    lib.uvmFaultStatsResetWindows.argtypes = []
    lib.uvmFaultStatsResetWindows.restype = None
    lib.uvmRunTest.argtypes = [vp, u32]
    lib.uvmRunTest.restype = u32
    lib.uvmToolsSessionCreate.argtypes = [vp, u32, ctypes.POINTER(vp)]
    lib.uvmToolsSessionCreate.restype = u32
    lib.uvmToolsSessionDestroy.argtypes = [vp]
    lib.uvmToolsEnableEvents.argtypes = [vp, u64]
    lib.uvmToolsEnableEventTypes.argtypes = [vp, u64]
    lib.uvmToolsDisableEventTypes.argtypes = [vp, u64]
    lib.uvmToolsSetCountersEnabled.argtypes = [vp, ctypes.c_bool]
    lib.uvmToolsCounterGet.argtypes = [vp, ctypes.c_char_p,
                                       ctypes.POINTER(u64)]
    lib.uvmToolsCounterGet.restype = ctypes.c_bool
    lib.uvmToolsSetNotificationThreshold.argtypes = [vp, u64]
    lib.uvmToolsPendingEvents.argtypes = [vp]
    lib.uvmToolsPendingEvents.restype = u64
    lib.uvmToolsNotificationCount.argtypes = [vp]
    lib.uvmToolsNotificationCount.restype = u64
    lib.uvmToolsReadEvents.argtypes = [vp, ctypes.POINTER(_Event),
                                       ctypes.c_size_t]
    lib.uvmToolsReadEvents.restype = ctypes.c_size_t
    lib.uvmToolsSessionQueueFd.argtypes = [vp]
    lib.uvmToolsSessionQueueFd.restype = ctypes.c_int
    lib.uvmSuspend.argtypes = []
    lib.uvmSuspend.restype = u32
    lib.uvmResume.argtypes = []
    lib.uvmResume.restype = u32
    lib.uvmTenantConfigure.argtypes = [u32, u32, u64, u64]
    lib.uvmTenantConfigure.restype = u32
    lib.uvmTenantInfoGet.argtypes = [u32, ctypes.POINTER(_TenantInfo)]
    lib.uvmTenantInfoGet.restype = u32
    lib.uvmVaSpaceBindTenant.argtypes = [vp, u32]
    lib.uvmVaSpaceBindTenant.restype = u32
    lib.tpurmBrokerTenantConfigure.argtypes = [u32, u32, u64, u64]
    lib.tpurmBrokerTenantConfigure.restype = u32

    _bound = lib
    return lib


def _check(status: int, what: str) -> None:
    if status != 0:
        raise native.RmError(status, what)


def _tier_or_none(value: int) -> Optional[Tier]:
    return Tier(value) if 0 <= value < len(Tier) else None


def suspend() -> None:
    """Global PM quiesce + arena save-to-host (uvm.h uvmSuspend)."""
    _check(_lib().uvmSuspend(), "uvmSuspend")


def resume() -> None:
    """Restore saved residency and reopen the PM gate."""
    _check(_lib().uvmResume(), "uvmResume")


def tenant_configure(tenant_id: int, priority: int = 100,
                     hbm_quota_pages: int = 0,
                     cxl_quota_pages: int = 0) -> None:
    """Create-or-update a QoS tenant (uvm.h tenant API): eviction
    priority (higher = keep longer) and HBM/CXL backing-page quotas
    (0 = unlimited).  Enforcement is eviction pressure: when an arena
    needs a victim, over-quota tenants' cold blocks go first, then
    lower-priority tenants, then plain LRU order.

    Broker-aware: under ``TPURM_BROKER`` the op forwards to the engine
    host (BR_OP_TENANT) so the quota lands in the table the engine's
    eviction walk actually consults."""
    _check(_lib().tpurmBrokerTenantConfigure(tenant_id, priority,
                                             hbm_quota_pages,
                                             cxl_quota_pages),
           "tpurmBrokerTenantConfigure")


def tenant_info(tenant_id: int) -> TenantInfo:
    """Usage + quota snapshot for a configured tenant."""
    raw = _TenantInfo()
    _check(_lib().uvmTenantInfoGet(tenant_id, ctypes.byref(raw)),
           "uvmTenantInfoGet")
    return TenantInfo(raw.priority, raw.hbmQuotaPages, raw.cxlQuotaPages,
                      raw.hbmPages, raw.cxlPages)


def fault_stats_reset_windows() -> None:
    """Restart the latency percentile windows (counters unaffected), so
    percentiles read afterwards cover only faults from this point on."""
    _lib().uvmFaultStatsResetWindows()


def fault_stats() -> FaultStats:
    """Global fault-engine statistics (uvm.h uvmFaultStatsGet)."""
    lib = _lib()
    raw = _FaultStats()
    lib.uvmFaultStatsGet(ctypes.byref(raw))
    return FaultStats(raw.faultsCpu, raw.faultsDevice, raw.batches,
                      raw.migratedBytes, raw.evictions, raw.serviceNsP50,
                      raw.serviceNsP95, raw.wakeNsP50, raw.wakeNsP95,
                      raw.svcOneNsP50, raw.svcOneNsP95)


class ToolsSession:
    """Event-queue session (reference: uvm_tools.c mmap'd queues)."""

    def __init__(self, vs: "VaSpace", capacity: int = 4096):
        self._lib = _lib()
        handle = ctypes.c_void_p()
        _check(self._lib.uvmToolsSessionCreate(vs._handle, capacity,
                                               ctypes.byref(handle)),
               "uvmToolsSessionCreate")
        self._handle = handle

    def enable(self, types: Iterable[EventType]) -> None:
        mask = 0
        for t in types:
            mask |= 1 << int(t)
        self._lib.uvmToolsEnableEvents(self._handle, mask)

    def enable_types(self, types: Iterable[EventType]) -> None:
        mask = 0
        for t in types:
            mask |= 1 << int(t)
        self._lib.uvmToolsEnableEventTypes(self._handle, mask)

    def disable_types(self, types: Iterable[EventType]) -> None:
        mask = 0
        for t in types:
            mask |= 1 << int(t)
        self._lib.uvmToolsDisableEventTypes(self._handle, mask)

    def enable_counters(self, enabled: bool = True) -> None:
        self._lib.uvmToolsSetCountersEnabled(self._handle, enabled)

    def counter(self, name: str) -> Optional[int]:
        """Counter value, or None while counters are disabled."""
        out = ctypes.c_uint64()
        if self._lib.uvmToolsCounterGet(self._handle, name.encode(),
                                        ctypes.byref(out)):
            return out.value
        return None

    def set_notification_threshold(self, threshold: int) -> None:
        self._lib.uvmToolsSetNotificationThreshold(self._handle, threshold)

    @property
    def pending(self) -> int:
        return self._lib.uvmToolsPendingEvents(self._handle)

    @property
    def notifications(self) -> int:
        return self._lib.uvmToolsNotificationCount(self._handle)

    def queue_fd(self) -> int:
        """The memfd backing this session's event queue (reference:
        user-mmap'd queues, uvm_tools.c:54-70).  Map it for zero-copy
        consumption; dup before shipping cross-process."""
        return self._lib.uvmToolsSessionQueueFd(self._handle)

    def map_queue(self) -> "MappedQueue":
        """Switch this session to the mapped consumer.  ridx has ONE
        owner: after this, ToolsSession.read() raises — the two read
        paths would rewind each other's progress."""
        if getattr(self, "_mapped", False):
            raise RuntimeError("session queue already mapped: ridx has "
                               "a single owner")
        self._mapped = True
        return MappedQueue(self.queue_fd())

    def read(self, max_events: int = 1024) -> List[Event]:
        if getattr(self, "_mapped", False):
            raise RuntimeError(
                "session queue is mapped: consume via MappedQueue.read "
                "(ridx has a single owner)")
        buf = (_Event * max_events)()
        n = self._lib.uvmToolsReadEvents(self._handle, buf, max_events)
        return [Event(EventType(e.type), _tier_or_none(e.srcTier),
                      _tier_or_none(e.dstTier), e.devInst, e.address,
                      e.bytes, e.timestampNs) for e in buf[:n]]

    def close(self) -> None:
        if self._handle:
            self._lib.uvmToolsSessionDestroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ManagedBuffer:
    """A managed allocation: migrates between tiers on demand.

    `view(dtype)` returns a numpy array over the managed VA — plain CPU
    reads/writes fault and migrate transparently.  `migrate`/`prefetch`
    and `device_access` drive explicit and device-side movement.
    """

    def __init__(self, vs: "VaSpace", nbytes: int):
        self._vs = vs
        self._lib = vs._lib
        ptr = ctypes.c_void_p()
        _check(self._lib.uvmMemAlloc(vs._handle, nbytes, ctypes.byref(ptr)),
               "uvmMemAlloc")
        self.address = ptr.value
        self.nbytes = nbytes

    def view(self, dtype=np.uint8, shape=None) -> np.ndarray:
        itemsize = np.dtype(dtype).itemsize
        count = self.nbytes // itemsize
        buf = (ctypes.c_char * self.nbytes).from_address(self.address)
        arr = np.frombuffer(buf, dtype=dtype, count=count)
        return arr.reshape(shape) if shape is not None else arr

    def migrate(self, tier: Tier, dev: int = 0, offset: int = 0,
                length: Optional[int] = None) -> None:
        length = self.nbytes - offset if length is None else length
        loc = _Location(int(tier), dev)
        _check(self._lib.uvmMigrate(self._vs._handle, self.address + offset,
                                    length, loc, 0), "uvmMigrate")

    def device_access(self, dev: int = 0, offset: int = 0,
                      length: Optional[int] = None, write: bool = False) -> None:
        """Simulated device touch: faults the span into device residency."""
        length = self.nbytes - offset if length is None else length
        _check(self._lib.uvmDeviceAccess(self._vs._handle, dev,
                                         self.address + offset, length,
                                         1 if write else 0),
               "uvmDeviceAccess")

    def set_preferred(self, tier: Tier, dev: int = 0, offset: int = 0,
                      length: Optional[int] = None) -> None:
        """Preferred location for [offset, offset+length) — a sub-span
        SPLITS the underlying VA range at 2 MB block boundaries (native
        range_split_locked), so different spans of one buffer can carry
        different tiers; sub-block spans raise INVALID_ADDRESS."""
        length = self.nbytes - offset if length is None else length
        loc = _Location(int(tier), dev)
        _check(self._lib.uvmSetPreferredLocation(self._vs._handle,
                                                 self.address + offset,
                                                 length, loc),
               "uvmSetPreferredLocation")

    def unset_preferred(self, offset: int = 0,
                        length: Optional[int] = None) -> None:
        length = self.nbytes - offset if length is None else length
        _check(self._lib.uvmUnsetPreferredLocation(self._vs._handle,
                                                   self.address + offset,
                                                   length),
               "uvmUnsetPreferredLocation")

    def set_read_duplication(self, enable: bool) -> None:
        _check(self._lib.uvmSetReadDuplication(self._vs._handle, self.address,
                                               self.nbytes,
                                               1 if enable else 0),
               "uvmSetReadDuplication")

    def set_accessed_by(self, dev: int) -> None:
        _check(self._lib.uvmSetAccessedBy(self._vs._handle, self.address,
                                          self.nbytes, dev),
               "uvmSetAccessedBy")

    def unset_accessed_by(self, dev: int) -> None:
        _check(self._lib.uvmUnsetAccessedBy(self._vs._handle, self.address,
                                            self.nbytes, dev),
               "uvmUnsetAccessedBy")

    def set_compressible(self, fmt: "Compress", offset: int = 0,
                         length: Optional[int] = None) -> None:
        """UVM_ADVISE_COMPRESSIBLE: opt the span into (fmt=FP8/INT8) or
        out of (fmt=OFF) the tpuce compression stage.  Lossy by design
        — see :class:`Compress`."""
        _check(self._lib.uvmSetCompressible(
            self._vs._handle, self.address + offset,
            self.nbytes - offset if length is None else length, int(fmt)),
               "uvmSetCompressible")

    def residency(self, offset: int = 0) -> ResidencyInfo:
        raw = _ResidencyInfo()
        _check(self._lib.uvmResidencyInfo(self._vs._handle,
                                          self.address + offset,
                                          ctypes.byref(raw)),
               "uvmResidencyInfo")
        return ResidencyInfo(bool(raw.residentHost), bool(raw.residentHbm),
                             bool(raw.residentCxl), raw.hbmDeviceInst,
                             bool(raw.cpuMapped),
                             _tier_or_none(raw.pinnedTier),
                             bool(raw.devMapped), bool(raw.cancelled),
                             raw.hbmOffset, bool(raw.residentRemote),
                             raw.remoteLenderInst)

    def free(self) -> None:
        if self.address:
            _check(self._lib.uvmMemFree(self._vs._handle, self.address),
                   "uvmMemFree")
            self.address = 0


class MappedQueue:
    """Zero-copy consumer over a session's mmap'd event queue.

    Page 0 is UvmToolsQueueHeader {widx, ridx, dropped: u64;
    capacity, eventSize: u32}; events follow at offset 4096.  The
    producer release-publishes widx; this consumer owns ridx.

    Ordering note: slot reads after the widx load rely on total-store
    ordering (x86-class); a consumer on a weakly-ordered CPU should use
    the C API (uvmToolsReadEvents), whose loads carry acquire fences."""

    RING_OFFSET = 4096

    def __init__(self, fd: int):
        import mmap as _mmap

        self._fd = fd
        # Header first, to size the full mapping.
        head = _mmap.mmap(fd, 4096)
        cap, esize = np.frombuffer(head[24:32], np.uint32)
        head.close()
        self.capacity = int(cap)
        self.event_size = int(esize)
        if self.event_size != ctypes.sizeof(_Event):
            raise RuntimeError(
                f"event ABI skew: queue eventSize={self.event_size}, "
                f"consumer expects {ctypes.sizeof(_Event)}")
        self._mm = _mmap.mmap(fd, self.RING_OFFSET +
                              self.capacity * self.event_size)
        self._hdr = np.frombuffer(self._mm, np.uint64, 3)
        self._ring = np.frombuffer(
            self._mm, np.uint8,
            self.capacity * self.event_size,
            self.RING_OFFSET).reshape(self.capacity, self.event_size)

    @property
    def widx(self) -> int:
        return int(self._hdr[0])

    @property
    def ridx(self) -> int:
        return int(self._hdr[1])

    @property
    def dropped(self) -> int:
        return int(self._hdr[2])

    def read(self, max_events: int = 1024) -> List[Event]:
        """Drain directly from the mapping (no engine call)."""
        out: List[Event] = []
        r, w = self.ridx, self.widx
        while r < w and len(out) < max_events:
            raw = _Event.from_buffer_copy(
                self._ring[r % self.capacity].tobytes())
            out.append(Event(EventType(raw.type),
                             _tier_or_none(raw.srcTier),
                             _tier_or_none(raw.dstTier), raw.devInst,
                             raw.address, raw.bytes, raw.timestampNs))
            r += 1
        self._hdr[1] = r          # consumer owns ridx
        return out

    def close(self) -> None:
        if self._mm is not None:
            self._hdr = None
            self._ring = None
            self._mm.close()
            self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class VaSpace:
    """Per-client UVM VA space (reference: uvm_va_space.c)."""

    def __init__(self, register_devices: Sequence[int] = (0,)):
        self._lib = _lib()
        handle = ctypes.c_void_p()
        _check(self._lib.uvmVaSpaceCreate(ctypes.byref(handle)),
               "uvmVaSpaceCreate")
        self._handle = handle
        self._buffers: List[ManagedBuffer] = []
        for dev in register_devices:
            _check(self._lib.uvmRegisterDevice(self._handle, dev),
                   "uvmRegisterDevice")

    def alloc(self, nbytes: int) -> ManagedBuffer:
        buf = ManagedBuffer(self, nbytes)
        self._buffers.append(buf)
        return buf

    def bind_tenant(self, tenant_id: int) -> None:
        """Bind this space (and the pages its blocks already hold) to a
        configured tenant; its allocations then charge that tenant's
        quotas and inherit its eviction priority."""
        _check(self._lib.uvmVaSpaceBindTenant(self._handle, tenant_id),
               "uvmVaSpaceBindTenant")

    def run_test(self, test_cmd: int) -> None:
        _check(self._lib.uvmRunTest(self._handle, test_cmd), "uvmRunTest")

    def tools_session(self, capacity: int = 4096) -> ToolsSession:
        return ToolsSession(self, capacity)

    def close(self) -> None:
        if self._handle:
            for buf in self._buffers:
                buf.address = 0      # freed wholesale with the space
            self._lib.uvmVaSpaceDestroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
