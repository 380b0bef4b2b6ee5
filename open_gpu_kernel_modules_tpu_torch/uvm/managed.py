"""ctypes bindings for the native UVM engine (native/include/tpurm/uvm.h).

The port's own copy of the part of the JAX package's ``uvm/managed.py``
that the tiered KV backing and its tests reach, with the same names:
``Tier``, ``VaSpace``, ``ManagedBuffer``, ``ResidencyInfo``, ``FaultStats``,
``fault_stats`` and ``tenant_configure``.

A managed buffer's ``view`` is a numpy array over HOST memory that the
engine protects and services through its SIGSEGV fault handler: plain CPU
reads and writes fault and migrate transparently.  Never hand such an
address to CUDA (no ``cudaHostRegister``, no ``torch.from_numpy(view)
.cuda()``): copy the bytes out first.
"""

from __future__ import annotations

import ctypes
import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..runtime import native


class Tier(enum.IntEnum):
    """Memory tiers (uvm.h UvmTier)."""

    HOST = 0
    HBM = 1
    CXL = 2
    REMOTE = 3   # leased span of a lender chip's HBM (native UVM_TIER_REMOTE)


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
    lib.uvmMemAlloc.argtypes = [vp, u64, ctypes.POINTER(vp)]
    lib.uvmMemAlloc.restype = u32
    lib.uvmMigrate.argtypes = [vp, vp, u64, _Location, u32]
    lib.uvmMigrate.restype = u32
    lib.uvmSetPreferredLocation.argtypes = [vp, vp, u64, _Location]
    lib.uvmSetPreferredLocation.restype = u32
    lib.uvmSetReadDuplication.argtypes = [vp, vp, u64, ctypes.c_int]
    lib.uvmSetReadDuplication.restype = u32
    lib.uvmDeviceAccess.argtypes = [vp, u32, vp, u64, ctypes.c_int]
    lib.uvmDeviceAccess.restype = u32
    lib.uvmResidencyInfo.argtypes = [vp, vp, ctypes.POINTER(_ResidencyInfo)]
    lib.uvmResidencyInfo.restype = u32
    lib.uvmFaultStatsGet.argtypes = [ctypes.POINTER(_FaultStats)]
    lib.uvmFaultStatsGet.restype = None
    lib.tpurmBrokerTenantConfigure.argtypes = [u32, u32, u64, u64]
    lib.tpurmBrokerTenantConfigure.restype = u32

    _bound = lib
    return lib


def _check(status: int, what: str) -> None:
    if status != 0:
        raise native.RmError(status, what)


def _tier_or_none(value: int) -> Optional[Tier]:
    return Tier(value) if 0 <= value < len(Tier) else None


def fault_stats() -> FaultStats:
    """Global fault-engine statistics (uvm.h uvmFaultStatsGet)."""
    raw = _FaultStats()
    _lib().uvmFaultStatsGet(ctypes.byref(raw))
    return FaultStats(raw.faultsCpu, raw.faultsDevice, raw.batches,
                      raw.migratedBytes, raw.evictions, raw.serviceNsP50,
                      raw.serviceNsP95, raw.wakeNsP50, raw.wakeNsP95,
                      raw.svcOneNsP50, raw.svcOneNsP95)


def tenant_configure(tenant_id: int, priority: int = 100) -> None:
    """Create-or-update a QoS tenant (uvm.h tenant API) with its eviction
    priority (higher = keep longer) and no HBM/CXL backing-page quota.
    Arena pressure evicts lower priorities' cold blocks first, then plain
    LRU order.  Under ``TPURM_BROKER`` the call forwards to the engine
    host."""
    _check(_lib().tpurmBrokerTenantConfigure(tenant_id, priority, 0, 0),
           "tpurmBrokerTenantConfigure")


class ManagedBuffer:
    """A managed allocation: migrates between tiers on demand.

    `view(dtype)` returns a numpy array over the managed VA — plain CPU
    reads/writes fault and migrate transparently.  `migrate` and
    `device_access` drive explicit and device-side movement.
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
                      length: Optional[int] = None) -> None:
        """Simulated device read: faults the span into device residency."""
        length = self.nbytes - offset if length is None else length
        _check(self._lib.uvmDeviceAccess(self._vs._handle, dev,
                                         self.address + offset, length, 0),
               "uvmDeviceAccess")

    def set_preferred(self, tier: Tier, dev: int = 0, offset: int = 0,
                      length: Optional[int] = None) -> None:
        """Preferred location for [offset, offset+length)."""
        length = self.nbytes - offset if length is None else length
        loc = _Location(int(tier), dev)
        _check(self._lib.uvmSetPreferredLocation(self._vs._handle,
                                                 self.address + offset,
                                                 length, loc),
               "uvmSetPreferredLocation")

    def set_read_duplication(self, enable: bool) -> None:
        _check(self._lib.uvmSetReadDuplication(self._vs._handle, self.address,
                                               self.nbytes,
                                               1 if enable else 0),
               "uvmSetReadDuplication")

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

    def close(self) -> None:
        if self._handle:
            for buf in self._buffers:
                buf.address = 0      # freed wholesale with the space
            self._lib.uvmVaSpaceDestroy(self._handle)
            self._handle = None
