"""ctypes bindings to the native tpurm core (native/build/libtpurm.so).

The port's own copy of the JAX package's ``runtime/native.py``: the library
loader (``build_native``, ``load`` with every ``argtypes``/``restype`` the
port's modules reach through it), the RM parameter-block ABI
(native/include/tpurm/abi.h) and its control commands, ``RmClient`` (client,
device and subdevice objects; P2P caps, CXL info, CXL buffer registration
and CXL P2P DMA) and ``hbm_view``.  Both packages load the same
``native/build/libtpurm.so`` from the repository root; in one process the
dynamic loader hands both the same library, each package through a
``ctypes.CDLL`` object of its own, so their declarations never collide.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libtpurm.so")

# ---------------------------------------------------------------- constants

TPU_OK = 0x0
TPU_ERR_GPU_IS_LOST = 0x0F
TPU_ERR_INSERT_DUPLICATE_NAME = 0x19
TPU_ERR_INVALID_ARGUMENT = 0x1F
TPU_ERR_INVALID_CLIENT = 0x23
TPU_ERR_INVALID_DEVICE = 0x26
TPU_ERR_INVALID_LIMIT = 0x2E
TPU_ERR_INVALID_OBJECT_HANDLE = 0x33
TPU_ERR_INVALID_STATE = 0x40
TPU_ERR_NOT_SUPPORTED = 0x56
TPU_ERR_OBJECT_NOT_FOUND = 0x57
TPU_ERR_INSUFFICIENT_RESOURCES = 0x1A
# status.h TPU_ERR_DEVICE_RESET: a completion rejected by the device-
# generation fence (a full reset ran under the op); retryable by contract.
TPU_ERR_DEVICE_RESET = 0x73

CLASS_ROOT = 0x0
CLASS_DEVICE = 0x80
CLASS_SUBDEVICE = 0x2080

CTRL_GPU_GET_PROBED_IDS = 0x214
CTRL_GPU_ATTACH_IDS = 0x215
CTRL_GPU_GET_ATTACHED_IDS = 0x201
CTRL_SYSTEM_GET_P2P_CAPS_V2 = 0x127

# P2P caps bits (abi.h; ICI plays the NVLINK role, CXL is the fork delta).
P2P_CAPS_READS = 0x1
P2P_CAPS_WRITES = 0x2
P2P_CAPS_ICI = 0x4
P2P_CAPS_ATOMICS = 0x8
P2P_CAPS_CXL = 0x10

# Probed wire ids are DEV_ID_BASE + instance (device.c).
DEV_ID_BASE = 0x100


def lib_device_id(inst: int) -> int:
    """Wire id for device instance ``inst`` (opaque probe cookie)."""
    return DEV_ID_BASE + inst


CTRL_BUS_GET_CXL_INFO = 0x20801833
CTRL_BUS_CXL_P2P_DMA_REQUEST = 0x20801834
CTRL_BUS_REGISTER_CXL_BUFFER = 0x20801835
CTRL_BUS_UNREGISTER_CXL_BUFFER = 0x20801836

ATTACH_ALL_PROBED = 0xFFFF
INVALID_DEVICE_ID = 0xFFFFFFFF

DMA_FLAG_DEV_TO_CXL = 0x0
DMA_FLAG_CXL_TO_DEV = 0x1
DMA_FLAG_ASYNC = 0x2


# ------------------------------------------------------------- ABI structs

class RmAllocParams(ctypes.Structure):
    _fields_ = [
        ("hRoot", ctypes.c_uint32),
        ("hObjectParent", ctypes.c_uint32),
        ("hObjectNew", ctypes.c_uint32),
        ("hClass", ctypes.c_uint32),
        ("pAllocParms", ctypes.c_uint64),
        ("paramsSize", ctypes.c_uint32),
        ("status", ctypes.c_uint32),
    ]


class RmControlParams(ctypes.Structure):
    _fields_ = [
        ("hClient", ctypes.c_uint32),
        ("hObject", ctypes.c_uint32),
        ("cmd", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("params", ctypes.c_uint64),
        ("paramsSize", ctypes.c_uint32),
        ("status", ctypes.c_uint32),
    ]


class RmFreeParams(ctypes.Structure):
    _fields_ = [
        ("hRoot", ctypes.c_uint32),
        ("hObjectParent", ctypes.c_uint32),
        ("hObjectOld", ctypes.c_uint32),
        ("status", ctypes.c_uint32),
    ]


class DeviceAllocParams(ctypes.Structure):
    _fields_ = [
        ("deviceId", ctypes.c_uint32),
        ("hClientShare", ctypes.c_uint32),
        ("hTargetClient", ctypes.c_uint32),
        ("hTargetDevice", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("vaSpaceSize", ctypes.c_uint64),
        ("vaStartInternal", ctypes.c_uint64),
        ("vaLimitInternal", ctypes.c_uint64),
        ("vaMode", ctypes.c_uint32),
    ]


class SubdeviceAllocParams(ctypes.Structure):
    _fields_ = [("subDeviceId", ctypes.c_uint32)]


class GetProbedIdsParams(ctypes.Structure):
    _fields_ = [
        ("gpuIds", ctypes.c_uint32 * 32),
        ("excludedGpuIds", ctypes.c_uint32 * 32),
    ]


class AttachIdsParams(ctypes.Structure):
    _fields_ = [
        ("gpuIds", ctypes.c_uint32 * 32),
        ("failedId", ctypes.c_uint32),
    ]


class GetP2pCapsV2Params(ctypes.Structure):
    _fields_ = [
        ("gpuIds", ctypes.c_uint32 * 8),
        ("gpuCount", ctypes.c_uint32),
        ("p2pCaps", ctypes.c_uint32),
        ("busPeerIds", ctypes.c_uint32 * 64),
    ]


class GetCxlInfoParams(ctypes.Structure):
    _fields_ = [
        ("bIsLinkUp", ctypes.c_uint8),
        ("bMemoryExpander", ctypes.c_uint8),
        ("nrLinks", ctypes.c_uint32),
        ("maxNrLinks", ctypes.c_uint32),
        ("linkMask", ctypes.c_uint32),
        ("perLinkBwMBps", ctypes.c_uint32),
        ("cxlVersion", ctypes.c_uint32),
        ("remoteType", ctypes.c_uint32),
    ]


class RegisterCxlBufferParams(ctypes.Structure):
    _fields_ = [
        ("baseAddress", ctypes.c_uint64),
        ("size", ctypes.c_uint64),
        ("cxlVersion", ctypes.c_uint32),
        ("bufferHandle", ctypes.c_uint64),
    ]


class UnregisterCxlBufferParams(ctypes.Structure):
    _fields_ = [("bufferHandle", ctypes.c_uint64)]


class CxlP2pDmaRequestParams(ctypes.Structure):
    _fields_ = [
        ("cxlBufferHandle", ctypes.c_uint64),
        ("gpuOffset", ctypes.c_uint64),
        ("cxlOffset", ctypes.c_uint64),
        ("size", ctypes.c_uint64),
        ("flags", ctypes.c_uint32),
        ("transferId", ctypes.c_uint32),
    ]


# --------------------------------------------------------------- lib loader

_lib: Optional[ctypes.CDLL] = None


class RmError(RuntimeError):
    def __init__(self, status: int, what: str):
        super().__init__(f"{what}: status=0x{status:x}")
        self.status = status


def build_native(force: bool = False) -> str:
    """Build libtpurm.so if missing (``make -C native all``, one job per
    CPU).  Raises with make's output when the build fails."""
    if force or not os.path.exists(_LIB_PATH):
        proc = subprocess.run(
            ["make", "-C", _NATIVE_DIR, f"-j{os.cpu_count() or 1}", "all"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"make -C native all failed:\n{proc.stdout}"
                               f"\n{proc.stderr}")
    return _LIB_PATH


def loaded() -> bool:
    """Whether ``load()`` has loaded the native library in this process."""
    return _lib is not None


def load() -> ctypes.CDLL:
    """The native library, built first if missing."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native())

    lib.tpurm_open.argtypes = [ctypes.c_char_p]
    lib.tpurm_open.restype = ctypes.c_int
    lib.tpurm_close.argtypes = [ctypes.c_int]
    lib.tpurm_close.restype = ctypes.c_int
    lib.tpurmAlloc.argtypes = [ctypes.POINTER(RmAllocParams)]
    lib.tpurmAlloc.restype = ctypes.c_uint32
    lib.tpurmControl.argtypes = [ctypes.POINTER(RmControlParams)]
    lib.tpurmControl.restype = ctypes.c_uint32
    lib.tpurmFree.argtypes = [ctypes.POINTER(RmFreeParams)]
    lib.tpurmFree.restype = ctypes.c_uint32
    lib.tpurmDeviceCount.restype = ctypes.c_uint32
    lib.tpurmDeviceGet.argtypes = [ctypes.c_uint32]
    lib.tpurmDeviceGet.restype = ctypes.c_void_p
    lib.tpurmDeviceHbmBase.argtypes = [ctypes.c_void_p]
    lib.tpurmDeviceHbmBase.restype = ctypes.c_void_p
    lib.tpurmDeviceHbmSize.argtypes = [ctypes.c_void_p]
    lib.tpurmDeviceHbmSize.restype = ctypes.c_uint64
    lib.tpurmDeviceSetLost.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpurmChannelCreate.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_uint32]
    lib.tpurmChannelCreate.restype = ctypes.c_void_p
    lib.tpurmChannelDestroy.argtypes = [ctypes.c_void_p]
    lib.tpurmChannelPushCopy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_uint64]
    lib.tpurmChannelPushCopy.restype = ctypes.c_uint64
    lib.tpurmChannelWait.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.tpurmChannelWait.restype = ctypes.c_uint32
    lib.tpurmChannelCompletedValue.argtypes = [ctypes.c_void_p]
    lib.tpurmChannelCompletedValue.restype = ctypes.c_uint64
    lib.tpurmChannelInjectError.argtypes = [ctypes.c_void_p]
    lib.tpurmChannelResetError.argtypes = [ctypes.c_void_p]
    lib.tpurmChannelWaitRange.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                          ctypes.c_uint64]
    lib.tpurmChannelWaitRange.restype = ctypes.c_uint32
    lib.tpurmCounterGet.argtypes = [ctypes.c_char_p]
    lib.tpurmCounterGet.restype = ctypes.c_uint64
    lib.tpuCounterAdd.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.tpuCounterAdd.restype = None
    lib.tpurmJournalDump.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.tpurmJournalDump.restype = ctypes.c_size_t
    lib.tpurmProcfsRead.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_size_t]
    lib.tpurmProcfsRead.restype = ctypes.c_size_t
    lib.tpurmProcfsList.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.tpurmProcfsList.restype = ctypes.c_size_t

    # tputrace — unified tracing + metrics (trace.h)
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    lib.tpurmTraceStart.argtypes = []
    lib.tpurmTraceStop.argtypes = []
    lib.tpurmTraceReset.argtypes = []
    lib.tpurmTraceIsArmed.restype = ctypes.c_int
    lib.tpurmTraceNowNs.restype = u64
    lib.tpurmTraceAppSpan.argtypes = [ctypes.c_char_p, u64, u64, u64]
    lib.tpurmTraceAppSpan.restype = None
    lib.tpurmTraceExportJson.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.tpurmTraceExportJson.restype = ctypes.c_size_t
    lib.tpurmTraceStats.argtypes = [ctypes.POINTER(u64), ctypes.POINTER(u64),
                                    ctypes.POINTER(u32)]
    lib.tpurmTraceStats.restype = None
    lib.tpurmTraceHistQuantileNs.argtypes = [u32, ctypes.c_double]
    lib.tpurmTraceHistQuantileNs.restype = u64
    lib.tpurmTraceHistCountNs.argtypes = [u32]
    lib.tpurmTraceHistCountNs.restype = u64
    lib.tpurmTraceSiteName.argtypes = [u32]
    lib.tpurmTraceSiteName.restype = ctypes.c_char_p

    _lib = lib
    return lib


# ------------------------------------------------------------ friendly API

class RmClient:
    """RM client session over the native core (cxl_p2p_test.c rm_init flow)."""

    # Handles apart from the JAX package's (0xC0DE....), so clients of both
    # packages can be open at once in one process.
    _next_handle = 0xC0DF0000
    _handle_lock = threading.Lock()

    def __init__(self) -> None:
        self.lib = load()
        with RmClient._handle_lock:
            RmClient._next_handle += 0x10
            base = RmClient._next_handle
        self.h_client = base + 1
        self.h_device = base + 2
        self.h_subdevice = base + 3
        self._closed = False

        self._alloc(0, self.h_client, CLASS_ROOT, None)
        try:
            probed = GetProbedIdsParams()
            self.control(self.h_client, CTRL_GPU_GET_PROBED_IDS, probed)
            attach = AttachIdsParams()
            attach.gpuIds[0] = ATTACH_ALL_PROBED
            self.control(self.h_client, CTRL_GPU_ATTACH_IDS, attach)
            dev = DeviceAllocParams()
            dev.deviceId = 0
            self._alloc(self.h_client, self.h_device, CLASS_DEVICE, dev)
            sub = SubdeviceAllocParams()
            self._alloc(self.h_device, self.h_subdevice, CLASS_SUBDEVICE, sub)
        except Exception:
            # Don't leak the root client slot (MAX_CLIENTS is finite).
            self.close()
            raise

    def _alloc(self, parent: int, handle: int, klass: int, params) -> None:
        p = RmAllocParams()
        if klass == CLASS_ROOT:
            p.hRoot = p.hObjectParent = p.hObjectNew = handle
        else:
            p.hRoot = self.h_client
            p.hObjectParent = parent
            p.hObjectNew = handle
        p.hClass = klass
        if params is not None:
            p.pAllocParms = ctypes.cast(ctypes.byref(params),
                                        ctypes.c_void_p).value
            p.paramsSize = ctypes.sizeof(params)
        st = self.lib.tpurmAlloc(ctypes.byref(p))
        if st != TPU_OK:
            raise RmError(st, f"alloc class=0x{klass:x}")

    def control(self, h_object: int, cmd: int, params=None,
                expect_ok: bool = True) -> int:
        p = RmControlParams()
        p.hClient = self.h_client
        p.hObject = h_object
        p.cmd = cmd
        if params is not None:
            p.params = ctypes.cast(ctypes.byref(params), ctypes.c_void_p).value
            p.paramsSize = ctypes.sizeof(params)
        st = self.lib.tpurmControl(ctypes.byref(p))
        if expect_ok and st != TPU_OK:
            raise RmError(st, f"control cmd=0x{cmd:x}")
        return st

    def p2p_caps(self, gpu_ids) -> int:
        """NV0000 GET_P2P_CAPS_V2: common caps mask for the given wire ids
        (ICI plays the NVLINK role; CXL bit is the fork delta)."""
        if not 0 < len(gpu_ids) <= 8:
            raise ValueError(f"p2p_caps takes 1..8 gpu ids, got "
                             f"{len(gpu_ids)}")
        p = GetP2pCapsV2Params()
        for i, gid in enumerate(gpu_ids):
            p.gpuIds[i] = gid
        p.gpuCount = len(gpu_ids)
        self.control(self.h_client, CTRL_SYSTEM_GET_P2P_CAPS_V2, p)
        return p.p2pCaps

    def cxl_info(self) -> GetCxlInfoParams:
        info = GetCxlInfoParams()
        self.control(self.h_subdevice, CTRL_BUS_GET_CXL_INFO, info)
        return info

    def register_cxl_buffer(self, addr: int, size: int,
                            cxl_version: int = 2) -> int:
        p = RegisterCxlBufferParams()
        p.baseAddress = addr
        p.size = size
        p.cxlVersion = cxl_version
        self.control(self.h_subdevice, CTRL_BUS_REGISTER_CXL_BUFFER, p)
        return p.bufferHandle

    def unregister_cxl_buffer(self, handle: int) -> None:
        p = UnregisterCxlBufferParams()
        p.bufferHandle = handle
        self.control(self.h_subdevice, CTRL_BUS_UNREGISTER_CXL_BUFFER, p)

    def cxl_dma(self, handle: int, gpu_offset: int, cxl_offset: int,
                size: int, to_device: bool, async_: bool = False) -> int:
        p = CxlP2pDmaRequestParams()
        p.cxlBufferHandle = handle
        p.gpuOffset = gpu_offset
        p.cxlOffset = cxl_offset
        p.size = size
        p.flags = (DMA_FLAG_CXL_TO_DEV if to_device else DMA_FLAG_DEV_TO_CXL)
        if async_:
            p.flags |= DMA_FLAG_ASYNC
        self.control(self.h_subdevice, CTRL_BUS_CXL_P2P_DMA_REQUEST, p)
        return p.transferId

    def close(self) -> None:
        if self._closed:
            return
        p = RmFreeParams()
        p.hRoot = p.hObjectOld = self.h_client
        self.lib.tpurmFree(ctypes.byref(p))
        self._closed = True

    def __enter__(self) -> "RmClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def hbm_view(dev_inst: int = 0) -> Tuple[int, int]:
    """(base address, size) of a device's HBM arena for test introspection."""
    lib = load()
    dev = lib.tpurmDeviceGet(dev_inst)
    if not dev:
        raise ValueError(f"no device {dev_inst}")
    return lib.tpurmDeviceHbmBase(dev), lib.tpurmDeviceHbmSize(dev)
