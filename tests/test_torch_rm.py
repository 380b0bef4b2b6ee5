"""The port's RM client (``runtime/native.RmClient``) and its CXL P2P DMA,
on the CPU.

``TestRmClient`` of ``tests/test_native_rm.py`` runs on the port's client,
with its results held against the JAX package's client where both can run
(the same native core serves both).  Then CXL DMA lands in a REAL arena: the
port's ``HbmRuntime(device="cpu")`` drains the engine's mirror stream, so a
DMA into the arena shows in ``read_arena``, and a device write of the span
(chip-dirty) is what a DMA back to the CXL buffer carries.
"""

import ctypes
import mmap

import numpy as np
import pytest
import torch

from open_gpu_kernel_modules_tpu.runtime import native as jnative
from open_gpu_kernel_modules_tpu_torch.runtime import hbm as thbm
from open_gpu_kernel_modules_tpu_torch.runtime import native

MB = 1 << 20


@pytest.fixture(scope="module")
def lib():
    return native.load()


def _cxl_buffer(size):
    buf = mmap.mmap(-1, size)
    return buf, ctypes.addressof(ctypes.c_char.from_buffer(buf))


def _dma_params(handle, gpu_offset=0, cxl_offset=0, size=0,
                flags=native.DMA_FLAG_CXL_TO_DEV):
    p = native.CxlP2pDmaRequestParams()
    p.cxlBufferHandle = handle
    p.gpuOffset = gpu_offset
    p.cxlOffset = cxl_offset
    p.size = size
    p.flags = flags
    return p


class TestRmClient:
    def test_lifecycle_and_cxl_info(self, lib):
        with native.RmClient() as rm, jnative.RmClient() as jrm:
            info, jinfo = rm.cxl_info(), jrm.cxl_info()
            assert info.maxNrLinks == 4
            assert 1 <= info.cxlVersion <= 3
            assert bytes(info) == bytes(jinfo)
            assert rm.h_client != jrm.h_client

    def test_p2p_caps(self, lib):
        ids = [native.lib_device_id(0)]
        with native.RmClient() as rm, jnative.RmClient() as jrm:
            assert rm.p2p_caps(ids) == jrm.p2p_caps(ids)
            with pytest.raises(ValueError):
                rm.p2p_caps([])
            with pytest.raises(ValueError):
                rm.p2p_caps(ids * 9)

    def test_register_dma_roundtrip(self, lib):
        size = MB
        buf, addr = _cxl_buffer(size)
        pattern = np.arange(size, dtype=np.uint8)
        buf[:] = pattern.tobytes()
        with native.RmClient() as rm:
            handle = rm.register_cxl_buffer(addr, size)
            assert handle != 0
            # CXL -> device, clobber, device -> CXL, verify round trip.
            assert rm.cxl_dma(handle, 0, 0, size, to_device=True) == 1
            buf[:] = b"\x00" * size
            rm.cxl_dma(handle, 0, 0, size, to_device=False)
            assert np.array_equal(np.frombuffer(buf, dtype=np.uint8),
                                  pattern)
            rm.unregister_cxl_buffer(handle)
        del buf

    def test_dma_errors(self, lib):
        size = 1 << 16
        buf, addr = _cxl_buffer(size)
        with native.RmClient() as rm:
            handle = rm.register_cxl_buffer(addr, size)
            st = rm.control(rm.h_subdevice,
                            native.CTRL_BUS_CXL_P2P_DMA_REQUEST,
                            _dma_params(handle, cxl_offset=size, size=4096),
                            expect_ok=False)
            assert st == native.TPU_ERR_INVALID_ARGUMENT
            rm.unregister_cxl_buffer(handle)
            st = rm.control(rm.h_subdevice,
                            native.CTRL_BUS_CXL_P2P_DMA_REQUEST,
                            _dma_params(handle, size=4096), expect_ok=False)
            assert st == native.TPU_ERR_OBJECT_NOT_FOUND
        del buf

    def test_duplicate_client_handle_rejected(self, lib):
        p = native.RmAllocParams()
        p.hRoot = p.hObjectParent = p.hObjectNew = 0xDDD00002
        p.hClass = native.CLASS_ROOT
        assert lib.tpurmAlloc(ctypes.byref(p)) == native.TPU_OK
        assert lib.tpurmAlloc(ctypes.byref(p)) == \
            native.TPU_ERR_INSERT_DUPLICATE_NAME
        fr = native.RmFreeParams()
        fr.hRoot = fr.hObjectOld = 0xDDD00002
        assert lib.tpurmFree(ctypes.byref(fr)) == native.TPU_OK

    def test_channel_api(self, lib):
        dev = lib.tpurmDeviceGet(0)
        ch = lib.tpurmChannelCreate(dev, 3, 64)
        assert ch
        src = (ctypes.c_uint8 * 4096)(*([7] * 4096))
        dst = (ctypes.c_uint8 * 4096)()
        v = lib.tpurmChannelPushCopy(ch, dst, src, 4096)
        assert v > 0
        assert lib.tpurmChannelWait(ch, v) == native.TPU_OK
        assert lib.tpurmChannelCompletedValue(ch) >= v
        assert bytes(dst[:8]) == b"\x07" * 8
        lib.tpurmChannelDestroy(ch)

    def test_counters_and_journal(self, lib):
        with native.RmClient() as rm:
            rm.cxl_info()
        assert lib.tpurmCounterGet(b"channel_pushes") > 0
        buf = ctypes.create_string_buffer(1 << 16)
        n = lib.tpurmJournalDump(buf, len(buf))
        assert n > 0
        assert b"rmapi" in buf.value or b"cxl" in buf.value


def test_hbm_view_and_device_id():
    base, size = native.hbm_view(0)
    assert (base, size) == jnative.hbm_view(0) and size > 0
    assert native.lib_device_id(3) == jnative.lib_device_id(3) == 0x103
    with pytest.raises(ValueError):
        native.hbm_view(64)


@pytest.mark.parametrize("gpu_offset, size", [(0, MB), (3 * MB, 2 * MB)])
def test_cxl_dma_into_real_arena(gpu_offset, size):
    """CXL -> device DMA lands in the arena the runtime mirrors; a device
    write of the span (left chip-dirty) is what device -> CXL carries."""
    buf, addr = _cxl_buffer(size)
    pattern = np.random.default_rng(size).integers(0, 256, size,
                                                   dtype=np.uint8)
    buf[:] = pattern.tobytes()
    rt = thbm.HbmRuntime(dev=0, device="cpu")
    try:
        with native.RmClient() as rm:
            handle = rm.register_cxl_buffer(addr, size)
            rm.cxl_dma(handle, gpu_offset, 0, size, to_device=True)
            rt.fence()
            got = rt.read_arena(gpu_offset, size)
            assert np.array_equal(got.numpy(), pattern)
            computed = (got.to(torch.int32) * 3 + 1).to(torch.uint8)
            rt.write_arena(gpu_offset, computed, sync=False)
            readbacks = rt.readbacks
            buf[:] = b"\x00" * size
            rm.cxl_dma(handle, gpu_offset, 0, size, to_device=False)
            assert rt.readbacks > readbacks       # the engine asked for them
            assert np.array_equal(np.frombuffer(buf, dtype=np.uint8),
                                  computed.numpy())
            rm.unregister_cxl_buffer(handle)
    finally:
        rt.close()
    del buf
