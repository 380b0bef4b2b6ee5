"""Multi-chip KV pool: an ICI peer-mapped HBM backing for TieredKVCache.

Port of the JAX package's ``models/multichip.py`` (BASELINE config #5, "ICI
peer-mapped HBM pool"): the logical KV pool spans SEVERAL devices' HBM
arenas, each page has a home device, and the decode runs on device 0.
Activating a sequence whose pages are homed on a peer moves them over the
native ICI model (tpuIciPeerCopy: dimension-ordered torus routing, per-hop
traffic accounting, detour around FAILED links) into device 0's staging
window, from where their bytes go up to the compute slot pool on
``TieredKVCache.device``; evicted pages ride ICI back to their home arena.

The devices are the native engine's device arenas (``TPUMEM_FAKE_TPU_COUNT``
of them, ``TPUMEM_FAKE_HBM_MB`` each, set before the library first loads),
which are host memory; the decode itself runs on the CUDA card (or the CPU
when the cache was made with ``device="cpu"``), unchanged.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np

from ..device import DeviceLike
from ..runtime import ici, native
from . import llama, serving

#: Record slots of device 0's staging window, reused round-robin by a
#: ``read_pages`` (each record is copied out before its slot comes round).
STAGING_RECORDS = 8


class IciPoolBacking:
    """KV backing striped across peer devices' HBM arenas.

    Every page is a fixed-size record [k (L pages), v (L pages)]
    (``record_bytes = 2 * L * page_bytes``, in the backing's numpy dtype:
    uint16 bits for bf16) allocated from its home device's HBM through the
    UVM tier PMM (uvmHbmChunkAlloc), the allocator the fault engine draws
    from, so KV records and fault-driven residency share one arena without
    aliasing.  Device 0 also holds a staging window through which remote
    records are fetched and flushed, so a whole record moves as ONE ICI
    copy.
    """

    def __init__(self, pool_shape: Tuple[int, ...], np_dtype: np.dtype,
                 page_bytes: int, n_devices: int):
        self.pool_shape = pool_shape
        self.np_dtype = np_dtype
        self.page_bytes = page_bytes
        self.num_layers = pool_shape[0]
        self.total_pages = pool_shape[1]
        self.n_devices = n_devices
        self.record_bytes = 2 * self.num_layers * page_bytes
        self.rec_shape = (2, self.num_layers) + pool_shape[2:]

        lib = self._lib = native.load()
        u32, u64, vp = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_void_p
        lib.tpurmDeviceCount.argtypes = []
        lib.tpurmDeviceCount.restype = u32
        lib.tpurmDeviceGet.argtypes = [u32]
        lib.tpurmDeviceGet.restype = vp
        lib.tpurmDeviceHbmBase.argtypes = [vp]
        lib.tpurmDeviceHbmBase.restype = vp
        lib.tpurmDeviceHbmSize.argtypes = [vp]
        lib.tpurmDeviceHbmSize.restype = u64
        lib.uvmHbmChunkAlloc.argtypes = [u32, u64, ctypes.POINTER(u64),
                                         ctypes.POINTER(vp)]
        lib.uvmHbmChunkAlloc.restype = u32
        lib.uvmHbmChunkFree.argtypes = [u32, vp]
        lib.uvmHbmChunkFree.restype = u32
        lib.uvmTenantDevCharge.argtypes = [u32, u32, ctypes.c_int64]
        lib.uvmTenantDevCharge.restype = None
        lib.uvmTenantRebindDevicePages.argtypes = [u32, u32, u32, u64]
        lib.uvmTenantRebindDevicePages.restype = u32
        if lib.tpurmDeviceCount() < n_devices:
            raise RuntimeError(
                f"need {n_devices} devices, have {lib.tpurmDeviceCount()} "
                f"(set TPUMEM_FAKE_TPU_COUNT before loading the lib)")

        # Round-robin homes: every group's working set spreads across the
        # pool (fabric-wide striping).
        self.home = np.arange(self.total_pages) % n_devices

        self._arena: List[np.ndarray] = []
        for d in range(n_devices):
            dev = lib.tpurmDeviceGet(d)
            base = lib.tpurmDeviceHbmBase(dev)
            size = lib.tpurmDeviceHbmSize(dev)
            self._arena.append(np.frombuffer(
                (ctypes.c_char * size).from_address(base), np.uint8))

        self._apertures: Dict[int, ici.PeerAperture] = {}
        self.stats = {"ici_fetch_records": 0, "ici_flush_records": 0,
                      "ici_bytes": 0, "rehomed_records": 0,
                      "rehome_aborts": 0}

        # One PMM chunk per page on its home device, zeroed (arena chunks
        # may hold a previous tenant's bytes).  Each page's chunk is tracked
        # on its own (page -> (dev, handle)) so tpuvac can re-home a page
        # without disturbing its neighbours.  Per-device tenant charges
        # mirror the placement (uvmTenantDevCharge; a re-home rebinds it).
        self._page_chunk: Dict[int, Tuple[int, ctypes.c_void_p]] = {}
        self._staging_chunks: List[ctypes.c_void_p] = []
        self._page_tenant: Dict[int, int] = {}
        self.home_offset = np.zeros(self.total_pages, np.int64)
        try:
            for p in range(self.total_pages):
                d = int(self.home[p])
                off, handle = self._chunk_alloc_raw(d)
                self._page_chunk[p] = (d, handle)
                self.home_offset[p] = off
                self.record_raw(d, off)[:] = 0
                lib.uvmTenantDevCharge(0, d, 1)
            self._staging = []
            for _ in range(STAGING_RECORDS):
                off, handle = self._chunk_alloc_raw(0)
                self._staging.append(off)
                self._staging_chunks.append(handle)
        except Exception:
            self.close()
            raise

    def _chunk_alloc_raw(self, dev: int) -> Tuple[int, ctypes.c_void_p]:
        """One record-sized PMM chunk on ``dev``, not tracked in the page
        map (tpuvac stages target records it may abort)."""
        off = ctypes.c_uint64()
        handle = ctypes.c_void_p()
        st = self._lib.uvmHbmChunkAlloc(dev, self.record_bytes,
                                        ctypes.byref(off),
                                        ctypes.byref(handle))
        if st != 0:
            raise RuntimeError(
                f"uvmHbmChunkAlloc(dev={dev}, {self.record_bytes}B) "
                f"failed: 0x{st:x} (arena too small? raise "
                f"TPUMEM_FAKE_HBM_MB)")
        return off.value, handle

    def _tenant_of(self, page: int) -> int:
        return self._page_tenant.get(page, 0)

    def set_page_tenant(self, page: int, tenant: int) -> None:
        """Move the page's per-device charge to ``tenant`` (the scheduler
        calls this when a sequence slot changes hands between tenants)."""
        old = self._tenant_of(page)
        if old == tenant:
            return
        dev = int(self.home[page])
        self._lib.uvmTenantDevCharge(old, dev, -1)
        self._lib.uvmTenantDevCharge(tenant, dev, 1)
        self._page_tenant[page] = tenant

    def _aperture(self, peer: int) -> ici.PeerAperture:
        """Device 0's window onto ``peer``'s arena."""
        ap = self._apertures.get(peer)
        if ap is None:
            ap = ici.PeerAperture(0, peer)
            self._apertures[peer] = ap
        return ap

    def _rec_view(self, dev: int, offset: int) -> np.ndarray:
        return self.record_raw(dev, offset).view(self.np_dtype).reshape(
            self.rec_shape)

    def _home_offset(self, page: int) -> Tuple[int, int]:
        return int(self.home[page]), int(self.home_offset[page])

    # ------------------------------------------------- backing protocol

    def read_pages(self, pages: List[int], pin: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(k, v) chunks [L, n, P, KV, D] of ``pages``, copied out of their
        records (page-locked host memory with ``pin``): a remote record
        comes to device 0's staging window in ONE ICI copy first.  The
        chunks own their bytes, so a staging slot may be reused at once."""
        shape = (self.num_layers, len(pages)) + self.pool_shape[2:]
        k = serving._host_empty(shape, self.np_dtype, pin)
        v = serving._host_empty(shape, self.np_dtype, pin)
        stage = 0
        for i, page in enumerate(pages):
            d, off = self._home_offset(page)
            if d == 0:
                rec = self._rec_view(0, off)
            else:
                local = self._staging[stage % STAGING_RECORDS]
                stage += 1
                self._aperture(d).read(local, off, self.record_bytes)
                self.stats["ici_fetch_records"] += 1
                self.stats["ici_bytes"] += self.record_bytes
                rec = self._rec_view(0, local)
            k[:, i] = rec[0]
            v[:, i] = rec[1]
        return k, v

    def write_page(self, page: int, k_rec: np.ndarray,
                   v_rec: np.ndarray) -> None:
        d, off = self._home_offset(page)
        if d == 0:
            rec = self._rec_view(0, off)
            rec[0] = k_rec
            rec[1] = v_rec
            return
        # Assemble in staging, then ONE ICI copy local -> peer home.
        local = self._staging[0]        # the flush is synchronous: slot 0
        rec = self._rec_view(0, local)
        rec[0] = k_rec
        rec[1] = v_rec
        self._aperture(d).write(local, off, self.record_bytes)
        self.stats["ici_flush_records"] += 1
        self.stats["ici_bytes"] += self.record_bytes

    # --------------------------------------------------- tpuvac re-homing
    #
    # The MECHANISM half of live migration: allocate a record on the target,
    # flip the page's home maps, free the source chunk.  The PROTOCOL half
    # (manifest, PEER_COPY shipping, inject retry/abort, verification) is
    # uvm/vac.py; this class never ships bytes for a re-home itself.

    def pages_homed(self, dev: int, pages=None) -> List[int]:
        """Pages whose record lives on ``dev`` (optionally restricted to a
        candidate list): the evacuation working set."""
        cand = range(self.total_pages) if pages is None else pages
        return [int(p) for p in cand if int(self.home[p]) == dev]

    def stage_rehome(self, page: int,
                     dst: int) -> Tuple[int, ctypes.c_void_p]:
        """Allocate the page's target-side record (the caller commits or
        aborts it)."""
        if int(self.home[page]) == dst:
            raise ValueError(f"page {page} already homed on {dst}")
        return self._chunk_alloc_raw(dst)

    def commit_rehome(self, page: int, dst: int, off: int,
                      handle: ctypes.c_void_p) -> None:
        """Flip the page's home to the (already shipped) target record and
        free the source chunk.  Called only AFTER the manifest committed."""
        src, old_handle = self._page_chunk[page]
        self._page_chunk[page] = (dst, handle)
        self.home[page] = dst
        self.home_offset[page] = off
        self._lib.uvmTenantRebindDevicePages(self._tenant_of(page),
                                             src, dst, 1)
        self._lib.uvmHbmChunkFree(src, old_handle)
        self.stats["rehomed_records"] += 1

    def abort_rehome(self, dst: int, handle: ctypes.c_void_p) -> None:
        """Release a staged target record; the source stays the truth."""
        self._lib.uvmHbmChunkFree(dst, handle)
        self.stats["rehome_aborts"] += 1

    def record_raw(self, dev: int, offset: int) -> np.ndarray:
        """Raw record bytes at (dev, offset); vac verifies shipped records
        against the source through this."""
        return self._arena[dev][offset:offset + self.record_bytes]

    def close(self) -> None:
        for ap in self._apertures.values():
            ap.close()
        self._apertures.clear()
        for page, (dev, handle) in self._page_chunk.items():
            self._lib.uvmHbmChunkFree(dev, handle)
            self._lib.uvmTenantDevCharge(self._tenant_of(page), dev, -1)
        self._page_chunk.clear()
        for handle in self._staging_chunks:
            self._lib.uvmHbmChunkFree(0, handle)
        self._staging_chunks.clear()

    # ------------------------------------------------- introspection

    def link_traffic(self) -> Dict[str, int]:
        """Bytes sent on every link of every device (reroute evidence),
        keyed "src->(peer)"."""
        out = {}
        for d in range(self.n_devices):
            for li in range(ici.link_count(d)):
                info = ici.link_info(d, li)
                out[f"{d}->({info.peer})"] = info.bytes_tx
        return out


def make_multichip_cache(cfg: llama.LlamaConfig, batch: int, max_len: int,
                         page_size: int, oversub: int, n_devices: int,
                         device: DeviceLike = None) -> serving.TieredKVCache:
    """TieredKVCache on ``device`` whose backing is the ICI peer-mapped HBM
    pool over ``n_devices`` native device arenas."""
    np_dtype = serving._np_dtype(cfg.dtype)
    m = (max_len + page_size - 1) // page_size
    pool_shape = (cfg.num_layers, batch * m, page_size, cfg.num_kv_heads,
                  cfg.head_dim)
    page_bytes = (page_size * cfg.num_kv_heads * cfg.head_dim *
                  np_dtype.itemsize)
    backing = IciPoolBacking(pool_shape, np_dtype, page_bytes, n_devices)
    try:
        return serving.TieredKVCache(cfg, batch, max_len,
                                     page_size=page_size, oversub=oversub,
                                     backing=backing, device=device)
    except BaseException:
        backing.close()
        raise
