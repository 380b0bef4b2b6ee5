"""The port's real-arena runtime (``runtime/hbm.HbmRuntime``) held against
the JAX package's on the CPU.

Each scenario of ``tests/test_hbm_real.py`` runs twice in this process, one
run after the other on the same native engine: once through the JAX
package (``HbmRuntime`` on CPU jax, JAX's ``uvm``) and once through the
port (``HbmRuntime(device="cpu")``, the port's ``uvm``).  A scenario makes
the JAX test's checks on each run and returns what it observed: the bytes
it read through ``read_arena``, the shadow after ``close``, CPU views of
managed pages after device writes, and the engine's flags.  The two runs
must observe bit-identical bytes and equal flags.  Card computations are
the same uint8 arithmetic on each side (jnp and torch both wrap mod 256).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_gpu_kernel_modules_tpu import uvm as juvm
from open_gpu_kernel_modules_tpu.runtime import hbm as jhbm
from open_gpu_kernel_modules_tpu.runtime import native as jnative
from open_gpu_kernel_modules_tpu_torch import uvm as tuvm
from open_gpu_kernel_modules_tpu_torch.runtime import hbm as thbm
from open_gpu_kernel_modules_tpu_torch.runtime import native as tnative

MB = 1 << 20
PAGE = 64 * 1024          # uvm_page_size default


class Jax:
    name = "jax"
    uvm = juvm
    native = jnative

    @staticmethod
    def runtime(**kw):
        return jhbm.HbmRuntime(dev=0, **kw)

    @staticmethod
    def full(n, value):
        return jnp.full((n,), value, jnp.uint8)

    @staticmethod
    def to_np(x):
        return np.asarray(x)


class Port:
    name = "port"
    uvm = tuvm
    native = tnative

    @staticmethod
    def runtime(**kw):
        return thbm.HbmRuntime(dev=0, device="cpu", **kw)

    @staticmethod
    def full(n, value):
        return torch.full((n,), value, dtype=torch.uint8)

    @staticmethod
    def to_np(x):
        assert isinstance(x, torch.Tensor) and x.dtype == torch.uint8
        assert x.device.type == "cpu"
        return x.numpy().copy()


def shadow():
    base, size = tnative.hbm_view(0)
    return np.frombuffer((ctypes.c_char * size).from_address(base),
                         dtype=np.uint8)


def notify(base_off, nbytes):
    lib = tnative.load()
    base, _ = tnative.hbm_view(0)
    lib.tpuHbmMirrorNotify.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.tpuHbmMirrorNotify.restype = None
    lib.tpuHbmMirrorNotify(base + base_off, nbytes)


def dirty(off, n):
    lib = tnative.load()
    lib.tpurmHbmChipDirtyTest.argtypes = [ctypes.c_uint32, ctypes.c_uint64,
                                          ctypes.c_uint64]
    lib.tpurmHbmChipDirtyTest.restype = ctypes.c_int
    return lib.tpurmHbmChipDirtyTest(0, off, n)


def counter(name):
    return tnative.load().tpurmCounterGet(name.encode())


# ------------------------------------------------------------- scenarios

def arena_mode_flag(pkg):
    rt = pkg.runtime(block_bytes=MB)
    try:
        lib = tnative.load()
        lib.tpurmDeviceArenaIsReal.restype = ctypes.c_int
        assert rt.is_real and lib.tpurmDeviceArenaIsReal(0) == 1
        return {"real": rt.is_real}
    finally:
        rt.close()


def faulted_page_consumed(pkg):
    """A pattern written host-side, faulted into HBM, read page by page
    from the device arena at each page's own arena offset."""
    rt = pkg.runtime(block_bytes=MB)
    try:
        with pkg.uvm.VaSpace() as vs:
            buf = vs.alloc(MB)
            pattern = (np.arange(buf.nbytes) % 251).astype(np.uint8)
            buf.view(np.uint8)[:] = pattern
            buf.device_access(dev=0, write=False)
            assert buf.residency().hbm
            rt.fence()
            assert rt.mirrored_bytes >= buf.nbytes
            pages = []
            for off in range(0, buf.nbytes, PAGE):
                pres = buf.residency(offset=off)
                assert pres.hbm
                got = pkg.to_np(rt.read_arena(pres.hbm_offset, PAGE))
                assert np.array_equal(got, pattern[off:off + PAGE])
                pages.append(got)
            buf.free()
        return {"pages": np.concatenate(pages)}
    finally:
        rt.close()


def refault_after_eviction(pkg):
    """2x oversubscription of the arena in 1 MB slices: the last slice is
    HBM-resident and the device view holds its final bytes."""
    _, arena = tnative.hbm_view(0)
    rt = pkg.runtime(block_bytes=MB)
    try:
        with pkg.uvm.VaSpace() as vs:
            nbufs = max(4, int(2 * arena) // MB)
            bufs = [vs.alloc(MB) for _ in range(nbufs)]
            for i, b in enumerate(bufs):
                b.view()[:] = (i * 37 + 11) % 256
            for b in bufs:
                b.device_access(dev=0, write=False)
            res = bufs[-1].residency()
            assert res.hbm
            rt.fence()
            got = pkg.to_np(rt.read_arena(res.hbm_offset, 4096))
            assert (got == ((nbufs - 1) * 37 + 11) % 256).all()
            for b in bufs:
                b.free()
        return {"tail": got}
    finally:
        rt.close()


def register_unregister_reregister(pkg):
    lib = tnative.load()
    lib.tpurmDeviceArenaIsReal.restype = ctypes.c_int
    rt = pkg.runtime()
    flags = [rt.is_real]
    rt.close()
    flags.append(bool(lib.tpurmDeviceArenaIsReal(0)))
    rt2 = pkg.runtime()
    try:
        flags.append(rt2.is_real)
        rt2.fence()        # the stream flows again
    finally:
        rt2.close()
    assert flags == [True, False, True]
    return {"flags": flags}


def overflow_resync(pkg):
    """Far more dirty ranges than the mirror queue holds: the consumer
    resyncs the whole arena and then shows the new bytes."""
    rt = pkg.runtime(block_bytes=MB)
    try:
        before = counter("hbm_mirror_overflows")
        shadow()[:4096] = 77
        for _ in range(3 * 8192):    # > hbm_mirror_queue_entries default
            notify(0, 4096)
        overflowed = counter("hbm_mirror_overflows") > before
        rt.fence()
        if overflowed:
            assert rt.resyncs >= 1 and rt.resync_bytes >= rt.arena_bytes
        got = pkg.to_np(rt.read_arena(0, 4096))
        assert (got == 77).all()
        return {"bytes": got}
    finally:
        rt.close()


def _hbm_buffer(vs, fill, write=False):
    buf = vs.alloc(MB)
    view = buf.view(np.uint8)
    view[:] = fill
    buf.device_access(dev=0, write=write)
    pres = buf.residency(offset=0)
    assert pres.hbm
    return buf, view, pres.hbm_offset


def chip_write_read_back_by_cpu_fault(pkg):
    """A device computation writes an arena span (sync=True); the CPU
    faults the page and reads the computed bytes, not the stale shadow."""
    rt = pkg.runtime(block_bytes=MB)
    try:
        with pkg.uvm.VaSpace() as vs:
            buf, view, off = _hbm_buffer(vs, 5)
            arr = rt.read_arena(off, PAGE)
            rt.write_arena(off, arr * 2 + 1)            # 5 -> 11
            back = pkg.to_np(rt.read_arena(off, PAGE))
            assert (back == 11).all()
            cpu = view[:PAGE + 1].copy()                # CPU fault service
            assert (cpu[:PAGE] == 11).all() and cpu[PAGE] == 5
            buf.free()
        return {"back": back, "cpu": cpu}
    finally:
        rt.close()


def engine_invoked_readback_on_migration(pkg):
    """sync=False leaves the device copy newer; a migration to host makes
    the ENGINE call the readback and carry the device's bytes."""
    rt = pkg.runtime(block_bytes=MB)
    try:
        with pkg.uvm.VaSpace() as vs:
            buf, view, off = _hbm_buffer(vs, 9)
            arr = rt.read_arena(off, PAGE)
            before = counter("hbm_readback_requests")
            rt.write_arena(off, arr + 100, sync=False)  # 9 -> 109
            flags = [dirty(off, PAGE)]
            buf.migrate(pkg.uvm.Tier.HOST, offset=0, length=PAGE)
            flags += [counter("hbm_readback_requests") > before,
                      dirty(off, PAGE)]
            assert flags == [1, True, 0]
            cpu = view[:PAGE].copy()
            assert (cpu == 109).all()
            buf.free()
        return {"flags": flags, "cpu": cpu}
    finally:
        rt.close()


def host_rewrite_of_chip_dirty_span_merges(pkg):
    """A CPU store to a chip-dirty page reads the page back first: the
    rest of the page keeps the device-computed bytes.  The store goes
    through ctypes.memmove, which releases the GIL so the drain thread can
    serve the readback."""
    rt = pkg.runtime(block_bytes=MB)
    try:
        with pkg.uvm.VaSpace() as vs:
            buf, view, off = _hbm_buffer(vs, 3)
            arr = rt.read_arena(off, PAGE)
            rt.write_arena(off, arr + 40, sync=False)   # 3 -> 43
            ctypes.memmove(buf.address, b"\xc8", 1)
            cpu = view[:PAGE].copy()
            assert cpu[0] == 200 and (cpu[1:] == 43).all()
            buf.free()
        return {"cpu": cpu}
    finally:
        rt.close()


def write_arena_partial_block_and_close_merge(pkg):
    """An unaligned install inside one granule takes the host path; a
    granule-aligned one stays on the device, marked; close() reads the
    device bytes back into the shadow."""
    sh = shadow()
    rt = pkg.runtime(block_bytes=MB)
    gran = 4096
    try:
        sh[:8192] = 17
        notify(0, 8192)
        rt.fence()
        rt.write_arena(100, pkg.full(1000, 99), sync=False)
        flags = [dirty(100, 1000)]
        host = sh[:2048].copy()
        assert host[99] == 17 and (host[100:1100] == 99).all()
        arena = pkg.to_np(rt.read_arena(0, 2048))
        assert np.array_equal(arena, host)
        rt.write_arena(gran, pkg.full(gran, 55), sync=False)
        flags.append(dirty(gran, gran))
    finally:
        rt.close()
    flags.append(dirty(gran, gran))
    assert flags == [0, 1, 0]
    after = sh[:2 * gran].copy()
    assert (after[100:1100] == 99).all() and after[99] == 17
    assert after[1100] == 17 and (after[gran:] == 55).all()
    return {"flags": flags, "host": host, "arena": arena, "after": after}


def partial_readback_keeps_granule_tracking(pkg):
    """A readback of a byte sub-range merges and clears whole 4 KB
    granules."""
    sh = shadow()
    lib = tnative.load()
    lib.tpurmHbmReadback.argtypes = [ctypes.c_uint32, ctypes.c_uint64,
                                     ctypes.c_uint64]
    lib.tpurmHbmReadback.restype = ctypes.c_uint32
    rt = pkg.runtime(block_bytes=MB)
    try:
        sh[:8192] = 7
        notify(0, 8192)
        rt.fence()
        rt.write_arena(0, pkg.full(1000, 50), sync=False)
        assert lib.tpurmHbmReadback(0, 0, 100) == 0
        got = sh[:8192].copy()
        assert got[50] == 50 and got[999] == 50 and got[1000] == 7
        assert dirty(0, 1000) == 0
    finally:
        rt.close()
    return {"shadow": got}


def suspend_resume_keeps_chip_coherent(pkg):
    rt = pkg.runtime(block_bytes=MB)
    try:
        with pkg.uvm.VaSpace() as vs:
            buf, view, _ = _hbm_buffer(vs, 0xB7, write=True)
            pkg.uvm.suspend()
            pkg.uvm.resume()
            res = buf.residency()
            assert res.hbm
            rt.fence()
            got = pkg.to_np(rt.read_arena(res.hbm_offset, 4096))
            assert (got == 0xB7).all()
            buf.free()
        return {"bytes": got}
    finally:
        rt.close()


SCENARIOS = [arena_mode_flag, faulted_page_consumed, refault_after_eviction,
             register_unregister_reregister, overflow_resync,
             chip_write_read_back_by_cpu_fault,
             engine_invoked_readback_on_migration,
             host_rewrite_of_chip_dirty_span_merges,
             write_arena_partial_block_and_close_merge,
             partial_readback_keeps_granule_tracking,
             suspend_resume_keeps_chip_coherent]


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_matches_jax(scenario):
    _same(scenario(Jax), scenario(Port))


# ------------------------------------------------------- the port alone

def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        thbm.HbmRuntime()
    lib = tnative.load()
    lib.tpurmDeviceArenaIsReal.restype = ctypes.c_int
    assert lib.tpurmDeviceArenaIsReal(0) == 0   # nothing was registered


def test_dead_drain_thread_makes_fence_raise():
    rt = thbm.HbmRuntime(dev=0, device="cpu")
    try:
        def broken(ids):
            raise OSError("copy failed")
        rt._upload_blocks = broken
        shadow()[:4096] = 1
        notify(0, 4096)
        with pytest.raises(RuntimeError, match="drain thread died") as info:
            rt.fence()
        assert isinstance(info.value.__cause__, OSError)
        rt._drain_thread.join(timeout=10)
        assert not rt._drain_thread.is_alive() and not rt.is_real
        with pytest.raises(RuntimeError, match="drain thread died"):
            rt.fence()
    finally:
        rt.close()


def test_read_arena_is_a_snapshot():
    """A tensor read_arena returned keeps its bytes after later uploads
    replace the arena's; a new read shows them."""
    sh = shadow()
    rt = thbm.HbmRuntime(dev=0, device="cpu")
    try:
        sh[:8192] = 21
        notify(0, 8192)
        first = rt.read_arena(0, 8192)
        sh[:8192] = 22
        notify(0, 8192)
        second = rt.read_arena(0, 8192)
        assert (first == 21).all() and (second == 22).all()
        assert (rt.block(0)[:8192] == 22).all()
    finally:
        rt.close()


def test_failed_host_register_raises(monkeypatch):
    """cudaHostRegister's error becomes an exception naming it; there is
    no pageable fallback."""
    class FakeCudart:
        @staticmethod
        def cudaHostRegister(ptr, size, flags):
            return 712

        @staticmethod
        def cudaGetErrorString(err):
            return "part or all of the requested memory range is already " \
                   "mapped"

    monkeypatch.setattr(torch.cuda, "cudart", lambda: FakeCudart)
    with pytest.raises(RuntimeError, match="cudaHostRegister.*712"):
        thbm.pin_host(0x1000, 4096)


@pytest.mark.parametrize("ids, runs", [
    ([], []), ([3], [(3, 3)]), ([5, 1, 2, 3], [(1, 3), (5, 5)]),
    (range(4), [(0, 3)])])
def test_block_runs(ids, runs):
    assert thbm._runs(ids) == runs


REHEARSAL = """
import json
import numpy as np
import chip_smoke as cs
from open_gpu_kernel_modules_tpu_torch import uvm
from open_gpu_kernel_modules_tpu_torch.runtime import hbm, native

rng = np.random.default_rng(0)
with uvm.VaSpace() as vs:
    bufs, tiles, _ = cs.hbm_slices(vs, rng, native.hbm_view(0)[1],
                                   8 << 20, 4)
    with hbm.HbmRuntime(dev=0, device="cpu") as rt:
        rec = cs.hbm_oversub(rt, bufs, tiles)
    rec["alone_gbps"] = cs.hbm_alone(bufs)
    with hbm.HbmRuntime(dev=0, device="cpu") as rt:
        rec["warm"] = cs.hbm_oversub(rt, bufs, tiles)
        for b in bufs:
            b.free()
        rec.update(cs.hbm_paths(rt, vs, rng, 16 << 20, 8 << 20))
print(json.dumps(rec))
"""


def test_chip_smoke_real_arena_phase_on_the_cpu():
    """chip_smoke.py's phase 10 helpers (configs #2 and #1 through the REAL
    arena) rehearsed at a small size on ``HbmRuntime(device="cpu")``: every
    check of the phase runs (resident pages against their patterns after a
    cold and a warm REAL pair, uploaded <= published, card->host writes,
    suspend/resume, the forced overflow, CXL DMA both ways).  In a child:
    the arena size is read once per process."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, TPUMEM_FAKE_HBM_MB="64")
    proc = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=repo,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    for pair in (rec, rec["warm"]):
        assert pair["slices"] == 32 and pair["resident_pages_checked"] > 0
        assert 0 < pair["chip_verified_mb"] <= pair["published_dirty_mb"]
    assert rec["alone_gbps"] > 0
    assert rec["overflowed"] and rec["overflow_resyncs"] >= 1
    assert rec["card_to_host_async_readbacks"] > 0
