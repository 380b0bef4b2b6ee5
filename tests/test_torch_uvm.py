"""The port's ``uvm`` bindings (managed memory, tools sessions, PM, the
copy-engine pool, the journal, hotness) and ``utils`` held against the JAX
package's, on the CPU.

Each scenario of ``tests/test_uvm.py``, the ``ce`` checks of
``tests/test_ce.py`` and the journal and hotness surfaces of
``tests/test_journal.py`` and ``tests/test_hot.py`` runs twice in this
process, one run after the other: once through the JAX package's modules
and once through the port's.  Both load the same native engine, each in VA
spaces of its own.  A scenario makes the JAX test's checks on each run and
returns what it observed where that is deterministic (residency, data,
event kinds, flags); the two runs must observe the same.  The load-bound
fault-latency test of ``tests/test_uvm.py`` (a child process timed against
the box's load) is not repeated here.
"""

import ctypes
import json
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest

from open_gpu_kernel_modules_tpu import uvm as juvm, utils as jutils
from open_gpu_kernel_modules_tpu.runtime import native as jnative
from open_gpu_kernel_modules_tpu.uvm import (
    ce as jce, hot as jhot, journal as jjournal)
from open_gpu_kernel_modules_tpu_torch import uvm as tuvm, utils as tutils
from open_gpu_kernel_modules_tpu_torch.runtime import native as tnative
from open_gpu_kernel_modules_tpu_torch.uvm import (
    ce as tce, hot as thot, journal as tjournal, vac as tvac)

MB = 1 << 20
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPUBOX = os.path.join(REPO, "tools", "tpubox.py")

JAX = types.SimpleNamespace(name="jax", uvm=juvm, utils=jutils, ce=jce,
                            hot=jhot, journal=jjournal, native=jnative)
PORT = types.SimpleNamespace(name="port", uvm=tuvm, utils=tutils, ce=tce,
                             hot=thot, journal=tjournal, native=tnative)


def res(info):
    """The residency fields a scenario compares (no arena offsets)."""
    return (info.host, info.hbm, info.cxl, info.cpu_mapped, info.dev_mapped,
            info.remote)


def same_state(port_read, jax_read, tries=5):
    """The port and JAX read the same process-wide engine state.  Background
    engine threads may move a counter between two reads, so the pair is
    read again (at most ``tries`` times) until one pair agrees."""
    for _ in range(tries):
        got, want = port_read(), jax_read()
        if got == want:
            return got
    assert got == want


def kinds(pkg, events, wanted):
    """Names of the event types among ``wanted`` that ``events`` holds."""
    return sorted({pkg.uvm.EventType(e.type).name for e in events
                   if e.type in wanted})


# ---------------------------------------------------------- test_uvm.py

def first_touch_populates_host(pkg, vs):
    buf = vs.alloc(4 * MB)
    arr = buf.view(np.float32)
    arr[0], arr[-1] = 1.5, 2.5
    info = buf.residency()
    assert info.host and info.cpu_mapped
    out = (res(info), float(arr[0]), float(arr[-1]))
    buf.free()
    return out


def migrate_and_fault_back(pkg, vs):
    Tier = pkg.uvm.Tier
    buf = vs.alloc(4 * MB)
    arr = buf.view(np.uint8)
    arr[:] = 7
    buf.migrate(Tier.HBM)
    seen = [res(buf.residency())]
    assert seen[0][1] and not seen[0][0] and not seen[0][3]
    seen.append(int(arr[123]))
    seen.append(res(buf.residency()))
    buf.migrate(Tier.CXL)
    seen.append(res(buf.residency()))
    seen.append(int(arr[-1]))
    assert seen[1] == seen[4] == 7 and seen[3][2]
    buf.free()
    return seen


def device_access_faults_to_hbm(pkg, vs):
    buf = vs.alloc(4 * MB)
    buf.view()[:] = 3
    buf.device_access(dev=0, write=True)
    info = buf.residency()
    assert info.hbm and info.hbm_device == 0
    buf.free()
    return res(info), info.hbm_device


def oversubscription_evicts_and_preserves_data(pkg, vs):
    before = pkg.uvm.fault_stats()
    bufs = [vs.alloc(32 * MB) for _ in range(8)]
    for i, buf in enumerate(bufs):
        buf.view()[:] = 0x40 + i
        buf.migrate(pkg.uvm.Tier.HBM)
    evicted = pkg.uvm.fault_stats().evictions > before.evictions
    ends = [(int(b.view()[0]), int(b.view()[-1])) for b in bufs]
    assert evicted and ends == [(0x40 + i, 0x40 + i) for i in range(8)]
    for buf in bufs:
        buf.free()
    return evicted, ends


def read_duplication(pkg, vs):
    buf = vs.alloc(2 * MB)
    arr = buf.view(np.uint8)
    arr[:] = 9
    buf.set_read_duplication(True)
    buf.migrate(pkg.uvm.Tier.CXL)
    seen = [res(buf.residency()), int(arr[0]), res(buf.residency())]
    arr[0] = 10
    seen.append(res(buf.residency()))
    assert seen[0][2] and seen[2][0] and seen[2][2]
    assert seen[3][0] and not seen[3][2]
    buf.set_read_duplication(False)
    buf.free()
    return seen


def preferred_location_steers_device_fault(pkg, vs):
    buf = vs.alloc(2 * MB)
    buf.view()[:] = 1
    buf.set_preferred(pkg.uvm.Tier.CXL)
    buf.device_access(dev=0, write=False)
    info = buf.residency()
    assert info.cxl and not info.hbm
    buf.unset_preferred()
    buf.free()
    return res(info)


def tools_events_flow(pkg, vs):
    E = pkg.uvm.EventType
    with vs.tools_session() as session:
        session.enable([E.MIGRATION, E.CPU_FAULT, E.EVICTION])
        buf = vs.alloc(2 * MB)
        buf.view()[:] = 5
        buf.migrate(pkg.uvm.Tier.HBM)
        _ = buf.view()[0]
        got = kinds(pkg, session.read(), {E.MIGRATION, E.CPU_FAULT})
        buf.free()
    assert got == ["CPU_FAULT", "MIGRATION"]
    return got


def fault_stats_progress(pkg, vs):
    before = pkg.uvm.fault_stats()
    buf = vs.alloc(2 * MB)
    buf.view()[:] = 1
    after = pkg.uvm.fault_stats()
    flags = (after.faults_cpu > before.faults_cpu,
             after.batches > before.batches,
             0 < after.service_ns_p50 < 50_000_000)
    assert all(flags)
    buf.free()
    return flags


def cpu_write_after_device_read_dup(pkg, vs):
    buf = vs.alloc(2 * MB)
    arr = buf.view(np.uint8)
    arr[:] = 4
    buf.device_access(dev=0, write=False)
    seen = [res(buf.residency())]
    arr[0] = 9
    seen += [res(buf.residency()), int(arr[0])]
    assert seen[0][0] and seen[0][1]
    assert seen[1][0] and not seen[1][1] and seen[2] == 9
    buf.free()
    return seen


def in_module_suites(pkg, vs):
    """The engine's in-module tests: range trees, pmm, va block, locks,
    accessed-by, tools, replay policies and cancel, suspend/resume."""
    for cmd in (1, 2, 3, 5, 6, 8, 9, 11, 12):
        vs.run_test(cmd)
    return True


def numpy_compute_on_managed_memory(pkg, vs):
    buf = vs.alloc(8 * MB)
    arr = buf.view(np.float32)
    arr[:] = np.arange(arr.size, dtype=np.float32)
    buf.migrate(pkg.uvm.Tier.CXL)
    total = float(np.sum(arr[:1024]))
    assert total == float(np.sum(np.arange(1024, dtype=np.float32)))
    buf.free()
    return total


def accessed_by_maps_instead_of_migrating(pkg, vs):
    buf = vs.alloc(2 * MB)
    buf.view()[:] = 7
    buf.set_accessed_by(0)
    seen = [res(buf.residency())]
    buf.device_access(dev=0, write=False)
    seen.append(res(buf.residency()))
    buf.unset_accessed_by(0)
    seen.append(res(buf.residency()))
    buf.device_access(dev=0, write=False)
    seen.append(res(buf.residency()))
    assert seen[0][4] and seen[1][0] and not seen[1][1] and seen[1][4]
    assert not seen[2][4] and seen[3][1]
    buf.free()
    return seen


def read_dup_events_emitted(pkg, vs):
    E = pkg.uvm.EventType
    with vs.tools_session() as session:
        session.enable([E.READ_DUP])
        buf = vs.alloc(2 * MB)
        buf.view()[:] = 3
        buf.set_read_duplication(True)
        buf.device_access(dev=0, write=False)
        got = kinds(pkg, session.read(), {E.READ_DUP})
        buf.free()
    assert got == ["READ_DUP"]
    return got


def tools_counters_and_threshold(pkg, vs):
    E = pkg.uvm.EventType
    with vs.tools_session() as session:
        seen = [session.counter("uvm_fault_batches") is None]
        session.enable_counters()
        seen.append(session.counter("uvm_fault_batches") is not None)
        session.set_notification_threshold(1)
        session.enable([E.CPU_FAULT])
        buf = vs.alloc(2 * MB)
        buf.view()[:] = 1
        seen += [session.pending >= 1, session.notifications >= 1]
        buf.free()
    assert all(seen)
    return seen


def access_counters_hot_cold_convergence(pkg, vs):
    """Hot and cold working sets converge to their tiers without explicit
    migration, through the access counters (own VA space and knobs)."""
    Tier, E = pkg.uvm.Tier, pkg.uvm.EventType
    env = {"TPUMEM_UVM_ACCESS_COUNTER_THRESHOLD": "4",
           "TPUMEM_UVM_ACCESS_COUNTER_WINDOW_MS": "10000"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with pkg.uvm.VaSpace() as space:
            hot, cold = space.alloc(2 * MB), space.alloc(2 * MB)
            hot.view()[:] = 1
            cold.view()[:] = 2
            hot.set_preferred(Tier.CXL)
            cold.set_preferred(Tier.CXL)
            with space.tools_session() as session:
                session.enable([E.ACCESS_COUNTER])
                hot.device_access(dev=0, write=False)
                cold.device_access(dev=0, write=False)
                seen = [res(hot.residency())]
                for _ in range(8):
                    hot.device_access(dev=0, write=False)
                seen += [res(hot.residency()), res(cold.residency()),
                         kinds(pkg, session.read(), {E.ACCESS_COUNTER})]
        assert seen[0][2] and not seen[0][1] and seen[1][1]
        assert seen[2][2] and not seen[2][1] and seen[3] == ["ACCESS_COUNTER"]
        return seen
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def suspend_resume_saves_and_restores(pkg, vs):
    buf = vs.alloc(2 * MB)
    buf.view()[:] = 9
    buf.migrate(pkg.uvm.Tier.HBM)
    seen = [res(buf.residency())]
    pkg.uvm.suspend()
    try:
        seen.append(res(buf.residency()))
    finally:
        pkg.uvm.resume()
    seen += [res(buf.residency()), int(buf.view()[100])]
    assert seen[1][0] and not seen[1][1] and seen[2][1] and seen[3] == 9
    buf.free()
    return seen


def suspend_resume_cross_thread(pkg, vs):
    buf = vs.alloc(2 * MB)
    buf.view()[:] = 7
    buf.migrate(pkg.uvm.Tier.HBM)
    pkg.uvm.suspend()
    err = []

    def resumer():
        try:
            pkg.uvm.resume()
        except Exception as e:            # pragma: no cover
            err.append(e)

    t = threading.Thread(target=resumer)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and not err
    value = int(buf.view()[5])
    buf.migrate(pkg.uvm.Tier.HOST)
    buf.free()
    assert value == 7
    return value


def policy_split_two_halves(pkg, vs):
    Tier = pkg.uvm.Tier
    buf = vs.alloc(8 * MB)
    buf.view()[:] = 0x42
    half = 4 * MB
    buf.set_preferred(Tier.CXL, offset=0, length=half)
    buf.set_preferred(Tier.HBM, offset=half, length=half)
    with pytest.raises(pkg.native.RmError):
        buf.set_preferred(Tier.HBM, offset=0, length=64 * 1024)
    buf.device_access(dev=0, write=True)
    seen = [res(buf.residency(offset=o))
            for o in (0, half - 1, half, 8 * MB - 1)]
    assert seen[0][2] and seen[1][2] and seen[2][1] and seen[3][1]
    v = buf.view()
    seen.append((int(v[half - 1]), int(v[half])))
    addr = buf.address
    buf.free()
    lib = pkg.native.load()
    seen.append(lib.uvmMemFree(vs._handle, ctypes.c_void_p(addr)) != 0)
    assert seen[-2] == (0x42, 0x42) and seen[-1]
    return seen


def hmm_pageable_adopt_and_ats(pkg, vs):
    """Device access to pageable memory (ATS), and adoption of an anonymous
    mapping into managed memory with its contents."""
    lib = pkg.native.load()
    lib.uvmPageableAdopt.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_uint64]
    lib.uvmPageableAdopt.restype = ctypes.c_uint32
    lib.uvmDeviceAccess.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                    ctypes.c_void_p, ctypes.c_uint64,
                                    ctypes.c_int]
    lib.uvmDeviceAccess.restype = ctypes.c_uint32
    lib.uvmMemFree.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.uvmMemFree.restype = ctypes.c_uint32
    arr = np.full(64 * 1024, 7, np.uint8)
    before = pkg.utils.counter("uvm_ats_accesses")
    seen = [lib.uvmDeviceAccess(vs._handle, 0, arr.ctypes.data, arr.nbytes,
                                0),
            pkg.utils.counter("uvm_ats_accesses") > before, int(arr[100])]
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long]
    size = 4 * MB
    raw = libc.mmap(None, size + 2 * MB, 0x3, 0x22, -1, 0)   # RW anon
    base = (raw + 2 * MB - 1) & ~(2 * MB - 1)
    view = np.frombuffer((ctypes.c_char * size).from_address(base), np.uint8)
    view[:] = 0x5E
    seen += [lib.uvmPageableAdopt(vs._handle, base, size), int(view[123]),
             lib.uvmDeviceAccess(vs._handle, 0, base, 2 * MB, 1)]
    info = pkg.uvm.managed._ResidencyInfo()
    seen += [lib.uvmResidencyInfo(vs._handle, base, ctypes.byref(info)),
             bool(info.residentHbm), int(view[123])]
    view[7] = 0x42
    seen += [lib.uvmMemFree(vs._handle, base), int(view[7]), int(view[123])]
    view[8] = 1                                    # still writable
    assert seen == [0, True, 7, 0, 0x5E, 0, 0, True, 0x5E, 0, 0x42, 0x5E]
    return seen


def widened_event_vocabulary(pkg, vs):
    E = pkg.uvm.EventType
    wanted = {E.GPU_FAULT_REPLAY, E.PTE_UPDATE, E.TLB_INVALIDATE,
              E.ATS_ACCESS, E.PM_SUSPEND, E.PM_RESUME}
    with vs.tools_session(capacity=4096) as sess:
        sess.enable(list(E))
        buf = vs.alloc(4 * MB)
        buf.view()[:] = 1
        buf.device_access(dev=0, write=True)
        buf.migrate(pkg.uvm.Tier.HOST)
        arr = np.full(64 * 1024, 3, np.uint8)
        assert pkg.native.load().uvmDeviceAccess(
            vs._handle, 0, arr.ctypes.data, arr.nbytes, 0) == 0
        pkg.uvm.suspend()
        pkg.uvm.resume()
        got = kinds(pkg, sess.read(4096), wanted)
        buf.free()
    assert len(got) == len(wanted)
    return got


def tools_mmap_queue(pkg, vs):
    Tier, E = pkg.uvm.Tier, pkg.uvm.EventType
    with vs.tools_session(capacity=64) as sess:
        sess.enable([E.MIGRATION])
        with sess.map_queue() as q:
            buf = vs.alloc(2 * MB)
            buf.view()[:] = 1
            buf.migrate(Tier.HBM)
            seen = [q.capacity, q.widx > q.ridx,
                    kinds(pkg, q.read(), {E.MIGRATION}),
                    q.ridx == q.widx]
            for _ in range(70):
                buf.migrate(Tier.HOST)
                buf.migrate(Tier.HBM)
            seen += [q.widx - q.ridx, q.dropped > 0, sess.pending]
            with pytest.raises(RuntimeError, match="single owner"):
                sess.read()
            buf.free()
    assert seen == [64, True, ["MIGRATION"], True, 64, True, 64]
    return seen


UVM_SCENARIOS = [
    first_touch_populates_host, migrate_and_fault_back,
    device_access_faults_to_hbm, oversubscription_evicts_and_preserves_data,
    read_duplication, preferred_location_steers_device_fault,
    tools_events_flow, fault_stats_progress, cpu_write_after_device_read_dup,
    in_module_suites, numpy_compute_on_managed_memory,
    accessed_by_maps_instead_of_migrating, read_dup_events_emitted,
    tools_counters_and_threshold, access_counters_hot_cold_convergence,
    suspend_resume_saves_and_restores, suspend_resume_cross_thread,
    policy_split_two_halves, hmm_pageable_adopt_and_ats,
    widened_event_vocabulary, tools_mmap_queue]


@pytest.mark.parametrize("scenario", UVM_SCENARIOS, ids=lambda f: f.__name__)
def test_uvm_matches_jax(scenario):
    out = {}
    for pkg in (JAX, PORT):
        with pkg.uvm.VaSpace() as vs:
            out[pkg.name] = scenario(pkg, vs)
    assert out["port"] == out["jax"]


# ----------------------------------------------------------- test_ce.py

def striping_stats_and_drain(pkg):
    """A migrate splits into stripes over >= 2 channels; per-channel bytes
    cover both directions; drain leaves nothing outstanding."""
    ce = pkg.ce
    prev = ce.channels()
    ce.set_channels(max(2, prev))
    try:
        before = ce.stats()
        with pkg.uvm.VaSpace() as vs:
            buf = vs.alloc(4 * MB)
            buf.view()[:] = 0x7E
            buf.migrate(pkg.uvm.Tier.HBM)
            buf.migrate(pkg.uvm.Tier.HOST)
            intact = bool((buf.view() == 0x7E).all())
            buf.free()
        ce.drain()
        after = ce.stats()
    finally:
        ce.set_channels(prev)
    moved = [a.bytes - b.bytes for a, b in zip(after.channels,
                                               before.channels)]
    seen = [intact, ce.channels() >= 1, len(after.channels) >= 2,
            after.stripe_splits > before.stripe_splits, sum(moved) >= 8 * MB,
            sum(1 for m in moved if m > 0) >= 2,
            all(c.outstanding == 0 for c in after.channels),
            sum(c.busy_ns for c in after.channels) > 0,
            after.total_bytes == sum(c.bytes for c in after.channels)]
    assert all(seen)
    return seen


def compressible_round_trip_bounds(pkg):
    """FP8-advised data round-trips within the format's bound (and both
    packages' engines give the same bytes); OFF restores bit-exactness."""
    with pkg.uvm.VaSpace() as vs:
        buf = vs.alloc(2 * MB)
        arr = buf.view(np.float32)
        src = np.random.default_rng(7).uniform(
            -100.0, 100.0, arr.size).astype(np.float32)
        arr[:] = src
        buf.set_compressible(pkg.uvm.Compress.FP8)
        wire0 = pkg.ce.stats().compressed_bytes_in
        buf.migrate(pkg.uvm.Tier.HBM)
        buf.migrate(pkg.uvm.Tier.HOST)
        lossy = arr.copy()
        bound = np.maximum(np.abs(src) / 16.0, 2.0 ** -9)
        assert bool((np.abs(lossy - src) <= bound + 1e-6).all())
        s = pkg.ce.stats()
        assert s.compressed_bytes_in - wire0 >= 2 * MB // 4
        assert s.compression_ratio > 3.5
        buf.set_compressible(pkg.uvm.Compress.OFF)
        arr[:] = src
        buf.migrate(pkg.uvm.Tier.HBM)
        buf.migrate(pkg.uvm.Tier.HOST)
        exact = bool((arr == src).all())
        buf.free()
    assert exact
    return lossy


@pytest.mark.parametrize("scenario", [striping_stats_and_drain,
                                      compressible_round_trip_bounds],
                         ids=lambda f: f.__name__)
def test_ce_matches_jax(scenario):
    got = {pkg.name: scenario(pkg) for pkg in (JAX, PORT)}
    assert np.array_equal(np.asarray(got["port"]), np.asarray(got["jax"]))


def test_ce_set_channels_bounds():
    for bad in (0, tce.MAX_CHANNELS + 1):
        with pytest.raises(ValueError):
            tce.set_channels(bad)
    assert (tce.CHANNELS_KEY, tce.DEFAULT_CHANNELS, tce.MAX_CHANNELS) == \
        (jce.CHANNELS_KEY, jce.DEFAULT_CHANNELS, jce.MAX_CHANNELS)


# ------------------------------------------------------ journal and hot

def test_journal_names_and_counts_match_jax():
    assert [t.name for t in tjournal.RecType] == \
        [t.name for t in jjournal.RecType]
    names = {tjournal.type_name(t) for t in tjournal.RecType}
    assert names == {jjournal.type_name(t) for t in jjournal.RecType}
    assert tjournal.type_name(0) == "none"
    before = tjournal.type_counts()["health.note"]
    tvac.note(0, tvac.Event.WD_NUDGE)
    tvac.clear(0)
    assert tjournal.type_counts()["health.note"] == before + 1
    same_state(tjournal.type_counts, jjournal.type_counts)
    emitted, _, cap = same_state(tjournal.stats, jjournal.stats)
    assert emitted > 0 and cap > 0
    same_state(tjournal.head, jjournal.head)


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=lambda p: p.name)
def test_journal_subscriber_tail(pkg):
    """A subscriber opened at head sees exactly the records emitted after
    it, with the futex doorbell waking the wait."""
    journal = pkg.journal
    with journal.Subscriber() as sub:
        assert sub.cap >= 64 and sub.cap & (sub.cap - 1) == 0
        journal.emit(journal.RecType.INJECT_HIT, dev=3, a0=14, a1=0xABC,
                     flow=4242)
        assert sub.wait(timeout_ns=2 * 10**9)
        recs = [r for r in sub.consume()
                if r.type == journal.RecType.INJECT_HIT and r.flow == 4242]
        assert len(recs) == 1
        r = recs[0]
        assert (r.dev, r.a0, r.a1, r.type_name) == (3, 14, 0xABC,
                                                    "inject.hit")
        assert r.seq > 0 and r.ts_ns > 0
        assert sub.emitted(journal.RecType.INJECT_HIT) >= 1
        assert sub.head >= sub.cursor and sub.dropped >= 0


def test_journal_text_and_crash_dump(tmp_path):
    """journal.text() is the grammar the analyzer parses; crash bundles
    need a dump directory."""
    tjournal.emit(tjournal.RecType.ICI_FLAP, dev=1, a0=1, a1=2)
    txt = tjournal.text()
    assert txt.startswith("# tpubox cap=") and "ici.flap" in txt
    f = tmp_path / "scrape.txt"
    f.write_text(txt)
    proc = subprocess.run([sys.executable, TPUBOX, str(f)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert "ici.flap" in proc.stdout
    if not os.environ.get("TPUMEM_DUMP_DIR"):
        assert tjournal.crash_dump("unit") == jjournal.crash_dump("unit") \
            == 0x56
    assert tjournal.last_bundle() == jjournal.last_bundle()


def hot_surface(pkg):
    hot = pkg.hot
    with pkg.uvm.VaSpace() as vs:
        buf = vs.alloc(2 * MB)
        buf.view()[:] = 3
        buf.device_access(dev=0, write=False)
        seen = [hot.span_score(buf.address, 2 * MB) > 0,
                hot.device_score(0) > 0]
        st = hot.stats()
        seen += [st.decisions >= 0, st.inject_skips,
                 sorted(hot.counters()), 0.0 <= hot.prefetch_precision() <= 1]
        buf.free()
    text = pkg.utils.metrics_text()
    seen += ["# TYPE tpurm_hot_device_score gauge" in text,
             'tpurm_hot_device_score{dev="0"}' in text,
             "driver/tpurm/hotness" in pkg.utils.procfs_list()]
    assert seen[:3] == [True] * 3 and seen[3] == 0 and all(seen[5:])
    return seen


def test_hot_surface_matches_jax():
    assert hot_surface(PORT) == hot_surface(JAX)
    same_state(lambda: vars(thot.stats()), lambda: vars(jhot.stats()))
    same_state(thot.counters, jhot.counters)


# ---------------------------------------------------------------- utils

def test_utils_diagnostics_match_jax(tmp_path, monkeypatch):
    with tuvm.VaSpace() as vs:
        buf = vs.alloc(2 * MB)
        tuvm.fault_stats_reset_windows()
        buf.view()[:] = 1
        buf.free()
    same_state(lambda: tutils.trace_quantile_ns("fault.latency", 0.99),
               lambda: jutils.trace_quantile_ns("fault.latency", 0.99))
    same_state(tutils.trace_stats, jutils.trace_stats)
    same_state(tutils.journal_dump, jutils.journal_dump)
    assert tutils.procfs_list() == jutils.procfs_list()
    node = "/proc/driver/tpurm/version"
    assert tutils.procfs_read(node) == jutils.procfs_read(node) != ""
    assert tutils.trace_armed() == jutils.trace_armed()
    monkeypatch.setenv("TPUMEM_SOME_KNOB", "0x20")
    monkeypatch.setenv("TPUMEM_BAD_KNOB", "lots")
    for key in ("some_knob", "bad_knob", "absent_knob"):
        assert tutils.registry_get(key, 7) == jutils.registry_get(key, 7)
    assert tutils.registry_get("some_knob") == 32
    names = ["channel_pushes", "uvm_fault_batches"]
    assert tutils.counters(names).keys() == jutils.counters(names).keys()


def test_utils_trace_export_and_save(tmp_path):
    tutils.trace_reset()
    tutils.trace_start()
    try:
        with tuvm.VaSpace() as vs:
            buf = vs.alloc(2 * MB)
            buf.view()[:] = 2
            buf.migrate(tuvm.Tier.HBM)
            buf.free()
    finally:
        tutils.trace_stop()
    text = tutils.trace_export_json()
    events = json.loads(text)["traceEvents"]
    assert events
    assert [e["name"] for e in events] == \
        [e["name"] for e in json.loads(jutils.trace_export_json())[
            "traceEvents"]]
    assert tutils.trace_export()["traceEvents"]
    path = tutils.trace_save(str(tmp_path / "t.json"))
    with open(path) as f:
        assert [e["name"] for e in json.load(f)["traceEvents"]] == \
            [e["name"] for e in events]
    assert tutils.trace_stats()["recorded"] > 0
    tutils.trace_reset()
