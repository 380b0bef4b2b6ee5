"""The port's memring ring (``uvm/memring.py``) and ICI link recovery
(``runtime/ici.py``, ``uvm/inject.py``) against the JAX package's, on the
CPU.

Each of the eight scenarios of ``tests/test_memring.py`` is one test
parametrised over the package: a case runs the scenario through that
package's modules, in VA spaces of its own on the one native engine both
load, and makes the JAX test's checks.  A scenario returns what it observed
where that is deterministic (CQE statuses, opcodes and bytes per cookie,
ring counts, residency, data, counter deltas of its own); the port's case
requires the JAX package's observation.  The ICI flap of
``tests/test_peermem_ici.py`` runs in a child of each package with four
native devices (the device table is read once per process), and adds a link
reset and a training pass.
"""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from open_gpu_kernel_modules_tpu import uvm as juvm, utils as jutils
from open_gpu_kernel_modules_tpu.models import serving as jserving
from open_gpu_kernel_modules_tpu.runtime import native as jnative
from open_gpu_kernel_modules_tpu.uvm import inject as jinject
from open_gpu_kernel_modules_tpu.uvm import managed as jmanaged
from open_gpu_kernel_modules_tpu.uvm import memring as jmemring
from open_gpu_kernel_modules_tpu_torch import uvm as tuvm, utils as tutils
from open_gpu_kernel_modules_tpu_torch.models import serving as tserving
from open_gpu_kernel_modules_tpu_torch.runtime import native as tnative
from open_gpu_kernel_modules_tpu_torch.uvm import inject as tinject
from open_gpu_kernel_modules_tpu_torch.uvm import managed as tmanaged
from open_gpu_kernel_modules_tpu_torch.uvm import memring as tmemring

MB = 1 << 20
SPAN = 64 * 1024
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(
    name="jax", module="open_gpu_kernel_modules_tpu", uvm=juvm,
    utils=jutils, native=jnative, inject=jinject, memring=jmemring,
    serving=jserving, Tier=jmanaged.Tier)
PORT = types.SimpleNamespace(
    name="port", module="open_gpu_kernel_modules_tpu_torch", uvm=tuvm,
    utils=tutils, native=tnative, inject=tinject, memring=tmemring,
    serving=tserving, Tier=tmanaged.Tier)


def res(info):
    return (info.host, info.hbm, info.cxl)


def cqes_by_cookie(cqes):
    """(status, opcode name, bytes) of each completion, by cookie."""
    return {c.user_data: (c.status, c.opcode.name, c.bytes) for c in cqes}


def counts(ring):
    return tuple(vars(ring.counts).values())


# ----------------------------------------------------- test_memring.py

def batched_migrate_round_trip(pkg, vs):
    Tier, memring = pkg.Tier, pkg.memring
    n = 64
    buf = vs.alloc(n * SPAN)
    view = buf.view()
    view[:] = 0xC3
    with memring.MemRing(vs, entries=128) as ring:
        for i in range(n):
            ring.migrate(buf.address + i * SPAN, SPAN, Tier.HBM)
        assert ring.submit_and_wait() == n
        cqes = ring.completions(check=True)
        assert len(cqes) == n
        assert all(c.opcode == memring.Op.MIGRATE for c in cqes)
        assert sum(c.bytes for c in cqes) == n * SPAN
        assert buf.residency().hbm
        out = [cqes_by_cookie(cqes), res(buf.residency())]
        ring.evict(buf.address, n * SPAN, Tier.HOST, user_data=0xDEAD)
        ring.submit_and_wait()
        (c,) = ring.completions(check=True)
        assert c.user_data == 0xDEAD
        assert c.opcode == memring.Op.EVICT
        out += [cqes_by_cookie([c]), counts(ring)]
    assert buf.residency().host
    assert int(view[0]) == 0xC3 and int(view[n * SPAN - 1]) == 0xC3
    out += [res(buf.residency()), bytes(view[::SPAN])]
    buf.free()
    return out


def link_chain_and_fence(pkg, vs):
    Tier, memring = pkg.Tier, pkg.memring
    buf = vs.alloc(4 * SPAN)
    buf.view()[:] = 0x11
    with memring.MemRing(vs, entries=64, workers=4) as ring:
        ring.migrate(buf.address, 4 * SPAN, Tier.HBM, link=True)
        ring.migrate(buf.address, 4 * SPAN, Tier.CXL, link=True)
        ring.evict(buf.address, 4 * SPAN, Tier.HOST)
        fence_cookie = ring.fence(user_data=500)
        ring.submit_and_wait()
        cqes = ring.completions(check=True)
        assert len(cqes) == 4
        fence = next(c for c in cqes if c.user_data == fence_cookie)
        for c in cqes:
            if c.user_data != fence_cookie:
                assert c.end_ns <= fence.start_ns
                assert c.seq < fence.seq
        out = [cqes_by_cookie(cqes), counts(ring)]
    assert buf.residency().host
    out += [res(buf.residency()), int(buf.view()[-1])]
    buf.free()
    return out


def prefetch_and_advise(pkg, vs):
    Tier, memring = pkg.Tier, pkg.memring
    buf = vs.alloc(2 * MB)
    buf.view()[:] = 0x3C
    with memring.MemRing(vs) as ring:
        ring.prefetch(buf.address, 2 * MB, dev=0)
        ring.submit_and_wait()
        (c,) = ring.completions(check=True)
        assert c.bytes == 2 * MB
        assert buf.residency().hbm
        out = [cqes_by_cookie([c]), res(buf.residency())]
        ring.advise(buf.address, 2 * MB, memring.Advise.PREFERRED,
                    tier=Tier.CXL, link=True)
        ring.evict(buf.address, 2 * MB, Tier.CXL)
        ring.submit_and_wait()
        out.append(cqes_by_cookie(ring.completions(check=True)))
        assert buf.residency().cxl
        out += [res(buf.residency()), counts(ring)]
    out.append(int(buf.view()[MB]))
    buf.free()
    return out


def error_cqe_and_chain_cancel(pkg, vs):
    Tier, memring, inj = pkg.Tier, pkg.memring, pkg.inject
    buf = vs.alloc(2 * SPAN)
    buf.view()[:] = 0x55
    with memring.MemRing(vs) as ring:
        inj.enable(inj.Site.MEMRING_SUBMIT, inj.Mode.ONESHOT, burst=8)
        try:
            ring.migrate(buf.address, SPAN, Tier.HBM, user_data=7,
                         link=True)
            ring.migrate(buf.address + SPAN, SPAN, Tier.HBM, user_data=8)
            ring.submit_and_wait()
        finally:
            inj.disable_all()
        cqes = ring.completions()
        assert len(cqes) == 2
        by_cookie = {c.user_data: c for c in cqes}
        assert not by_cookie[7].ok
        assert not by_cookie[8].ok
        out = [cqes_by_cookie(cqes)]
        ring.migrate(buf.address, SPAN, Tier.HBM)
        inj.enable(inj.Site.MEMRING_SUBMIT, inj.Mode.ONESHOT, burst=8)
        try:
            ring.submit_and_wait()
        finally:
            inj.disable_all()
        with pytest.raises(pkg.native.RmError) as err:
            ring.completions(check=True)
        assert ring.counts.error_cqes >= 2
        out += [err.value.status, counts(ring)]
    assert int(buf.view()[0]) == 0x55
    out.append(int(buf.view()[SPAN]))
    buf.free()
    return out


def ring_counts_and_shm(pkg, vs):
    memring = pkg.memring
    with memring.MemRing(vs, entries=32) as ring:
        assert ring.shm_fd() >= 0
        assert ring.sq_space == 32
        buf = vs.alloc(SPAN)
        buf.view()[:] = 1
        seq0 = ring.next_seq
        for _ in range(8):
            ring.prefetch(buf.address, SPAN)
        assert ring.sq_space == 24
        assert ring.next_seq == seq0 + 8 == ring.last_seq + 1
        ring.submit_and_wait()
        cqes = ring.completions(check=True)
        c = ring.counts
        assert c.submitted == 8
        assert c.completed == 8
        assert c.cq_overflows == 0
        buf.free()
        return [cqes_by_cookie(cqes), counts(ring)]


def serving_backing_uses_ring(pkg, vs):
    pool_shape = (2, 16, 128, 16, 8)    # [L, N, P, KV, D] = 2 MB f32
    dt = np.dtype(np.float32)
    page_bytes = 128 * 16 * 8 * dt.itemsize
    backing = pkg.serving.ManagedKVBacking(pool_shape, dt, page_bytes, dev=0)
    try:
        assert backing.ring is not None
        before = backing.ring.counts
        k, v = backing.read_pages([3, 5, 8])
        after = backing.ring.counts
        assert after.submitted - before.submitted == 6
        assert after.completed == after.submitted
        assert after.error_cqes == 0
        assert k.shape == (2, 3, 128, 16, 8)
        assert v.shape == k.shape
        assert (k == 0).all() and (v == 0).all()
        backing.read_pages([0, 15])
        assert backing.ring.counts.error_cqes == 0
        return [counts(backing.ring), k.shape, float(np.abs(k).sum())]
    finally:
        backing.close()


def dependency_trackers(pkg, vs):
    Tier, memring, utils = pkg.Tier, pkg.memring, pkg.utils
    stalls0 = utils.counter("memring_dep_stalls")
    ooo0 = utils.counter("memring_ooo_retires")
    with memring.MemRing(vs, entries=64, workers=2) as ring:
        ring.nop(user_data=1, delay_ns=150_000_000)
        seq_a = ring.last_seq
        ring.submit()
        time.sleep(0.03)
        ring.nop(user_data=2, deps=[memring.dep(ring, seq_a)])
        ring.nop(user_data=3)
        ring.nop(user_data=4)
        ring.nop(user_data=5,
                 deps=[memring.dep(ring.ring_id, seq_a, ordered=True)])
        ring.submit()
        ring.wait(2, timeout_ns=5_000_000_000)
        early = ring.completions()
        assert {c.user_data for c in early} <= {3, 4}, early
        ring.drain(timeout_ns=5_000_000_000)
        rest = ring.completions(check=True)
        ends = {c.user_data: c.end_ns for c in rest}
        assert ends[2] >= ends[1] and ends[5] >= ends[1]
        out = [cqes_by_cookie(early + rest), counts(ring)]
    assert utils.counter("memring_dep_stalls") > stalls0
    assert utils.counter("memring_ooo_retires") > ooo0
    assert utils.trace_quantile_ns("memring.depwait", 0.5) > 0

    cancelled0 = utils.counter("memring_dep_cancelled")
    with memring.MemRing(vs, entries=16, workers=1) as ring:
        ring.evict(0x1000, 4096, Tier.HBM, user_data=7)
        bad_seq = ring.last_seq
        ring.nop(user_data=8, deps=[memring.dep(ring, bad_seq)])
        ring.submit_and_wait()
        by_cookie = {c.user_data: c for c in ring.completions()}
        assert not by_cookie[7].ok
        assert by_cookie[8].status == pkg.native.TPU_ERR_INVALID_STATE
        out += [cqes_by_cookie(by_cookie.values()), counts(ring)]
    out.append(utils.counter("memring_dep_cancelled") - cancelled0)
    assert out[-1] == 1
    return out


def batch_dep_rewrite(pkg, vs):
    memring = pkg.memring
    with memring.MemRing(vs, entries=16, workers=1) as ring:
        ring.nop(user_data=1, delay_ns=20_000_000)
        ring.nop(user_data=2, deps=[memring.dep_batch(0)])
        ring.submit_and_wait()
        cqes = ring.completions(check=True)
        cq = {c.user_data: c for c in cqes}
        assert cq[2].end_ns >= cq[1].end_ns
        with pytest.raises(pkg.native.RmError) as err:
            ring.nop(user_data=9, deps=[memring.dep_batch(5)])
        return [cqes_by_cookie(cqes), err.value.status, counts(ring)]


SCENARIOS = {f.__name__: f for f in (
    batched_migrate_round_trip, link_chain_and_fence, prefetch_and_advise,
    error_cqe_and_chain_cancel, ring_counts_and_shm,
    serving_backing_uses_ring, dependency_trackers, batch_dep_rewrite)}

_seen = {}


def observe(name, pkg):
    """The scenario's observations through ``pkg`` (JAX's run once)."""
    key = (name, pkg.name)
    if key not in _seen:
        vs = pkg.uvm.VaSpace()
        try:
            _seen[key] = SCENARIOS[name](pkg, vs)
        finally:
            vs.close()
    return _seen[key]


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=lambda p: p.name)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_memring_matches_jax(name, pkg):
    """The scenario meets the JAX test's checks through ``pkg``; the port's
    CQE statuses, counts and bytes equal the JAX package's."""
    got = observe(name, pkg)
    if pkg is PORT:
        assert got == observe(name, JAX)


# -------------------------------------------------- test_peermem_ici.py

# The flap of test_ici_injected_flap_recovers, then an administrative
# failure of the same link cleared by reset_link and train_links.
_ICI_FLAP = r"""
import ctypes, json, sys
sys.path.insert(0, %(repo)r)
from %(module)s.runtime import ici, native
from %(module)s.uvm import inject as inj

out = {}
lib = native.load()
base0 = lib.tpurmDeviceHbmBase(lib.tpurmDeviceGet(0))
base1 = lib.tpurmDeviceHbmBase(lib.tpurmDeviceGet(1))
ctypes.memset(base0, 0x5C, 8192)
ctypes.memset(base1, 0, 8192)


def byte(addr):
    return ctypes.cast(addr, ctypes.POINTER(ctypes.c_ubyte))[0]


def states():
    return [int(ici.link_info(0, l).state) for l in range(ici.link_count(0))]


inj.set_seed(7)
with ici.PeerAperture(0, 1) as ap:
    inj.enable(inj.Site.ICI_LINK, inj.Mode.ONESHOT)
    ap.write(0, 0, 4096)
    inj.disable(inj.Site.ICI_LINK)
    out["failed_after_flap"] = int(ici.LinkState.FAILED) in states()
    out["flaps"] = inj.recovery_counters(detail=True)["ici_link_flaps"]
    out["byte_after_flap"] = byte(base1 + 100)
    ap.write(4096, 4096, 4096)
    out["retrains"] = inj.recovery_counters()["recover_link_retrains"]
    out["states_after_retrain"] = states()
    out["hops_after_retrain"] = ici.route_hops(0, 1)
    out["byte_after_retrain"] = byte(base1 + 4096 + 100)
out["aperture_closed"] = ap._handle is None

direct = next(l for l in range(ici.link_count(0))
              if ici.link_info(0, l).peer == 1)
ici.inject_link_failure(0, direct)
out["detour_hops"] = ici.route_hops(0, 1)
ici.reset_link(0, direct)
out["state_after_reset"] = int(ici.link_info(0, direct).state)
trained0 = lib.tpurmCounterGet(b"ici_links_trained")
ici.train_links(0)
out["trained"] = lib.tpurmCounterGet(b"ici_links_trained") - trained0
out["states_after_training"] = states()
out["restored_hops"] = ici.route_hops(0, 1)
out["recovery"] = inj.recovery_counters(detail=True)
out["stats"] = {k: list(v) for k, v in inj.stats().items()}
print(json.dumps(out))
"""

_ici_seen = {}


def ici_flap(pkg):
    if pkg.name not in _ici_seen:
        env = dict(os.environ, TPUMEM_FAKE_TPU_COUNT="4")
        script = _ICI_FLAP % {"repo": REPO, "module": pkg.module}
        proc = subprocess.run([sys.executable, "-c", script], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-3000:]
        _ici_seen[pkg.name] = json.loads(proc.stdout.strip().splitlines()[-1])
    return _ici_seen[pkg.name]


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=lambda p: p.name)
def test_ici_injected_flap_recovers_matches_jax(pkg):
    """A one-shot ICI_LINK flap drives the direct 0 <-> 1 link FAILED
    mid-copy; the copy lands over the detour and the next copy's lazy
    retrain restores the direct route.  Then an administrative failure
    detours 0 -> 1 over three hops until reset_link (link DOWN) and
    train_links (every link ACTIVE) restore it.  The port's observations
    and recovery counters equal the JAX package's."""
    out = ici_flap(pkg)
    assert out["flaps"] >= 1
    assert out["failed_after_flap"]
    assert out["byte_after_flap"] == 0x5C
    assert out["retrains"] >= 1
    assert all(s == 2 for s in out["states_after_retrain"])
    assert out["hops_after_retrain"] == 1
    assert out["byte_after_retrain"] == 0x5C
    assert out["aperture_closed"]
    assert out["detour_hops"] == 3
    assert out["state_after_reset"] == 0
    assert out["trained"] >= 1
    assert all(s == 2 for s in out["states_after_training"])
    assert out["restored_hops"] == 1
    assert out["stats"]["ici.link"][1] == 1
    if pkg is PORT:
        assert out == ici_flap(JAX)
