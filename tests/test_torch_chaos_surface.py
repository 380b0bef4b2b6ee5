"""The port's chaos and page-integrity surface (``uvm/inject.py``,
``uvm/shield.py``, ``uvm/reset.py``, ``uvm/vac.py``) against the JAX
package's, on the CPU.

Both packages bind the one native engine, whose inject, shield, reset and
health state is process-wide.  So a child process (four native devices: the
device table is read once per process) drives a choreography through one
package -- arm, poison a page, scrub, reset, post an evacuation request --
and reads every surface through both packages after each stage; the two
reads must be equal.  Each test is parametrised over the package that drives
the choreography.  The scoped arm of ``inject.enable`` is checked in this
process on a site no background engine thread evaluates.
"""

import json
import os
import subprocess
import sys
import types

import pytest

from open_gpu_kernel_modules_tpu.runtime import native as jnative
from open_gpu_kernel_modules_tpu.uvm import inject as jinject
from open_gpu_kernel_modules_tpu_torch.runtime import native as tnative
from open_gpu_kernel_modules_tpu_torch.uvm import inject as tinject

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(name="jax", module="open_gpu_kernel_modules_tpu",
                            inject=jinject, native=jnative)
PORT = types.SimpleNamespace(name="port",
                             module="open_gpu_kernel_modules_tpu_torch",
                             inject=tinject, native=tnative)


# ------------------------------------------------------------ in process

def scoped_arms(pkg):
    """A scoped PPM arm and a scoped one-shot on sched.admit, evaluated with
    and without their keys; returns (hit?, evaluations, hits) per step."""
    inj = pkg.inject
    site = inj.Site.SCHED_ADMIT
    key = 0x5EED0000

    def step(**scope):
        e0, h0 = inj.counts(site)
        fired = inj.should_fail(site, **scope)
        e1, h1 = inj.counts(site)
        return fired, e1 - e0, h1 - h0

    inj.enable(site, inj.Mode.PPM, 1_000_000, scope=key)
    try:
        seen = [step(), step(scope=key + 1), step(scope=key), step(scope=key)]
        inj.disable(site)
        inj.arm_oneshot(site, scope=key + 2)
        seen += [step(scope=key), step(), step(scope=key + 2),
                 step(scope=key + 2)]
        inj.arm_oneshot(site)
        seen += [step(scope=key + 7), step()]
    finally:
        inj.disable(site)
    return seen


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=lambda p: p.name)
def test_inject_scoped_arm_fires_only_on_its_key(pkg):
    """``enable(..., scope=K)`` hits only evaluations that carry K (every one
    of them at 1e6 PPM); a scoped one-shot fires once, on its key; an
    unscoped one-shot fires on the next evaluation whatever it carries.
    Every evaluation is counted.  The port's sequence is JAX's."""
    seen = scoped_arms(pkg)
    assert [f for f, _, _ in seen] == [False, False, True, True,
                                       False, False, True, False,
                                       True, False]
    assert all(e == 1 and h == int(f) for f, e, h in seen)
    if pkg is PORT:
        assert seen == scoped_arms(JAX)


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=lambda p: p.name)
def test_inject_names_and_status_checks_match_jax(pkg):
    """Site names, counter-name tuples, and the RmError that ``enable`` and
    ``arm_oneshot`` raise on a site the engine does not have."""
    inj = pkg.inject
    names = [inj.site_name(s) for s in inj.Site]
    assert names == [jinject.site_name(s) for s in jinject.Site]
    assert set(inj.stats()) == set(names)
    assert "mem.corrupt" in names and "dump.write" in names
    assert (inj.RECOVERY_COUNTERS, inj.DETAIL_COUNTERS) == \
        (jinject.RECOVERY_COUNTERS, jinject.DETAIL_COUNTERS)
    assert set(inj.recovery_counters()) == set(inj.RECOVERY_COUNTERS)
    statuses = []
    for arm in (lambda: inj.enable(99, inj.Mode.ONESHOT),
                lambda: inj.arm_oneshot(99)):
        with pytest.raises(pkg.native.RmError) as err:
            arm()
        statuses.append(err.value.status)
    assert statuses == [jnative.TPU_ERR_INVALID_ARGUMENT] * 2


# ------------------------------------------------------------- children

_SURFACE = r"""
import ctypes, json, os, sys, time
sys.path.insert(0, %(repo)r)
import numpy as np

from open_gpu_kernel_modules_tpu.uvm import (
    inject as j_inj, reset as j_reset, shield as j_shield, vac as j_vac)
from open_gpu_kernel_modules_tpu_torch.uvm import (
    inject as t_inj, reset as t_reset, shield as t_shield, vac as t_vac)
from %(module)s import uvm
from %(module)s.uvm import inject as inj, memring, reset, shield, vac
from %(module)s.uvm.managed import Tier

MB = 1 << 20
ARENA = int(os.environ["TPUMEM_FAKE_HBM_MB"]) * MB
out = {}


def both(name, port_read, jax_read, tries=5):
    # Background engine threads (the scrubber, the watchdog, health decay)
    # may move a value between two reads: read the pair again until it
    # agrees, and keep the last pair either way.
    for _ in range(tries):
        got, want = port_read(), jax_read()
        if got == want:
            break
    out[name] = [got, want]


def stats_of(mod):
    return lambda: vars(mod.stats())


def inject_reads(tag):
    both(tag + "/stats", t_inj.stats, j_inj.stats)
    both(tag + "/recovery", lambda: t_inj.recovery_counters(detail=True),
         lambda: j_inj.recovery_counters(detail=True))


def shield_reads(tag):
    both(tag + "/shield", stats_of(t_shield), stats_of(j_shield))
    both(tag + "/enabled", t_shield.enabled, j_shield.enabled)


# ---- a wire seal, a flip and a verify ---------------------------------
inj.set_seed(3)
shield_reads("start")
wire = np.arange(4096, dtype=np.uint32)
seal = shield.crc32c(wire)
both("crc32c_at", lambda: t_shield.crc32c_at(wire.ctypes.data, wire.nbytes),
     lambda: j_shield.crc32c_at(wire.ctypes.data, wire.nbytes))
out["seal"] = seal
inj.arm_oneshot(inj.Site.MEM_CORRUPT, scope=0xA11CE)
out["flipped"] = shield.inject_wire(wire, 0xA11CE)
out["verified"] = shield.verify_wire(wire, seal, 0xA11CE)
shield_reads("wire")
inject_reads("wire")

# ---- a poisoned page: a scoped flip on an exclusive park, read back ----
vs = uvm.VaSpace()
buf = vs.alloc(2 * MB)
buf.view()[:] = 7
buf.migrate(Tier.HBM)
buf.set_read_duplication(False)
inj.arm_oneshot(inj.Site.MEM_CORRUPT, scope=buf.address)
buf.migrate(Tier.CXL)
with memring.MemRing(vs) as ring:
    ring.prefetch(buf.address, 2 * MB, dev=0)
    ring.submit_and_wait()
    out["poison_cqes"] = [[c.status, c.bytes] for c in ring.completions()]
both("span_poisoned", lambda: t_shield.span_poisoned(buf.address, 2 * MB),
     lambda: j_shield.span_poisoned(buf.address, 2 * MB))
shield_reads("poison")
inject_reads("poison")
both("retired_total", t_shield.retired_pages, j_shield.retired_pages)
both("retired_per_dev", lambda: [t_shield.retired_pages(d) for d in range(4)],
     lambda: [j_shield.retired_pages(d) for d in range(4)])
both("span_retired",
     lambda: [t_shield.span_retired(t, d, 0, ARENA)
              for t in range(3) for d in range(4)],
     lambda: [j_shield.span_retired(t, d, 0, ARENA)
              for t in range(3) for d in range(4)])
both("scrub_now", t_shield.scrub_now, j_shield.scrub_now)
shield_reads("scrub")
out["scrubbed_by_pkg"] = shield.scrub_now(64)

# ---- a device reset ----------------------------------------------------
r0 = reset.stats().resets
reset.device_reset()
out["resets"] = reset.stats().resets - r0
both("reset", stats_of(t_reset), stats_of(j_reset))
both("mttr_ms", lambda: (t_reset.stats().last_mttr_ms,
                         t_reset.stats().mean_mttr_ms),
     lambda: (j_reset.stats().last_mttr_ms, j_reset.stats().mean_mttr_ms))
out["mttr_pkg"] = [reset.stats().last_mttr_ms, reset.stats().mean_mttr_ms]


# ---- health evidence and an operator's evacuation request ------------
def health(mod, d):
    i = vars(mod.info(d))
    i["state"] = int(i["state"])
    return i


for d in range(4):
    vac.clear(d)
vac.note(3, vac.Event.LINK_FLAP)
vac.note(3, vac.Event.RC_RESET)
both("info", lambda: [health(t_vac, d) for d in range(4)],
     lambda: [health(j_vac, d) for d in range(4)])
both("score", lambda: [t_vac.score(d) for d in range(4)],
     lambda: [j_vac.score(d) for d in range(4)])
vac.request(1)
both("pending_auto", lambda: t_vac.evac_pending(1),
     lambda: j_vac.evac_pending(1))
both("info_auto", lambda: health(t_vac, 1), lambda: health(j_vac, 1))
target, req = vac.evac_pending(1)
vac.evac_ack(1, req, True)
vac.request(2, target=0)
both("pending_explicit", lambda: t_vac.evac_pending(2),
     lambda: j_vac.evac_pending(2))
out["explicit"] = list(vac.evac_pending(2))
vac.evac_ack(2, out["explicit"][1], True)
out["auto_target"] = target
out["picked"] = vac.pick_target(1)
inject_reads("end")
print(json.dumps(out))
"""

_seen = {}


def surface(pkg):
    """What the child driven through ``pkg`` read (JAX's and the port's
    reads side by side)."""
    if pkg.name not in _seen:
        env = dict(os.environ, TPUMEM_FAKE_TPU_COUNT="4",
                   TPUMEM_FAKE_HBM_MB="64")
        script = _SURFACE % {"repo": REPO, "module": pkg.module}
        proc = subprocess.run([sys.executable, "-c", script], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-3000:]
        _seen[pkg.name] = json.loads(proc.stdout.strip().splitlines()[-1])
    return _seen[pkg.name]


def same(out, *names):
    for name in names:
        got, want = out[name]
        assert got == want, (name, got, want)
    return [out[n][0] for n in names]


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=lambda p: p.name)
def test_inject_stats_and_recovery_counters_match_jax(pkg):
    """``inject.stats`` (keyed by site name) and
    ``recovery_counters(detail=True)`` read the same through both packages
    after a wire flip, a poison and a reset; the flips are counted on
    mem.corrupt."""
    out = surface(pkg)
    wire, poison, end = same(out, "wire/stats", "poison/stats", "end/stats")
    same(out, "wire/recovery", "poison/recovery", "end/recovery")
    assert wire["mem.corrupt"][1] == 1 and poison["mem.corrupt"][1] == 2
    assert end["mem.corrupt"] == poison["mem.corrupt"]


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=lambda p: p.name)
def test_shield_stats_match_jax(pkg):
    """``shield.stats`` after a seal, a flip and a verify on the wire, then
    after a scoped flip on an exclusive CXL park poisons its page: every
    flip detected, none missed; the poisoned read fails PAGE_POISONED."""
    out = surface(pkg)
    start, wire, poison = same(out, "start/shield", "wire/shield",
                               "poison/shield")
    assert same(out, "start/enabled", "crc32c_at") == [True, out["seal"]]
    assert out["flipped"] and not out["verified"]
    assert wire["wire_verifies"] == start["wire_verifies"] + 1
    assert wire["wire_mismatches"] == start["wire_mismatches"] + 1
    assert poison["inject_corrupts"] == 2
    assert poison["inject_detected"] == 2 and poison["inject_misses"] == 0
    assert poison["pages_poisoned"] == poison["pages_retired"] == 1
    assert out["poison_cqes"] == [[0x74, 0]]
    assert same(out, "span_poisoned") == [1]


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=lambda p: p.name)
def test_scrub_and_retired_pages_match_jax(pkg):
    """``scrub_now``, ``retired_pages`` (in all and per device) and
    ``span_retired`` over every tier and arena read the same; the poisoned
    page is retired in the CXL tier."""
    out = surface(pkg)
    total, per_dev, spans, scrubbed, scrub = same(
        out, "retired_total", "retired_per_dev", "span_retired",
        "scrub_now", "scrub/shield")
    assert total == 1 and sum(per_dev) == 1
    assert not any(spans[:8]) and any(spans[8:])     # HOST, HBM | CXL
    assert scrubbed > 0 and scrub["scrub_pages"] >= 2 * scrubbed
    assert 0 < out["scrubbed_by_pkg"] <= 64


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=lambda p: p.name)
def test_reset_mttr_matches_jax(pkg):
    """After a ``device_reset``, ``stats()`` and its ``last_mttr_ms`` and
    ``mean_mttr_ms`` read the same through both packages."""
    out = surface(pkg)
    st, mttr = same(out, "reset", "mttr_ms")
    assert out["resets"] == 1
    assert mttr[0] == st["last_mttr_ns"] / 1e6 > 0
    assert mttr[1] == st["mttr_sum_ns"] / st["resets"] / 1e6 > 0
    assert out["mttr_pkg"] == mttr


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=lambda p: p.name)
def test_vac_health_and_request_match_jax(pkg):
    """``vac.info`` (events keyed by lower-case Event name) and ``score``
    after synthetic evidence, and the rendezvous that ``request`` posts,
    with the engine's pick (``target=None``) and with an explicit target."""
    out = surface(pkg)
    info, score, auto, info1, explicit = same(
        out, "info", "score", "pending_auto", "info_auto",
        "pending_explicit")
    assert set(info[3]["events"]) == {"rc_reset", "wd_nudge", "link_flap",
                                      "retrain_fail", "page_quarantine",
                                      "stale_completion",
                                      "deadline_expired", "device_reset"}
    assert info[3]["events"]["link_flap"] >= 1
    assert info[3]["events"]["rc_reset"] >= 1
    assert info[3]["score"] == score[3] > 0
    assert auto[0] == out["auto_target"] != 1 and auto[1] > 0
    assert info1["evac_pending"] and info1["evac_target"] == auto[0]
    assert info1["evac_req_id"] == auto[1]
    assert explicit[0] == 0 and out["explicit"] == explicit
    assert out["picked"] not in (None, 1)
