"""The port's multichip KV pool (config #5), chip evacuation and
prefill/decode disaggregation against the JAX package's, on the CPU.

Each scenario of tests/test_multichip.py runs in two child processes side by
side, both with four native device arenas (TPUMEM_FAKE_TPU_COUNT=4, 64 MB
each; the native device table is process-wide and the other tests expect one
device): a JAX child writes the tiny fp32 parameters and the prompts to an
.npz and prints the JAX package's tokens; a port child, which imports no JAX,
loads them through ``params_from_jax(..., device="cpu")`` once they appear,
runs the same scenario through the port and prints its tokens and counters.
Greedy tokens must be bit-identical.  The unit tests below them run in this
process (one native arena is enough) or in a four-arena child of their own.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from open_gpu_kernel_modules_tpu_torch.models import llama, multichip
from open_gpu_kernel_modules_tpu_torch.models import serving
from open_gpu_kernel_modules_tpu_torch.runtime import sched, tpusplit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 600

# ----------------------------------------------------------------- children

_JAX_PRELUDE = r"""
import json, os, sys
sys.path.insert(0, %(repo)r)
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp

from open_gpu_kernel_modules_tpu.models import llama, multichip, serving
from open_gpu_kernel_modules_tpu.runtime import ici, sched, tpusplit

cfg = llama.LlamaConfig.tiny(vocab_size=128, max_seq_len=64)
cfg = type(cfg)(**{**cfg.__dict__, "dtype": jnp.float32})
params = llama.init_params(cfg, jax.random.key(0))


def save(prompts):
    flat = {"prompts": np.asarray(prompts)}

    def put(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                put(prefix + k + "/", v)
            else:
                flat[prefix + k] = np.asarray(v)
    put("", params)
    part = %(npz)r + ".part.npz"
    np.savez(part, **flat)
    os.replace(part, %(npz)r)


def finish(s, reqs):
    rounds = 0
    while not s.idle and rounds < 5000:
        s.step()
        rounds += 1
    return {r.rid: r.tokens.tolist() for r in reqs
            if r.state is sched.RequestState.FINISHED}
"""

_PORT_PRELUDE = r"""
import ctypes, dataclasses, json, os, sys, time
sys.path.insert(0, %(repo)r)
import numpy as np
import torch

from open_gpu_kernel_modules_tpu_torch import utils
from open_gpu_kernel_modules_tpu_torch.models import llama, multichip, serving
from open_gpu_kernel_modules_tpu_torch.models.convert import params_from_jax
from open_gpu_kernel_modules_tpu_torch.runtime import ici, sched, tpusplit
from open_gpu_kernel_modules_tpu_torch.uvm import inject as inj, reset, vac

cfg = dataclasses.replace(
    llama.LlamaConfig.tiny(vocab_size=128, max_seq_len=64),
    dtype=torch.float32)

deadline = time.time() + 300
while not os.path.exists(%(npz)r):
    if time.time() > deadline:
        raise SystemExit("the JAX child wrote no parameters")
    time.sleep(0.05)
tree = {}
with np.load(%(npz)r) as z:
    for key in z.files:
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = z[key]
prompts = tree.pop("prompts")
params = params_from_jax(tree, device="cpu")


def finish(s, reqs):
    rounds = 0
    while not s.idle and rounds < 5000:
        s.step()
        rounds += 1
    toks = {r.rid: r.tokens.tolist() for r in reqs
            if r.state is sched.RequestState.FINISHED}
    return toks, {r.rid: r.state.value for r in reqs}


def charges(backing):
    lib = backing._lib
    lib.uvmTenantDevPages.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.uvmTenantDevPages.restype = ctypes.c_uint64
    return {d: {"charged": sum(lib.uvmTenantDevPages(t, d)
                               for t in (0, 1, 2)),
                "homed": len(backing.pages_homed(d))} for d in range(4)}


def done(out):
    out["jax_imported"] = sorted(m for m in sys.modules
                                 if m == "jax" or m.startswith("jax."))
    print(json.dumps(out))
"""

# Config #5 decode: 4 sequences of 15-token prompts in groups of 2, pages of
# 8, a 4x-oversubscribed pool, 2 tokens x 1 turn, the direct 0<->1 link
# failed, 2 tokens x 1 turn again, then the victim ring drained over ICI.
_LINK_JAX = r"""
prompts = jax.random.randint(jax.random.key(7), (4, 15), 0, cfg.vocab_size)
save(prompts)
groups = [[0, 1], [2, 3]]
cache = multichip.make_multichip_cache(cfg, batch=4, max_len=64, page_size=8,
                                       oversub=4, n_devices=4)
for g in groups:
    serving.prefill_group(cfg, params, cache, g, prompts[np.array(g)])
serving.decode_rounds(cfg, params, cache, groups, 2, 1)
direct = next(l for l in range(ici.link_count(0))
              if ici.link_info(0, l).peer == 1)
ici.inject_link_failure(0, direct)
serving.decode_rounds(cfg, params, cache, groups, 2, 1)
cache.drain_flushes()
print(json.dumps({"tokens": [int(t) for t in cache.last_token]}))
cache.close()
"""

_LINK_PORT = r"""
groups = [[0, 1], [2, 3]]


def run(cache, fail_link):
    out = {}
    try:
        for g in groups:
            serving.prefill_group(cfg, params, cache, g,
                                  torch.as_tensor(prompts[g]))
        serving.decode_rounds(cfg, params, cache, groups, 2, 1)
        if fail_link:
            direct = next(l for l in range(ici.link_count(0))
                          if ici.link_info(0, l).peer == 1)
            before = cache.backing.link_traffic()
            ici.inject_link_failure(0, direct)
            out["detour_hops"] = ici.route_hops(0, 1)
        serving.decode_rounds(cfg, params, cache, groups, 2, 1)
        cache.drain_flushes()
        if fail_link:
            after = cache.backing.link_traffic()
            out["tx_0_3_delta"] = after["0->(3)"] - before["0->(3)"]
            out["stats"] = dict(cache.backing.stats)
        out["tokens"] = [int(t) for t in cache.last_token]
        return out
    finally:
        cache.close()


dense = run(serving.TieredKVCache(cfg, 4, 64, page_size=8, oversub=1,
                                  device="cpu"), False)
out = run(multichip.make_multichip_cache(cfg, batch=4, max_len=64,
                                         page_size=8, oversub=4, n_devices=4,
                                         device="cpu"), True)
out["dense_tokens"] = dense["tokens"]
done(out)
"""

_EVAC_JAX = r"""
rng = np.random.default_rng(11)
prompts = [rng.integers(0, 128, size=12) for _ in range(6)]
save(prompts)
cache = multichip.make_multichip_cache(cfg, batch=6, max_len=64, page_size=8,
                                       oversub=2, n_devices=4)
s = sched.Scheduler(cfg, params, max_seqs=6, max_len=64, page_size=8,
                    oversub=2, tokens_per_round=4, cache=cache)
s.configure_tenant(1, priority=100)
s.configure_tenant(2, priority=120)
reqs = [s.submit(p, max_new_tokens=24, tenant=t)
        for p, t in zip(prompts, [1, 1, 1, 2, 2, 2])]
print(json.dumps({"tokens": finish(s, reqs)}))
s.close()
"""

# The evacuation choreography of tests/test_multichip.py: every inject site
# at 0.5% chaos, a planned move 1 -> 2, a forced abort of 2 -> 3 (vac.migrate
# firing through the retry budget), a planned move 0 -> 1, then a
# watchdog-triggered evacuation of chip 3 on synthetic health evidence.
_EVAC_PORT = r"""
inj.set_seed(1234)
for site in inj.Site:
    inj.enable(site, inj.Mode.PPM, 5000)
cache = multichip.make_multichip_cache(cfg, batch=6, max_len=64, page_size=8,
                                       oversub=2, n_devices=4, device="cpu")
s = sched.Scheduler(cfg, params, tokens_per_round=4, cache=cache)
s.configure_tenant(1, priority=100)
s.configure_tenant(2, priority=120)
reqs = [s.submit(p, max_new_tokens=24, tenant=t)
        for p, t in zip(prompts, [1, 1, 1, 2, 2, 2])]
backing = s.cache.backing
out = {}
for _ in range(3):
    s.step()
rep1 = s.evacuate_device(1, 2)
out["planned"] = [rep1 is not None and rep1.pages > 0,
                  backing.pages_homed(1) == []]
s.step(); s.step()
homed2 = list(backing.pages_homed(2))
inj.enable(inj.Site.VAC_MIGRATE, inj.Mode.PPM, 1000000, burst=64)
rep2 = s.evacuate_device(2, 3)
inj.enable(inj.Site.VAC_MIGRATE, inj.Mode.PPM, 5000)
out["aborted"] = [rep2 is None, backing.pages_homed(2) == homed2]
s.step(); s.step()
rep3 = s.evacuate_device(0, 1)
out["planned"] += [rep3 is not None and rep3.pages > 0,
                   backing.pages_homed(0) == []]
s.step(); s.step()
reset.watchdog_start()
for dev in range(3):
    vac.clear(dev)
for _ in range(4):
    vac.note(3, vac.Event.PAGE_QUARANTINE)
out["evacuating"] = vac.state(3) == vac.HealthState.EVACUATING
evacs0 = s.stats["evacuations"]
deadline = time.time() + 30.0
while s.stats["evacuations"] == evacs0 and time.time() < deadline:
    s.step()
    time.sleep(0.02)
out["watchdog_moved"] = s.stats["evacuations"] > evacs0
out["homed_3_after"] = backing.pages_homed(3)
out["watchdog_evacuations"] = reset.stats().watchdog_evacuations
toks, states = finish(s, reqs)
inj.disable_all()
out["tokens"] = toks
out["states"] = states
out["stats"] = {k: s.stats[k] for k in ("evacuations", "evac_aborts",
                                        "evac_pages_moved")}
out["blackouts_ms"] = [1e3 * b for b in s.evac_blackouts_s]
ev, hits = inj.counts(inj.Site.VAC_MIGRATE)
out["vac_site"] = {"hits": hits,
                   "retries": utils.counter("vac_inject_retries"),
                   "aborts": utils.counter("vac_inject_aborts")}
out["vac_counters"] = {n: utils.counter(n) for n in
                       ("vac_commits", "vac_aborts", "vac_pages_moved",
                        "vac_txn_begins")}
out["txns_open"] = vac.txns_active()
out["charges"] = charges(backing)
s.close()
done(out)
"""

_DISAGG_JAX = r"""
rng = np.random.default_rng(23)
prompts = [rng.integers(0, 128, size=15) for _ in range(6)]
save(prompts)
cache = multichip.make_multichip_cache(cfg, batch=6, max_len=64, page_size=8,
                                       oversub=2, n_devices=4)
s = sched.Scheduler(cfg, params, max_seqs=6, max_len=64, page_size=8,
                    oversub=2, tokens_per_round=4, cache=cache)
reqs = [s.submit(p, max_new_tokens=24) for p in prompts]
print(json.dumps({"tokens": finish(s, reqs)}))
s.close()
"""

# Disaggregated (prefill on chip 0, decode homes 1-3) with every inject site
# at 0.5% chaos, a forced full-device reset after round 2 and an evacuation
# of decode home 1 -> 2 after round 4.
_DISAGG_PORT = r"""
inj.set_seed(4321)
for site in inj.Site:
    inj.enable(site, inj.Mode.PPM, 5000)
cache = multichip.make_multichip_cache(cfg, batch=6, max_len=64, page_size=8,
                                       oversub=2, n_devices=4, device="cpu")
s = sched.Scheduler(cfg, params, tokens_per_round=4, cache=cache,
                    disagg=tpusplit.DisaggConfig(decode_devs=(1, 2, 3)))
reqs = [s.submit(p, max_new_tokens=24) for p in prompts]
out = {}
for _ in range(2):
    s.step()
gen0 = reset.generation()
reset.device_reset()
out["reset_ran"] = reset.generation() > gen0
s.step(); s.step()
homes_before = dict(s._disagg_home)
rep = s.evacuate_device(1, 2)
out["evac_pages"] = 0 if rep is None else rep.pages
out["homed_1_after"] = s.cache.backing.pages_homed(1)
out["homes_rewritten"] = [s._disagg_home[sq] for sq, h in
                          homes_before.items() if h == 1]
toks, states = finish(s, reqs)
inj.disable_all()
out["tokens"] = toks
out["states"] = states
out["stats"] = {k: s.stats[k] for k in
                ("disagg_ships", "disagg_ship_aborts", "disagg_reclaims",
                 "disagg_pages_shipped", "evacuations",
                 "device_resets_observed")}
out["ship_legs"] = len(s.disagg_ship_s)
out["txns_open"] = vac.txns_active()
out["ctr"] = {n: utils.counter(n) for n in
              ("tpusplit_ships", "tpusplit_reclaims",
               "tpusplit_pages_shipped")}
s.close()
done(out)
"""


def _last_json(proc_out: str, who: str):
    lines = proc_out.strip().splitlines()
    assert lines, f"{who} printed nothing"
    return json.loads(lines[-1])


def _run_pair(tmp_path, jax_body: str, port_body: str):
    """(JAX child's output, port child's output), the two run side by
    side with four 64 MB native device arenas each."""
    subs = {"repo": REPO, "npz": str(tmp_path / "params.npz")}
    env = dict(os.environ, TPUMEM_FAKE_TPU_COUNT="4",
               TPUMEM_FAKE_HBM_MB="64")
    procs = [subprocess.Popen(
        [sys.executable, "-c", (prelude + body) % subs], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for prelude, body in ((_JAX_PRELUDE, jax_body),
                              (_PORT_PRELUDE, port_body))]
    outs = []
    try:
        for name, proc in zip(("JAX child", "port child"), procs):
            out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
            assert proc.returncode == 0, f"{name}: {err[-3000:]}"
            outs.append(_last_json(out, name))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert outs[1]["jax_imported"] == [], outs[1]["jax_imported"]
    return outs


def test_multichip_decode_with_link_failure_matches_jax(tmp_path):
    """Config #5 through a mid-decode link failure: the port's tokens equal
    the JAX package's and the port's own dense tiered run; records moved
    over ICI both ways; the direct link's loss detours 0 -> 1 over three
    hops, and the detour direction (0 -> 3) carried new traffic."""
    jx, pt = _run_pair(tmp_path, _LINK_JAX, _LINK_PORT)
    assert pt["tokens"] == jx["tokens"], (pt["tokens"], jx["tokens"])
    assert pt["tokens"] == pt["dense_tokens"]
    assert pt["stats"]["ici_fetch_records"] > 0
    assert pt["stats"]["ici_flush_records"] > 0
    assert pt["detour_hops"] == 3
    assert pt["tx_0_3_delta"] > 0


def test_multichip_evacuation_matches_jax(tmp_path):
    """Evacuations under chaos: tokens bit-identical to the JAX package's
    solo run; at least three committed moves, the watchdog's among them,
    and the forced abort that moved nothing; the vac.migrate site
    reconciles exactly, every manifest resolved, and each arena's
    per-tenant charges equal the records homed there."""
    jx, pt = _run_pair(tmp_path, _EVAC_JAX, _EVAC_PORT)
    assert pt["tokens"] == jx["tokens"]
    assert set(pt["states"].values()) == {"finished"}, pt["states"]
    assert all(pt["planned"]), pt["planned"]
    assert all(pt["aborted"]), pt["aborted"]
    assert pt["evacuating"] and pt["watchdog_moved"], pt
    assert pt["homed_3_after"] == []
    assert pt["watchdog_evacuations"] >= 1

    st = pt["stats"]
    assert st["evacuations"] >= 3, st
    assert st["evac_aborts"] >= 1, st
    assert len(pt["blackouts_ms"]) == st["evacuations"]
    assert all(b > 0 for b in pt["blackouts_ms"])

    vs = pt["vac_site"]
    assert vs["hits"] == vs["retries"] + vs["aborts"], vs
    vc = pt["vac_counters"]
    assert vc["vac_txn_begins"] == vc["vac_commits"] + vc["vac_aborts"], vc
    assert vc["vac_pages_moved"] > 0
    assert pt["txns_open"] == 0
    for d, row in pt["charges"].items():
        assert row["charged"] == row["homed"], (d, row)


def test_disagg_matches_jax(tmp_path):
    """Disaggregation through a full-device reset and an evacuation of a
    decode home: tokens bit-identical to the JAX package's co-located run;
    every stream shipped or recorded its abort, records shipped and came
    back, the evacuation rewrote the moved streams' homes 1 -> 2, and the
    tpusplit counters equal the scheduler's stats."""
    jx, pt = _run_pair(tmp_path, _DISAGG_JAX, _DISAGG_PORT)
    assert pt["tokens"] == jx["tokens"]
    assert set(pt["states"].values()) == {"finished"}, pt["states"]
    assert pt["reset_ran"]

    st = pt["stats"]
    assert st["disagg_ships"] + st["disagg_ship_aborts"] >= len(
        pt["states"]), st
    assert st["disagg_pages_shipped"] > 0, st
    assert st["disagg_reclaims"] > 0, st
    assert pt["ship_legs"] >= st["disagg_ships"]
    assert st["device_resets_observed"] >= 1, st
    assert st["evacuations"] >= 1, st
    assert pt["evac_pages"] > 0 and pt["homed_1_after"] == []
    assert pt["homes_rewritten"] and all(
        h == 2 for h in pt["homes_rewritten"]), pt["homes_rewritten"]

    assert pt["ctr"]["tpusplit_ships"] == st["disagg_ships"]
    assert pt["ctr"]["tpusplit_pages_shipped"] == st["disagg_pages_shipped"]
    assert pt["ctr"]["tpusplit_reclaims"] == st["disagg_reclaims"]
    assert pt["txns_open"] == 0


# --------------------------------------------------------------- unit tests

# bf16 and fp32 records through write_page and read_pages, on every home of
# a four-arena pool: device 0's own records and three peers' over ICI.
_ROUNDTRIP = r"""
import json, sys
sys.path.insert(0, %(repo)r)
import numpy as np
from open_gpu_kernel_modules_tpu_torch.models import multichip

out = {}
for np_dtype in (np.dtype(np.uint16), np.dtype(np.float32)):
    pool_shape = (3, 12, 4, 2, 8)             # [L, N, P, KV, D]
    page_bytes = 4 * 2 * 8 * np_dtype.itemsize
    b = multichip.IciPoolBacking(pool_shape, np_dtype, page_bytes, 4)
    try:
        rng = np.random.default_rng(5)
        shape = (2, 12, 3) + pool_shape[2:]          # K and V records
        if np_dtype == np.float32:
            k, v = rng.standard_normal(shape).astype(np.float32)
        else:
            k, v = rng.integers(0, 1 << 16, shape).astype(np.uint16)
        for p in range(12):
            b.write_page(p, k[p], v[p])
        pages = [11, 0, 5, 2, 7, 1, 4, 9, 3, 10, 8, 6]
        rk, rv = b.read_pages(pages)
        out[np_dtype.name] = {
            "exact": bool(np.array_equal(rk.view(np.uint8),
                                         k[pages].swapaxes(0, 1).view(
                                             np.uint8)) and
                          np.array_equal(rv.view(np.uint8),
                                         v[pages].swapaxes(0, 1).view(
                                             np.uint8))),
            "shape": list(rk.shape), "dtype": rk.dtype.name,
            "homes": sorted({int(b.home[p]) for p in pages}),
            "stats": dict(b.stats)}
    finally:
        b.close()
print(json.dumps(out))
"""


def test_ici_pool_records_round_trip_bit_exact():
    """bf16 (uint16 bits) and fp32 records come back bit-exact from every
    home, in [L, n, P, KV, D] chunks of the backing's dtype; the three peer
    homes' records crossed ICI one copy each way."""
    env = dict(os.environ, TPUMEM_FAKE_TPU_COUNT="4",
               TPUMEM_FAKE_HBM_MB="64")
    proc = subprocess.run([sys.executable, "-c",
                           _ROUNDTRIP % {"repo": REPO}], env=env,
                          capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = _last_json(proc.stdout, "round-trip child")
    for name, row in out.items():
        assert row["exact"], (name, row)
        assert row["shape"] == [3, 12, 4, 2, 8] and row["dtype"] == name
        assert row["homes"] == [0, 1, 2, 3]
        assert row["stats"]["ici_flush_records"] == 9
        assert row["stats"]["ici_fetch_records"] == 9


def _tiny_cfg():
    """tiny at fp32; 4 sequences of 64 tokens in pages of 8 make the
    smallest managed pool the native engine takes (64 KB a buffer)."""
    return dataclasses.replace(
        llama.LlamaConfig.tiny(vocab_size=128, max_seq_len=64),
        dtype=torch.float32)


def test_ici_pool_one_arena_round_trip():
    """One arena (this process's): every page is homed on device 0, nothing
    crosses ICI, and read_pages hands back copies of the records."""
    pool_shape = (2, 6, 4, 2, 8)
    b = multichip.IciPoolBacking(pool_shape, np.dtype(np.uint16),
                                 4 * 2 * 8 * 2, 1)
    try:
        rng = np.random.default_rng(3)
        recs = rng.integers(0, 1 << 16, (6, 2, 2, 4, 2, 8)).astype(np.uint16)
        for p in range(6):
            b.write_page(p, recs[p, 0], recs[p, 1])
        k, v = b.read_pages([4, 1, 3])
        k[:] = 0                           # a copy: the records stay
        k, v = b.read_pages([4, 1, 3])
        assert np.array_equal(k, recs[[4, 1, 3], 0].swapaxes(0, 1))
        assert np.array_equal(v, recs[[4, 1, 3], 1].swapaxes(0, 1))
        assert b.pages_homed(0) == list(range(6))
        assert b.stats["ici_fetch_records"] == 0
        assert b.stats["ici_flush_records"] == 0
    finally:
        b.close()


def test_disagg_without_multichip_cache_raises():
    cfg = _tiny_cfg()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    with pytest.raises(ValueError, match="disagg needs a multichip backing"):
        sched.Scheduler(cfg, params, max_seqs=4, max_len=64, page_size=8,
                        disagg=tpusplit.DisaggConfig(decode_devs=(1,)),
                        device="cpu")


def test_cache_on_another_device_raises():
    cfg = _tiny_cfg()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    cache = serving.TieredKVCache(cfg, 4, 64, page_size=8, device="cpu")
    try:
        with pytest.raises(ValueError, match="not the cache's device"):
            sched.Scheduler(cfg, params, cache=cache, device="cuda")
        s = sched.Scheduler(cfg, params, cache=cache, device="cpu")
        assert s.cache is cache and s.max_seqs == 4
    finally:
        cache.close()


def test_evacuate_managed_backing_raises():
    cfg = _tiny_cfg()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    with sched.Scheduler(cfg, params, max_seqs=4, max_len=64, page_size=8,
                         device="cpu") as s:
        with pytest.raises(ValueError, match="evacuation needs a multichip"):
            s.evacuate_device(0, 1)
