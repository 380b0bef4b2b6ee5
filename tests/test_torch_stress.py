"""The port's serving path under injected faults, and its poison
containment, against the JAX package's, on the CPU.

The two scenarios of ``tests/test_stress.py`` that serve under chaos --
``test_sched_soak_injection`` (every inject site armed, three forced device
resets, two cancels) and ``test_corruption_sched_containment`` (scoped
one-shot ``mem.corrupt`` flips poison one stream's KV page; a fresh scheduler
on the quarantined arena; a vac shipping window under ``mem.corrupt``) --
each run in two child processes side by side, because the native inject,
shield, reset and journal state is process-wide.  A JAX child writes the
fp32 parameters and the prompts to an .npz and prints the JAX package's
uninjected tokens; a port child, which imports no JAX, loads them through
``params_from_jax(..., device="cpu")``, runs the whole choreography through
the port and prints what the JAX test asserts on.  The port's run is held
to every assertion of the JAX test, and its uninjected tokens must be
bit-identical to JAX's.  Which evaluations an armed site hits depends on
thread timing, so the chaos runs are held to the invariants, not to each
other; the JAX package's own chaos runs are ``tests/test_stress.py``'s.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 600

_JAX_PRELUDE = r"""
import json, os, sys
sys.path.insert(0, %(repo)r)
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp

from open_gpu_kernel_modules_tpu.models import llama, multichip
from open_gpu_kernel_modules_tpu.runtime import sched

cfg = llama.LlamaConfig(
    vocab_size=256, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
    max_seq_len=128, dtype=jnp.float32)
params = llama.init_params(cfg, jax.random.key(0))
flat = {}


def put(prefix, node):
    for k, v in node.items():
        if isinstance(v, dict):
            put(prefix + k + "/", v)
        else:
            flat[prefix + k] = np.asarray(v)


def save():
    part = %(npz)r + ".part.npz"
    np.savez(part, **flat)
    os.replace(part, %(npz)r)


def build(cfg, params, prompts, new, cache=None, **kw):
    s = sched.Scheduler(cfg, params, tokens_per_round=4, cache=cache, **kw)
    reqs = [s.submit(p, max_new_tokens=new, tenant=i %% 2)
            for i, p in enumerate(prompts)]
    return s, reqs


def finish(s, reqs):
    rounds = 0
    while not s.idle and rounds < 5000:
        s.step()
        rounds += 1
    toks = {r.rid: r.tokens.tolist() for r in reqs
            if r.state is sched.RequestState.FINISHED}
    s.close()
    return toks
"""

_PORT_PRELUDE = r"""
import ctypes, dataclasses, json, os, sys, time
sys.path.insert(0, %(repo)r)
import numpy as np
import torch

from open_gpu_kernel_modules_tpu_torch import utils
from open_gpu_kernel_modules_tpu_torch.models import llama, multichip
from open_gpu_kernel_modules_tpu_torch.models.convert import params_from_jax
from open_gpu_kernel_modules_tpu_torch.runtime import sched
from open_gpu_kernel_modules_tpu_torch.uvm import (
    inject as inj, journal, reset, shield)
from open_gpu_kernel_modules_tpu_torch.uvm.managed import Tier

cfg = llama.LlamaConfig(
    vocab_size=256, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
    max_seq_len=128, dtype=torch.float32)

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
data = tree.pop("data")
params = params_from_jax(tree.pop("params"), device="cpu")


def done(out):
    out["jax_imported"] = sorted(m for m in sys.modules
                                 if m == "jax" or m.startswith("jax."))
    print(json.dumps(out))
"""

# ------------------------------------------------- test_sched_soak_injection

_SOAK_JAX = r"""
rng = np.random.default_rng(17)
prompts = [rng.integers(0, 256, size=16) for _ in range(8)]
put("params/", params)
flat["data/prompts"] = np.asarray(prompts)
save()
s, reqs = build(cfg, params, prompts, 12, max_seqs=4, max_len=64,
                page_size=16, oversub=4)
for _ in range(3):
    s.step()
for r in reqs:
    if r.rid in {5, 6}:
        s.cancel(r.rid)
print(json.dumps({"ref_toks": finish(s, reqs)}))
"""

# _SCHED_SOAK of tests/test_stress.py through the port, line for line.
_SOAK_PORT = r"""
prompts = list(data["prompts"])
CANCEL = {5, 6}                 # rids cancelled mid-flight (1-based)


def run_once(force_resets=0):
    utils.flow_reset()
    s = sched.Scheduler(cfg, params, max_seqs=4, max_len=64,
                        page_size=16, oversub=4, tokens_per_round=4,
                        device="cpu")
    reqs = [s.submit(p, max_new_tokens=12, tenant=i %% 2)
            for i, p in enumerate(prompts)]
    for _ in range(3):
        s.step()
    for r in reqs:
        if r.rid in CANCEL:
            s.cancel(r.rid)
    forced = 0
    rounds = 0
    while not s.idle and rounds < 5000:
        s.step()
        rounds += 1
        if force_resets and forced < force_resets and not s.idle:
            reset.device_reset()
            forced += 1
    rep = s.report(1.0)
    rep["forced_resets"] = forced
    toks = {r.rid: r.tokens.tolist() for r in reqs
            if r.state is sched.RequestState.FINISHED}
    states = {r.rid: r.state.value for r in reqs}
    flows = utils.flow_report(max_flows=64)
    rep["flow_evidence"] = {
        "closed": sum(1 for f in flows if f["state"] == "closed"),
        "violations": [f for f in flows if f["state"] == "closed" and
                       sum(f["blame_ns"].values()) > f["wall_ns"]],
        "any_reset_blame": any(f["blame_ns"]["reset"] > 0 for f in flows),
        "any_preempt_blame": any(f["blame_ns"]["preempted"] > 0
                                 for f in flows),
        "itl_counts": {t: utils.slo_count(t, "itl") for t in (0, 1)},
        "decoded": {t: sum(r.decoded for r in reqs if r.tenant == t)
                    for t in (0, 1)},
    }
    s.close()
    return toks, states, rep


out = {}
ref_toks, ref_states, ref_rep = run_once()
out["ref_states"] = ref_states
out["ref_toks"] = ref_toks

resets_before = reset.stats().resets
inj.set_seed(42)
for s_ in inj.Site:
    inj.enable(s_, inj.Mode.PPM, 50000)
inj.enable(inj.Site.DUMP_WRITE, inj.Mode.PPM, 125000)
try:
    chaos_toks, chaos_states, rep = run_once(force_resets=3)
    journal.crash_dump("sched.soak")
    _dw_evals, _dw_hits = inj.counts(inj.Site.DUMP_WRITE)
finally:
    inj.disable_all()
rst = reset.stats()
out["resets_during_chaos"] = rst.resets - resets_before
out["reset_mttr_ms"] = rst.last_mttr_ms
out["injected_resets"] = rst.injected_resets
out["stale_completions"] = rst.stale_completions

out["chaos_states"] = chaos_states
err_rids = sorted(r for r, st_ in chaos_states.items() if st_ == "error")
out["error_rids"] = err_rids
err_noncancel = [r for r in err_rids if r not in CANCEL]
out["err_noncancel"] = len(err_noncancel)
out["finished_match"] = \
    sorted(list(chaos_toks) + err_noncancel) == sorted(ref_toks)
out["tokens_identical"] = all(chaos_toks[r] == ref_toks[r]
                              for r in chaos_toks)
out["rep"] = {k: rep[k] for k in
              ("admitted", "retired", "preempted", "restored",
               "cancelled", "admit_retries", "admit_sheds",
               "round_errors", "finished", "forced_resets",
               "device_resets_observed", "flow_evidence")}
out["ref_flow_evidence"] = ref_rep["flow_evidence"]
out["hits"] = {k: v[1] for k, v in inj.stats().items()}
out["sched_admit_evals"] = inj.counts(inj.Site.SCHED_ADMIT)[0]
_vm_evals, _vm_hits = inj.counts(inj.Site.VAC_MIGRATE)
out["vac_migrate"] = {"evals": _vm_evals, "hits": _vm_hits}
_hd_evals, _hd_hits = inj.counts(inj.Site.HOT_DECIDE)
out["hot_decide"] = {"evals": _hd_evals, "hits": _hd_hits,
                     "skips": utils.counter("hot_inject_skips")}
_jem, _jdr, _jcap = journal.stats()
out["dump_write"] = {"evals": _dw_evals, "hits": _dw_hits,
                     "errors": utils.counter("journal_dump_errors"),
                     "dumps": utils.counter("journal_dumps")}
out["journal"] = {"emitted": _jem, "dropped": _jdr, "cap": _jcap}
out["spine"] = {
    "internal_sqes": utils.counter("memring_internal_sqes"),
    "fault": utils.counter("memring_internal_sqes[fault]"),
    "tier": utils.counter("memring_internal_sqes[tier]"),
    "ici": utils.counter("memring_internal_sqes[ici]"),
    "migrate": utils.counter("memring_internal_sqes[migrate]"),
    "inline": utils.counter("memring_internal_inline"),
    "shard": utils.counter("memring_shard_sqes"),
    "per_shard": [utils.counter("memring_shard_sqes[s%%d]" %% s)
                  for s in range(2)],
}
sh = shield.stats()
mc_evals, mc_hits = inj.counts(inj.Site.MEM_CORRUPT)
out["shield"] = {
    "evals": mc_evals,
    "hits": mc_hits,
    "corrupts": sh.inject_corrupts,
    "detected": sh.inject_detected,
    "misses": sh.inject_misses,
    "pages_poisoned": sh.pages_poisoned,
    "pages_retired": sh.pages_retired,
    "poisoned_streams": rep.get("poisoned", 0),
    "poisoned_retired": utils.counter("tpusched_poisoned_retired"),
    "slots_retired": utils.counter("tpusched_seq_slots_retired"),
    "realloc": utils.counter("shield_retired_realloc"),
}
done(out)
"""


def check_sched_soak(out):
    """Every assertion of tests/test_stress.py::test_sched_soak_injection."""
    assert out["finished_match"], out
    assert out["tokens_identical"], out

    rep_r = out["rep"]
    assert rep_r["forced_resets"] >= 3, out
    assert out["resets_during_chaos"] >= 3, out
    assert rep_r["device_resets_observed"] >= 3, out
    assert out["reset_mttr_ms"] > 0, out

    rep = out["rep"]
    po = out["shield"]["poisoned_streams"]
    pn = out["err_noncancel"]
    assert rep["retired"] + rep["cancelled"] + po == 8, (rep, po)
    assert rep["finished"] == rep["retired"] == 6 - pn, (rep, po, pn)
    assert rep["restored"] <= rep["preempted"], rep
    states = set(out["chaos_states"].values())
    assert states <= {"finished", "cancelled", "error"}, \
        out["chaos_states"]
    assert len(out["error_rids"]) == po, out

    shd = out["shield"]
    assert shd["hits"] == shd["corrupts"], shd
    assert shd["corrupts"] == shd["detected"] + shd["misses"], shd
    assert shd["misses"] == 0, shd
    assert shd["realloc"] == 0, shd
    assert shd["poisoned_retired"] == shd["slots_retired"] == po, shd
    if po:
        assert shd["pages_poisoned"] > 0 and shd["pages_retired"] > 0, shd
    assert out["resets_during_chaos"] == \
        rep["forced_resets"] + out["injected_resets"], out

    assert out["sched_admit_evals"] > 0, out
    fired = [k for k, h in out["hits"].items() if h > 0]
    assert len(fired) >= 2, out["hits"]

    sp = out["spine"]
    assert sp["internal_sqes"] > 0, sp
    assert sp["internal_sqes"] == (sp["fault"] + sp["tier"] +
                                   sp["ici"] + sp["migrate"]), sp
    assert sp["fault"] > 0, sp
    assert sum(sp["per_shard"]) == sp["shard"], sp
    assert sp["internal_sqes"] == sp["shard"] + sp["inline"], sp

    vm = out["vac_migrate"]
    assert vm["evals"] == 0 and vm["hits"] == 0, vm

    hd = out["hot_decide"]
    assert hd["hits"] == hd["skips"], hd

    dw = out["dump_write"]
    assert dw["evals"] > 0, dw
    assert dw["hits"] == dw["errors"], dw
    assert dw["dumps"] >= 1, dw
    jn = out["journal"]
    assert jn["cap"] == 16384, jn
    assert jn["dropped"] == 0, jn
    assert jn["emitted"] > 0, jn

    for tag in ("ref_flow_evidence",):
        fe = out[tag]
        assert fe["violations"] == [], fe
        assert fe["itl_counts"] == fe["decoded"], fe
    fe = out["rep"]["flow_evidence"]
    assert fe["closed"] == 8, fe
    assert fe["violations"] == [], fe
    assert fe["itl_counts"] == fe["decoded"], fe
    assert fe["any_reset_blame"], fe


# ----------------------------------------- test_corruption_sched_containment

_CORRUPT_JAX = r"""
rng = np.random.default_rng(23)
prompts = [rng.integers(0, 256, size=16) for _ in range(8)]
cfg2 = llama.LlamaConfig.tiny(vocab_size=128, max_seq_len=64)
cfg2 = type(cfg2)(**{**cfg2.__dict__, "dtype": jnp.float32})
params2 = llama.init_params(cfg2, jax.random.key(1))
prompts2 = [rng.integers(0, 128, size=12) for _ in range(6)]
put("params/", params)
put("params2/", params2)
flat["data/prompts"] = np.asarray(prompts)
flat["data/prompts2"] = np.asarray(prompts2)
save()
out = {}
s, reqs = build(cfg, params, prompts, 12, max_seqs=4, max_len=64,
                page_size=16, oversub=4)
out["ref_toks"] = finish(s, reqs)
cache = multichip.make_multichip_cache(cfg2, batch=6, max_len=64,
                                       page_size=8, oversub=2, n_devices=4)
s, reqs = build(cfg2, params2, prompts2, 16, max_seqs=6, max_len=64,
                page_size=8, oversub=2, cache=cache)
out["ref2_toks"] = finish(s, reqs)
print(json.dumps(out))
"""

# _CORRUPT_SCHED of tests/test_stress.py through the port, line for line.
_CORRUPT_PORT = r"""
prompts = list(data["prompts"])
prompts2 = list(data["prompts2"])
params2 = params_from_jax(tree.pop("params2"), device="cpu")
out = {}


def build():
    s = sched.Scheduler(cfg, params, max_seqs=4, max_len=64,
                        page_size=16, oversub=4, tokens_per_round=4,
                        device="cpu")
    reqs = [s.submit(p, max_new_tokens=12, tenant=i %% 2)
            for i, p in enumerate(prompts)]
    return s, reqs


def finish(s, reqs, hook=None):
    rounds = 0
    while not s.idle and rounds < 5000:
        if hook:
            hook()
        s.step()
        rounds += 1
    toks = {r.rid: r.tokens.tolist() for r in reqs
            if r.state is sched.RequestState.FINISHED}
    states = {r.rid: r.state.value for r in reqs}
    return toks, states, rounds


s, reqs = build()
ref_toks, ref_states, _ = finish(s, reqs)
s.close()
assert len(ref_toks) == 8, ref_states
out["ref_toks"] = ref_toks

resets0 = reset.stats().resets
s, reqs = build()
inj.set_seed(5)
shots = {"n": 0}
PAGE = 4096

for _buf in (s.cache.backing.k_buf, s.cache.backing.v_buf):
    _buf.set_read_duplication(False)
    _buf.migrate(Tier.CXL)


def errored():
    return [r.rid for r in reqs
            if r.state is sched.RequestState.ERROR]


def hook():
    if errored() or shots["n"] >= 3:
        return
    st = shield.stats()
    if st.inject_corrupts != st.inject_detected + st.inject_misses:
        return
    targets = [r for r in s._running.values()
               if r.seq is not None and int(s.cache.seq_lens[r.seq]) > 0]
    if not targets:
        return
    t = targets[0]
    kb = s.cache.backing.k_buf
    rec = s.cache.backing.rec_bytes
    off = (t.seq * s.cache.pages_per_seq * rec) & ~(PAGE - 1)
    s._preempt(t)
    try:
        inj.arm_oneshot(inj.Site.MEM_CORRUPT, scope=kb.address + off)
    except Exception:
        return
    kb.migrate(Tier.CXL)
    shots["n"] += 1


try:
    chaos_toks, chaos_states, rounds = finish(s, reqs, hook=hook)
finally:
    inj.disable_all()
err_rids = errored()
out["rounds"] = rounds
out["shots"] = shots["n"]
out["chaos_states"] = chaos_states
out["error_rids"] = err_rids
out["tokens_identical"] = all(chaos_toks[r] == ref_toks[r]
                              for r in chaos_toks)
out["finished_plus_poisoned"] = \
    sorted(list(chaos_toks) + err_rids) == sorted(ref_toks)
out["resets_delta"] = reset.stats().resets - resets0
out["poisoned_retired"] = utils.counter("tpusched_poisoned_retired")
out["slots_retired"] = utils.counter("tpusched_seq_slots_retired")
rep = s.report(1.0)
out["rep"] = {k: rep.get(k, 0) for k in
              ("retired", "cancelled", "finished", "poisoned")}
s.close()

s, reqs = build()
clean_toks, clean_states, _ = finish(s, reqs)
s.close()
out["clean_toks"] = clean_toks
out["clean_identical"] = (sorted(clean_toks) == sorted(ref_toks) and
                          all(clean_toks[r] == ref_toks[r]
                              for r in ref_toks))
out["realloc"] = utils.counter("shield_retired_realloc")

cfg2 = dataclasses.replace(
    llama.LlamaConfig.tiny(vocab_size=128, max_seq_len=64),
    dtype=torch.float32)


def build_mc():
    cache = multichip.make_multichip_cache(cfg2, batch=6, max_len=64,
                                           page_size=8, oversub=2,
                                           n_devices=4, device="cpu")
    s2 = sched.Scheduler(cfg2, params2, max_seqs=6, max_len=64,
                         page_size=8, oversub=2, tokens_per_round=4,
                         cache=cache)
    reqs2 = [s2.submit(p, max_new_tokens=16, tenant=i %% 2)
             for i, p in enumerate(prompts2)]
    return s2, reqs2


s2, reqs2 = build_mc()
ref2_toks, ref2_states, _ = finish(s2, reqs2)
s2.close()
out["ref2_toks"] = ref2_toks

s2, reqs2 = build_mc()
for _ in range(3):
    s2.step()
v0 = {n: utils.counter(n) for n in
      ("vac_crc_verifies", "vac_crc_mismatches", "vac_crc_reships",
       "vac_aborts")}
inj.enable(inj.Site.MEM_CORRUPT, inj.Mode.NTH, 2)
try:
    rep1 = s2.evacuate_device(1, 2)
finally:
    inj.disable_all()
out["evac_pages"] = rep1.pages if rep1 is not None else 0
out["vac"] = {n: utils.counter(n) - v0[n] for n in v0}
evac_toks, evac_states, _ = finish(s2, reqs2)
s2.close()
out["evac_identical"] = (sorted(evac_toks) == sorted(ref2_toks) and
                         all(evac_toks[r] == ref2_toks[r]
                             for r in ref2_toks))

fin = shield.stats()
mc_evals, mc_hits = inj.counts(inj.Site.MEM_CORRUPT)
out["final"] = {
    "evals": mc_evals, "hits": mc_hits,
    "corrupts": fin.inject_corrupts, "detected": fin.inject_detected,
    "misses": fin.inject_misses, "poisoned": fin.pages_poisoned,
    "retired": fin.pages_retired,
    "wire_mismatches": fin.wire_mismatches,
}
done(out)
"""


def check_containment(out):
    """Every assertion of
    tests/test_stress.py::test_corruption_sched_containment."""
    nerr = len(out["error_rids"])
    assert nerr >= 1, out
    assert nerr < 8, out
    states = set(out["chaos_states"].values())
    assert states <= {"finished", "error"}, out["chaos_states"]

    assert out["tokens_identical"], out
    assert out["finished_plus_poisoned"], out

    assert out["resets_delta"] == 0, out
    assert out["poisoned_retired"] == nerr, out
    assert out["slots_retired"] == nerr, out
    assert out["rep"]["poisoned"] == nerr, out
    assert out["rep"]["retired"] + nerr == 8, out

    assert out["clean_identical"], out
    assert out["realloc"] == 0, out

    assert out["evac_pages"] > 0, out
    vac = out["vac"]
    assert vac["vac_crc_verifies"] > 0, vac
    assert vac["vac_crc_mismatches"] > 0, vac
    assert vac["vac_crc_reships"] == vac["vac_crc_mismatches"], vac
    assert vac["vac_aborts"] == 0, vac
    assert out["evac_identical"], out

    f = out["final"]
    assert f["hits"] == f["corrupts"], f
    assert f["corrupts"] == f["detected"] + f["misses"], f
    assert f["misses"] == 0, f
    assert f["poisoned"] >= nerr, f


# ------------------------------------------------------------------ tests

def _last_json(proc_out: str, who: str):
    lines = proc_out.strip().splitlines()
    assert lines, f"{who} printed nothing"
    return json.loads(lines[-1])


def _run_pair(tmp_path, jax_body, port_body, env):
    """(JAX child's output, port child's output), side by side."""
    subs = {"repo": REPO, "npz": str(tmp_path / "params.npz")}
    env = dict(os.environ, **env)
    procs = [subprocess.Popen(
        [sys.executable, "-c", (prelude + body) % subs], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for prelude, body in ((_JAX_PRELUDE, jax_body),
                              (_PORT_PRELUDE, port_body))]
    outs = []
    try:
        for name, proc in zip(("JAX child", "port child"), procs):
            out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
            assert proc.returncode == 0, f"{name}: {err[-4000:]}"
            outs.append(_last_json(out, name))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert outs[1]["jax_imported"] == [], outs[1]["jax_imported"]
    return outs


_runs = {}


@pytest.fixture
def soak(tmp_path):
    if "soak" not in _runs:
        _runs["soak"] = _run_pair(tmp_path, _SOAK_JAX, _SOAK_PORT, {
            "TPUMEM_FAKE_TPU_COUNT": "2", "TPUMEM_FAKE_HBM_MB": "128",
            "TPUMEM_DUMP_DIR": str(tmp_path),
            "TPUMEM_MEMRING_INTERNAL_SHARDS": "2"})
    return _runs["soak"]


@pytest.fixture
def containment(tmp_path):
    if "containment" not in _runs:
        _runs["containment"] = _run_pair(
            tmp_path, _CORRUPT_JAX, _CORRUPT_PORT,
            {"TPUMEM_FAKE_TPU_COUNT": "4", "TPUMEM_FAKE_HBM_MB": "128"})
    return _runs["containment"]


def test_sched_soak_reference_tokens_match_jax(soak):
    """The soak's uninjected run (two cancels, no fault) gives the JAX
    package's tokens, bit for bit, for the six streams that finish."""
    jx, pt = soak
    assert pt["ref_toks"] == jx["ref_toks"]
    assert len(pt["ref_toks"]) == 6
    assert sorted(pt["ref_states"].values()) == \
        ["cancelled"] * 2 + ["finished"] * 6


def test_sched_soak_injection_on_the_port(soak):
    """The port's chaos soak (all 15 sites, three forced resets, two
    cancels) meets every assertion of the JAX package's: zero token
    corruption, balanced accounting, exact shield, dump.write, hot.decide,
    spine and flow reconciliations."""
    check_sched_soak(soak[1])


def test_containment_reference_tokens_match_jax(containment):
    """The containment scenario's uninjected runs -- the single-chip
    scheduler's, the fresh scheduler's on the quarantined arena, and the
    four-arena pool's -- give the JAX package's tokens, bit for bit."""
    jx, pt = containment
    assert pt["ref_toks"] == jx["ref_toks"]
    assert pt["clean_toks"] == jx["ref_toks"]
    assert pt["ref2_toks"] == jx["ref2_toks"]
    assert len(jx["ref_toks"]) == 8 and len(jx["ref2_toks"]) == 6


def test_corruption_sched_containment_on_the_port(containment):
    """A poisoned KV page costs only its owning stream on the port: ERROR,
    its slot retired, no device reset, co-tenants bit-identical; a fresh
    scheduler decodes clean on the quarantined arena; a vac window
    re-ships the records flipped on the wire.  Every assertion of the JAX
    package's test."""
    check_containment(containment[1])


# ------------------------------------------------ chip_smoke.py's phase 13

_REHEARSAL = r"""
import dataclasses, json, os, sys
import numpy as np
import torch
import chip_smoke as cs
from open_gpu_kernel_modules_tpu_torch.models import llama, multichip, serving
from open_gpu_kernel_modules_tpu_torch.runtime import ici, sched

serving.resolve = sched.resolve = lambda device=None: torch.device("cpu")
torch.cuda.synchronize = lambda *a, **k: None
# The CPU runs B1's plain version, which counts no launches.
_check = cs.check
cs.check = lambda ok, what: _check(ok or "launched" in what, what)
cs.SCHED = dict(streams=8, first=5, prompt=112, new=32, max_seqs=8,
                max_len=256, page=16, tokens_per_round=8)
cfg = dataclasses.replace(llama.LlamaConfig.tiny(max_seq_len=256),
                          dtype=torch.bfloat16)
params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
rng = np.random.default_rng(0)
prompts, mc_prompts = rng.integers(0, cfg.vocab_size,
                                   (2, 8, cs.SCHED["prompt"]))
out = {}

# Phase 9's M1 epilogue on a tiny pool: the failed 0 <-> 1 link reset and
# trained back, and a record to chip 1 over it.
pool = (cfg.num_layers, 8, 16, cfg.num_kv_heads, cfg.head_dim)
backing = multichip.IciPoolBacking(pool, np.dtype(np.uint16),
                                   16 * cfg.num_kv_heads * cfg.head_dim * 2,
                                   4)
recs = rng.integers(0, 1 << 16, (8, 2) + pool[:1] + pool[2:]).astype(
    np.uint16)
for p in range(8):
    backing.write_page(p, recs[p, 0], recs[p, 1])
direct = next(l for l in range(ici.link_count(0))
              if ici.link_info(0, l).peer == 1)
ici.inject_link_failure(0, direct)
out["detour_hops"] = ici.route_hops(0, 1)
out["retrain"] = cs.retrain_link(backing, direct)
k, v = backing.read_pages(list(range(8)))
out["records_kept"] = bool(np.array_equal(k.swapaxes(0, 1), recs[:, 0]) and
                           np.array_equal(v.swapaxes(0, 1), recs[:, 1]))
backing.close()

ref_tokens, _, ref_batches, _, _, _ = cs.multichip_sched_run(cfg, params,
                                                             mc_prompts)
out["launches"] = cs.phase_chaos(cfg, params, prompts,
                                 (mc_prompts, ref_tokens, ref_batches), "cpu")
print(json.dumps(out))
"""


def test_chip_smoke_chaos_phase_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 13 (the soak's reference and chaos runs,
    containment, the fresh scheduler, the evacuation under mem.corrupt)
    rehearsed at tiny width in bf16 on the CPU, with every check of the
    phase but B1's launch count; and phase 9's link retrain on a tiny
    four-arena pool.  In a child: the device table is read once per
    process."""
    env = dict(os.environ, TPUMEM_FAKE_TPU_COUNT="4",
               TPUMEM_FAKE_HBM_MB="256", TPUMEM_DUMP_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _REHEARSAL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = _last_json(proc.stdout, "rehearsal")
    assert out["detour_hops"] == 3
    assert out["retrain"]["links_trained"] >= 1
    assert out["retrain"]["direct_bytes"] > 0
    assert out["records_kept"]
    for line in ("chaos (a1) all at 1%:", "chaos (a2) soak:",
                 "chaos (b) containment: shots",
                 "chaos (b) evacuation:", "scrub pass"):
        assert line in proc.stdout, line


# ------------------------------------------- a poisoned slot at admission

# Both packages: a fresh Scheduler on the tiny config whose sequence slots
# each span one 2 MiB VA block of the backing (512 pages of 4 KiB records),
# so a poisoned page quarantines its own slot only.  ``poison(s, slots)``
# flips one sealed page at the start of each slot's K span before anything
# is admitted (exclusive parks: no sibling copy, so the read-back poisons).
_POISONED_SLOTS = r"""
def poison(s, slots):
    kb = s.cache.backing.k_buf
    span = s.cache.pages_per_seq * s.cache.backing.rec_bytes
    for buf in (s.cache.backing.k_buf, s.cache.backing.v_buf):
        buf.set_read_duplication(False)
        buf.migrate(Tier.CXL)
    for q in slots:
        kb.view()[q * span] = 0          # unseal: the park re-seals it
        inj.arm_oneshot(inj.Site.MEM_CORRUPT, scope=kb.address + q * span)
    kb.migrate(Tier.CXL)
    return span


def run(slots, rounds):
    s = sched.Scheduler(scfg, sparams, max_seqs=4, max_len=8192,
                        page_size=16, oversub=4, tokens_per_round=4, **KW)
    span = poison(s, slots)
    reqs = [s.submit(p, max_new_tokens=8) for p in sprompts]
    n = 0
    while not s.idle and n < rounds:
        s.step()
        n += 1
    out = {"span": span, "rounds": n, "idle": s.idle,
           "states": {r.rid: r.state.value for r in reqs},
           "tokens": {r.rid: r.tokens.tolist() for r in reqs
                      if r.state.value == "finished"},
           "stats": {k: s.stats.get(k, 0) for k in
                     ("round_errors", "admitted", "retired",
                      "free_slots_retired", "unservable", "poisoned")},
           "poisoned": [shield.span_poisoned(
               s.cache.backing.k_buf.address + q * span, span) > 0
               for q in range(4)]}
    s.close()
    return out


out = {"one": run([0], 200), "all": run([0, 1, 2, 3], 50)}
"""

_SLOTS_JAX = r"""
from open_gpu_kernel_modules_tpu.uvm import inject as inj, shield
from open_gpu_kernel_modules_tpu.uvm.managed import Tier
scfg = llama.LlamaConfig.tiny(max_seq_len=8192)
scfg = type(scfg)(**{**scfg.__dict__, "dtype": jnp.float32})
sparams = llama.init_params(scfg, jax.random.key(2))
sprompts = list(np.random.default_rng(31).integers(0, 256, (6, 16)))
put("params/", sparams)
flat["data/prompts"] = np.asarray(sprompts)
save()
KW = {}
""" + _POISONED_SLOTS + r"""
print(json.dumps(out))
"""

_SLOTS_PORT = r"""
scfg = dataclasses.replace(llama.LlamaConfig.tiny(max_seq_len=8192),
                           dtype=torch.float32)
sparams = params
sprompts = list(data["prompts"])
KW = {"device": "cpu"}
""" + _POISONED_SLOTS + r"""
done(out)
"""


@pytest.fixture
def poisoned_slots(tmp_path):
    if "slots" not in _runs:
        _runs["slots"] = _run_pair(tmp_path, _SLOTS_JAX, _SLOTS_PORT,
                                   {"TPUMEM_FAKE_HBM_MB": "128"})
    return _runs["slots"]


def test_poisoned_free_slot_is_retired_not_reserved(poisoned_slots):
    """A slot whose backing span was poisoned before admission: the port's
    Scheduler retires it at the first admission that fails on it, and every
    stream finishes on the other three with the JAX package's tokens.  The
    JAX Scheduler requeues the stream and returns the poisoned slot to the
    free list, so it fails admissions again (ROADMAP.md section C)."""
    jx, pt = poisoned_slots
    j, p = jx["one"], pt["one"]
    assert p["span"] == 2 << 20 and p["poisoned"] == [True, False, False,
                                                       False]
    assert set(p["states"].values()) == {"finished"}, p["states"]
    assert p["tokens"] == j["tokens"] and len(p["tokens"]) == 6
    assert p["stats"]["free_slots_retired"] == 1
    assert p["stats"]["round_errors"] == 1
    assert p["stats"]["poisoned"] == 0
    assert j["stats"]["round_errors"] >= 2, j["stats"]


def test_all_slots_poisoned_ends_the_queue(poisoned_slots):
    """Every slot poisoned: the port's Scheduler retires each at its failed
    admission and then ends the queued streams terminal-with-error, idle in
    five rounds; the JAX Scheduler is still retrying them after fifty."""
    jx, pt = poisoned_slots
    j, p = jx["all"], pt["all"]
    assert p["poisoned"] == [True] * 4
    assert p["idle"] and p["rounds"] <= 5, p
    assert set(p["states"].values()) == {"error"}, p["states"]
    assert p["stats"]["free_slots_retired"] == 4
    assert p["stats"]["unservable"] == 6 and p["stats"]["admitted"] == 0
    assert not j["idle"] and j["rounds"] == 50
    assert set(j["states"].values()) == {"queued"}, j["states"]
