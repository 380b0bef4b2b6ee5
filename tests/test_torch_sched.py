"""The port's continuous-batching Scheduler against the JAX package's, on
the CPU at fp32.

The model is the tiny config of the JAX scheduler tests (tests/
test_sched.py: vocab 256, hidden 64, 2 layers, 4 heads, 4 kv heads, head
dim 16), with the JAX ``init_params`` weights reaching the port through
``params_from_jax``.  Prompts come from numpy seeds.  Each scenario runs
through the JAX ``Scheduler`` and the port's ``Scheduler(device="cpu")``
in one process: the greedy token streams must be bit-identical, to JAX's
and to the port's own solo run of each stream, through mid-decode
admission, preemption and restore, and forced device resets.

Both packages load the same native library, whose flow, SLO, inject and
reset state is process-wide: every test starts and ends with every inject
site disarmed and the flow table cleared.
"""

import numpy as np
import pytest
import torch

from open_gpu_kernel_modules_tpu.runtime import sched as jsched
from open_gpu_kernel_modules_tpu_torch import utils
from open_gpu_kernel_modules_tpu_torch.runtime import sched as tsched
from open_gpu_kernel_modules_tpu_torch.uvm import inject, reset

from torch_port_util import tiny_pair


@pytest.fixture(scope="module")
def setup():
    return tiny_pair(vocab_size=256, max_seq_len=256, num_kv_heads=4,
                     rope_theta=500000.0)


@pytest.fixture(autouse=True)
def clean_native_state():
    inject.disable_all()
    utils.flow_reset()
    yield
    inject.disable_all()
    utils.flow_reset()


def _sched(side, setup, **kw):
    jcfg, jparams, tcfg, tparams = setup
    args = dict(max_seqs=4, max_len=128, page_size=16, oversub=1,
                tokens_per_round=4)
    args.update(kw)
    if side == "jax":
        return jsched.Scheduler(jcfg, jparams, **args)
    return tsched.Scheduler(tcfg, tparams, device="cpu", **args)


def _finished(reqs):
    return all(r.state.value == "finished" for r in reqs)


def _solo(setup, prompt, n, **kw):
    """The port's reference stream: the request alone in its own
    scheduler."""
    s = _sched("torch", setup, **kw)
    try:
        r = s.submit(prompt, max_new_tokens=n)
        s.run()
        return r.tokens.copy()
    finally:
        s.close()


def _assert_tokens(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}, stream {i}")


def _mid_decode(side, setup):
    rng = np.random.default_rng(7)
    p1 = rng.integers(0, 256, size=24)
    p2 = rng.integers(0, 256, size=16)
    p3 = rng.integers(0, 256, size=24)
    s = _sched(side, setup)
    try:
        r1 = s.submit(p1, max_new_tokens=16)
        s.step()                      # r1 alone for two rounds
        s.step()
        r2 = s.submit(p2, max_new_tokens=12)   # arrives mid-decode of r1
        s.step()
        r3 = s.submit(p3, max_new_tokens=8)    # and another
        s.run()
        reqs = (r1, r2, r3)
        assert _finished(reqs)
        return ([r.tokens.copy() for r in reqs], dict(s.stats),
                [(p1, 16), (p2, 12), (p3, 8)])
    finally:
        s.close()


def test_mid_decode_admission_matches_jax(setup):
    """Streams admitted mid-decode give JAX's tokens and their own solo
    tokens; at oversub 1 the whole stats dict equals JAX's."""
    jtoks, jstats, _ = _mid_decode("jax", setup)
    ttoks, tstats, streams = _mid_decode("torch", setup)
    _assert_tokens(ttoks, jtoks, "port vs JAX")
    _assert_tokens(ttoks, [_solo(setup, p, n) for p, n in streams],
                   "batched vs solo")
    assert tstats == jstats


def _preempt_run(side, setup, resets=0):
    """4 streams at oversub 4 (preemption by decode growth), or at oversub
    2 with ``resets`` device resets forced every second round."""
    rng = np.random.default_rng(23 if resets else 11)
    prompts = [rng.integers(0, 256, size=24) for _ in range(4)]
    kw = dict(oversub=2 if resets else 4, tokens_per_round=8)
    s = _sched(side, setup, **kw)
    try:
        reqs = [s.submit(p, max_new_tokens=48) for p in prompts]
        rounds = forced = 0
        while not s.idle and rounds < 5000:
            s.step()
            rounds += 1
            if rounds % 2 == 0 and forced < resets:
                reset.device_reset()
                forced += 1
        assert forced == resets
        rep = s.report(1.0)
        assert rep["finished"] == 4 and _finished(reqs)
        return [r.tokens.copy() for r in reqs], rep, prompts, kw
    finally:
        s.close()


def test_preempt_restore_matches_jax(setup):
    """Oversubscription forces preempt and restore; every stream's tokens
    equal JAX's and its solo run.  The victim key includes the native
    tracker's span score, which decays on the wall clock, so the victim
    order (and the counts that follow from it) may differ from run to run:
    only the timing-free counts are compared."""
    jtoks, jrep, _, _ = _preempt_run("jax", setup)
    ttoks, trep, prompts, kw = _preempt_run("torch", setup)
    assert trep["preempted"] >= 1, "oversubscription never preempted"
    assert trep["restored"] == trep["preempted"]
    _assert_tokens(ttoks, jtoks, "port vs JAX")
    _assert_tokens(ttoks, [_solo(setup, p, 48, **kw) for p in prompts],
                   "preempted vs solo")
    for k in ("admitted", "retired", "decoded_tokens", "finished"):
        assert trep[k] == jrep[k], k


def test_device_reset_token_exact(setup):
    """Three full-device resets forced mid-decode: the port observes each
    generation bump, parks every running stream and restores it, and the
    tokens equal JAX's under the same resets and the port's reset-free
    solo runs."""
    resets0 = reset.stats().resets
    jtoks, _, _, _ = _preempt_run("jax", setup, resets=3)
    ttoks, trep, prompts, kw = _preempt_run("torch", setup, resets=3)
    assert reset.stats().resets >= resets0 + 6
    assert trep["device_resets_observed"] >= 3, trep
    assert trep["preempted"] >= trep["device_resets_observed"], trep
    _assert_tokens(ttoks, jtoks, "port vs JAX")
    _assert_tokens(ttoks, [_solo(setup, p, 48, **kw) for p in prompts],
                   "reset vs solo")


def test_tenant_quota_preemption(setup):
    """The over-quota low-priority tenant takes every preemption; the
    high-priority tenant is never preempted and all streams finish."""
    rng = np.random.default_rng(3)
    s = _sched("torch", setup, oversub=2, tokens_per_round=8)
    try:
        # Tenant 1: low priority, 6-page quota (two of its streams breach
        # it).  Tenant 2: high priority, unlimited.
        s.configure_tenant(1, priority=1, device_page_quota=6)
        s.configure_tenant(2, priority=50)
        low = [s.submit(rng.integers(0, 256, size=24), 40, tenant=1)
               for _ in range(3)]
        high = [s.submit(rng.integers(0, 256, size=24), 40, tenant=2)]
        rep = s.run()
        assert rep["finished"] == 4 and _finished(low + high)
        assert all(r.preempts == 0 for r in high)
    finally:
        s.close()


def test_cancel_frees_and_keeps_others_exact(setup):
    """Cancelling a queued, a running and a preempted stream frees their
    slots at once; in both packages the streams left run to the tokens of
    their solo runs."""
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 256, size=24) for _ in range(5)]
    kw = dict(oversub=4, tokens_per_round=8)
    seen = {}
    for side in ("jax", "torch"):
        s = _sched(side, setup, **kw)
        try:
            reqs = [s.submit(p, max_new_tokens=32) for p in prompts]
            assert s.cancel(reqs[4].rid)                # still queued
            s.step()
            s.step()                                    # growth preempts
            parked = [r for r in reqs if r.state.value == "preempted"]
            running = [r for r in reqs if r.state.value == "running"]
            assert parked and running
            assert s.cancel(parked[0].rid) and s.cancel(running[0].rid)
            assert not s.cancel(parked[0].rid)          # already terminal
            rep = s.run()
            gone = {reqs[4].rid, parked[0].rid, running[0].rid}
            assert rep["cancelled"] == 3 and rep["finished"] == 2
            seen[side] = {r.rid: r.tokens.copy() for r in reqs
                          if r.rid not in gone}
        finally:
            s.close()
    # Which streams were parked may differ between the two runs (the
    # victim key reads a wall-clock-decayed score): each survivor is held
    # to its solo run instead.
    for side in ("jax", "torch"):
        for rid, toks in seen[side].items():
            np.testing.assert_array_equal(
                toks, _solo(setup, prompts[rid - 1], 32, **kw),
                err_msg=f"{side} stream {rid}")


def test_admit_inject_shed(setup):
    """The sched.admit inject site: bounded retry, then a load shed; no
    error, and every stream completes once the burst ends."""
    rng = np.random.default_rng(5)
    s = _sched("torch", setup, admit_retries=2)
    try:
        evals0, hits0 = inject.counts(inject.Site.SCHED_ADMIT)
        inject.enable(inject.Site.SCHED_ADMIT, inject.Mode.ONESHOT, burst=8)
        reqs = [s.submit(rng.integers(0, 256, size=16), 8)
                for _ in range(3)]
        rep = s.run()
        inject.disable(inject.Site.SCHED_ADMIT)
        assert rep["finished"] == 3 and _finished(reqs)
        assert rep["admit_retries"] >= 2, rep
        assert rep["admit_sheds"] >= 1, rep
        evals, hits = inject.counts(inject.Site.SCHED_ADMIT)
        assert evals > evals0 and hits > hits0
    finally:
        s.close()


def test_sched_spans_and_counters(setup):
    """sched.round and sched.admit spans land in their site histograms,
    and the tpusched_* counters reach the Prometheus exposition."""
    utils.trace_reset()
    utils.trace_start()
    try:
        s = _sched("torch", setup)
        try:
            s.submit(np.random.default_rng(9).integers(0, 256, size=16), 8)
            s.run()
        finally:
            s.close()
    finally:
        utils.trace_stop()
    try:
        assert utils.trace_hist_count("sched.round") > 0
        assert utils.trace_hist_count("sched.admit") > 0
        assert any(e.get("name") == "sched.round"
                   for e in utils.trace_export()["traceEvents"])
        text = utils.metrics_text()
        assert 'tpurm_counter{name="tpusched_admitted"' in text
        assert 'tpurm_counter{name="tpusched_retired"' in text
    finally:
        utils.trace_reset()


def test_flow_roundtrip_perfetto(setup):
    """The trace export pairs each request's sched.admit span (flow start,
    on the scheduler's thread) with memring worker spans running that
    request's restore prefetches and faults (flow finish, same id, another
    thread)."""
    utils.trace_reset()
    utils.trace_start()
    try:
        s = _sched("torch", setup, max_len=64, page_size=8, oversub=4)
        try:
            rng = np.random.default_rng(11)
            reqs = [s.submit(rng.integers(0, 256, size=24),
                             max_new_tokens=16, tenant=i % 2)
                    for i in range(6)]
            s.run()
        finally:
            s.close()
    finally:
        utils.trace_stop()
    try:
        events = utils.trace_export()["traceEvents"]
        starts = [e for e in events if e.get("ph") == "s"]
        ends = [e for e in events if e.get("ph") == "f"]
        assert any(a["id"] == b["id"] and a["tid"] != b["tid"]
                   for a in starts for b in ends), (starts[:3], ends[:3])
        minted = {r.flow & ~0xFFFF for r in reqs}
        assert all(int(a["id"], 16) in minted for a in starts)
    finally:
        utils.trace_reset()


def test_flow_slo_reconciliation(setup):
    """Per-tenant ITL counts equal the tokens each tenant decoded, one TTFT
    sample per stream, every ledger closed within its wall, and the
    preemptions show in the preempted blame bucket."""
    s = _sched("torch", setup, max_len=64, page_size=8, oversub=4)
    try:
        rng = np.random.default_rng(13)
        reqs = [s.submit(rng.integers(0, 256, size=24), max_new_tokens=16,
                         tenant=i % 2) for i in range(6)]
        rep = s.run()
        assert rep["preempted"] > 0, "the workload must preempt"
        for t in (0, 1):
            mine = [r for r in reqs if r.tenant == t]
            assert utils.slo_count(t, "itl") == sum(r.decoded for r in mine)
            assert utils.slo_count(t, "ttft") == len(mine)
            assert rep["slo"][str(t)]["tokens"] == sum(r.decoded
                                                       for r in mine)
        flows = utils.flow_report()
        assert len(flows) == len(reqs)
        assert all(f["state"] == "closed" for f in flows)
        for f in flows:
            assert sum(f["blame_ns"].values()) <= f["wall_ns"], f
        assert any(f["blame_ns"]["preempted"] > 0 for f in flows)
    finally:
        s.close()


def test_construction_errors(setup):
    """``device=None`` means the card and raises without one; ``disagg``
    raises the JAX package's ValueError (no multichip backing)."""
    _, _, tcfg, tparams = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsched.Scheduler(tcfg, tparams)
    with pytest.raises(ValueError) as jerr:
        _sched("jax", setup, disagg=object())
    with pytest.raises(ValueError) as terr:
        _sched("torch", setup, disagg=object())
    assert str(terr.value) == str(jerr.value)


def _blame_run(side, setup):
    """The mid-decode scenario with ``blame_tokens``: the slot-pool
    headroom after every round, and the token blame records."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, size=n) for n in (24, 16, 24)]
    s = _sched(side, setup, blame_tokens=True)
    try:
        free = [s.free_device_pages()]
        reqs = [s.submit(prompts[0], max_new_tokens=16)]
        for i in range(60):
            if i == 2:
                reqs.append(s.submit(prompts[1], max_new_tokens=12))
            if i == 3:
                reqs.append(s.submit(prompts[2], max_new_tokens=8))
            if s.idle:
                break
            s.step()
            free.append(s.free_device_pages())
        assert _finished(reqs)
        return free, list(s.token_blame), [r.tokens.copy() for r in reqs]
    finally:
        s.close()


def test_token_blame_and_free_device_pages_match_jax(setup):
    """``free_device_pages`` after every round, and one token blame record
    per stream per round with JAX's (rid, tenant, round), in JAX's order;
    the times inside a record are the host's, so only their shape is
    held: a positive ITL inside its stall-inclusive gap, and blame in the
    ledger's buckets."""
    jfree, jblame, jtoks = _blame_run("jax", setup)
    tfree, tblame, ttoks = _blame_run("torch", setup)
    _assert_tokens(ttoks, jtoks, "port vs JAX")
    assert tfree == jfree
    assert [(r["rid"], r["tenant"], r["round"]) for r in tblame] == \
        [(r["rid"], r["tenant"], r["round"]) for r in jblame]
    assert len(tblame) == (16 + 12 + 8) // 4
    for r in tblame:
        assert 0 < r["itl_ns"] <= r["gap_ns"]
        assert set(r["blame_ns"]) <= set(utils.FLOW_BUCKETS)
        assert all(v > 0 for v in r["blame_ns"].values())
