"""The port's tiered KV cache (UVM-managed backing, device slot pool, victim
ring, prefetch staging) against the JAX package's, on tiny at fp32.

Each scenario of the JAX package's own tiered tests (tests/test_serving.py)
runs here through both packages in one process, on the same numpy-seeded
inputs: the port must make the same observations and end in the same
``stats``, and its greedy tokens must equal JAX's.  Both packages load the
same native library (native/build/libtpurm.so, built with ``make -C
native``), each in VA spaces of its own.  The slot pool lives on the CPU
here (``device="cpu"``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_gpu_kernel_modules_tpu import uvm as juvm
from open_gpu_kernel_modules_tpu.models import serving as jserving
from open_gpu_kernel_modules_tpu_torch import uvm as tuvm
from open_gpu_kernel_modules_tpu_torch.models import serving as tserving

from torch_port_util import tiny_pair, tokens

SIDES = ("jax", "torch")


@pytest.fixture(scope="module")
def setup():
    return tiny_pair(vocab_size=128, max_seq_len=128)


def _cache(side, setup, **kw):
    jcfg, _, tcfg, _ = setup
    if side == "jax":
        return jserving.TieredKVCache(jcfg, **kw)
    return tserving.TieredKVCache(tcfg, device="cpu", **kw)


def _both(setup, scenario, **kw):
    """Run ``scenario(side, cache)`` on a fresh cache of each package;
    return {side: what it observed}."""
    out = {}
    for side in SIDES:
        cache = _cache(side, setup, **kw)
        try:
            out[side] = scenario(side, cache)
        finally:
            cache.close()
    return out


def _slot_value(view, row, pg):
    return float(view.k_pages[0, int(view.page_table[row, pg]), 0, 0, 0])


def test_tiered_activation_faults_and_uploads(setup):
    def scenario(side, tiered):
        fault_stats = (juvm if side == "jax" else tuvm).fault_stats
        assert tiered.n_slots == 8              # 32 logical pages / 4
        tiered.k_view()[:, 0, :, :, :] = 1.0
        tiered.seq_lens[0] = 40
        before = fault_stats()
        view = tiered.activate([0], new_tokens=1)
        after = fault_stats()
        # 3 pages (ceil(41/16)) faulted device-ward + uploaded.
        assert tiered.stats["uploads"] == 3
        assert after.faults_device > before.faults_device
        first = _slot_value(view, 0, 0)
        tiered.sync_from(view, [0])
        info = tiered.k_buf.residency(offset=0)
        assert info.hbm or info.cxl
        # Oversubscribe: other sequences evict seq 0's slots, and
        # re-activating seq 0 reloads the seeded bytes.
        for b in (1, 2, 3):
            tiered.seq_lens[b] = 40
            v2 = tiered.activate([b], new_tokens=1)
            tiered.sync_from(v2, [b])
        assert tiered.stats["flushes"] > 0
        v3 = tiered.activate([0], new_tokens=1)
        again = _slot_value(v3, 0, 0)
        tiered.sync_from(v3, [0])
        return first, again, dict(tiered.stats)

    seen = _both(setup, scenario, batch=4, max_len=128, page_size=16,
                 oversub=4)
    assert seen["torch"][:2] == (1.0, 1.0)
    assert seen["torch"] == seen["jax"]


def test_tiered_activation_never_evicts_own_group(setup):
    def scenario(side, tiered):
        kview = tiered.k_view()
        for pg in range(8):
            kview[:, pg] = float(pg + 1)          # seq 0's pages
            kview[:, 8 + pg] = float(100 + pg)    # seq 1's pages
        for b in (0, 1):
            tiered.seq_lens[b] = 60
            v = tiered.activate([b], new_tokens=1)
            tiered.sync_from(v, [b])
        # Seq 0 grows to need ALL 8 slots: its own 4 stay pinned, the 4
        # new ones evict seq 1's, and every page's data is present.
        tiered.seq_lens[0] = 120
        v = tiered.activate([0], new_tokens=1)
        got = [_slot_value(v, 0, pg) for pg in range(8)]
        tiered.sync_from(v, [0])
        flushed = float(tiered.k_view()[0, 8, 0, 0, 0])
        return got, flushed, dict(tiered.stats)

    seen = _both(setup, scenario, batch=2, max_len=128, page_size=16,
                 oversub=2)
    got, flushed, _ = seen["torch"]
    assert got == [float(pg + 1) for pg in range(8)]
    assert flushed == 100.0
    assert seen["torch"] == seen["jax"]


def _decode_run(side, setup, oversub):
    jcfg, jparams, tcfg, tparams = setup
    serving = jserving if side == "jax" else tserving
    cfg, params = (jcfg, jparams) if side == "jax" else (tcfg, tparams)
    prompts = tokens(7, (4, 9), tcfg.vocab_size)
    cache = _cache(side, setup, batch=4, max_len=64, page_size=8,
                   oversub=oversub)
    try:
        for g in ([0, 1], [2, 3]):
            p = prompts[np.array(g)]
            serving.prefill_group(cfg, params, cache, g,
                                  jnp.asarray(p) if side == "jax"
                                  else torch.from_numpy(p))
        total, _ = serving.decode_rounds(cfg, params, cache,
                                         groups=[[0, 1], [2, 3]],
                                         tokens_per_turn=3, turns=3)
        assert total == 2 * 2 * 3 * 3
        assert int(cache.seq_lens[0]) == 9 + 9
        return np.array(cache.last_token), dict(cache.stats)
    finally:
        cache.close()


@pytest.fixture(scope="module")
def rounds(setup):
    """decode_rounds results {(side, oversub): (last tokens, stats)}."""
    return {(side, o): _decode_run(side, setup, o)
            for side in SIDES for o in (1, 4)}


def test_tiered_decode_matches_dense(rounds):
    """Grouped decode through the 4x-oversubscribed cache gives EXACTLY the
    tokens of the fully resident (oversub=1) cache."""
    dense_tok, dense_stats = rounds[("torch", 1)]
    tiered_tok, tiered_stats = rounds[("torch", 4)]
    np.testing.assert_array_equal(dense_tok, tiered_tok)
    assert tiered_stats["flushes"] > 0
    assert dense_stats["flushes"] == 0


@pytest.mark.parametrize("oversub", [1, 4])
def test_decode_rounds_match_jax(rounds, oversub):
    """Same greedy tokens and the same stats dict as the JAX package."""
    ttok, tstats = rounds[("torch", oversub)]
    jtok, jstats = rounds[("jax", oversub)]
    np.testing.assert_array_equal(ttok, jtok)
    assert tstats == jstats


def test_prefetch_stages_activation(setup):
    def scenario(side, tiered):
        kview = tiered.k_view()
        for b in range(4):
            kview[:, b * 8, :, :, :] = float(b + 1)
            tiered.seq_lens[b] = 12
        st = tiered.prefetch([0, 1], new_tokens=1)
        assert st.pages == (0, 8)
        view = tiered.activate([0, 1], new_tokens=1, staged=st)
        assert tiered.stats["prefetched_uploads"] == 2
        staged = [_slot_value(view, i, 0) for i in (0, 1)]
        tiered.sync_from(view, [0, 1], decoded=1)   # marks pages dirty
        # A STALE staging (residency changed since prefetch) falls back
        # to the synchronous read path and is still right.
        st23 = tiered.prefetch([2], new_tokens=1)
        view = tiered.activate([2, 3], new_tokens=1, staged=st23)
        stale = [_slot_value(view, i, 0) for i in (0, 1)]
        tiered.sync_from(view, [2, 3], decoded=1)
        # Fill the whole pool in one activation so seqs 0/1's dirty
        # slots evict into the victim ring; a host view read drains it.
        tiered.seq_lens[2] = 60
        tiered.seq_lens[3] = 60
        v = tiered.activate([2, 3], new_tokens=1)
        tiered.sync_from(v, [2, 3], decoded=1)
        assert tiered.stats["flushes"] >= 2
        parked = len(tiered._victim_map)
        drained = float(tiered.k_view()[0, 0, 0, 0, 0])
        assert not tiered._victim_map
        return staged, stale, parked, drained, dict(tiered.stats)

    seen = _both(setup, scenario, batch=4, max_len=128, page_size=16,
                 oversub=4)
    staged, stale, parked, drained, _ = seen["torch"]
    assert (staged, stale, drained) == ([1.0, 2.0], [3.0, 4.0], 1.0)
    assert parked > 0
    assert seen["torch"] == seen["jax"]


def test_flush_group_cleans_and_persists(setup):
    prompts = tokens(3, (2, 9), 128)

    def scenario(side, tiered):
        jcfg, jparams, tcfg, tparams = setup
        if side == "jax":
            jserving.prefill_group(jcfg, jparams, tiered, [0, 1],
                                   jnp.asarray(prompts))
        else:
            tserving.prefill_group(tcfg, tparams, tiered, [0, 1],
                                   torch.from_numpy(prompts))
        # prefill_group flushed: nothing dirty, the backing holds the KV.
        assert not tiered._dirty_slots
        assert tiered.stats.get("setup_flushes", 0) > 0
        view = tiered.activate([0], new_tokens=0)
        kview = tiered.k_view()
        # The 9-token prompt spans page 0 (8 tokens) and page 1 (1 token).
        s0 = int(view.page_table[0, 0])
        s1 = int(view.page_table[0, 1])
        np.testing.assert_allclose(np.asarray(view.k_pages[0, s0]),
                                   kview[0, 0], atol=1e-6)
        np.testing.assert_allclose(np.asarray(view.k_pages[0, s1, :1]),
                                   kview[0, 1, :1], atol=1e-6)
        tiered.sync_from(view, [0])
        return (np.array(kview[:, :2]), np.array(tiered.last_token),
                dict(tiered.stats))

    seen = _both(setup, scenario, batch=4, max_len=64, page_size=8,
                 oversub=1)
    tk, ttok, tstats = seen["torch"]
    jk, jtok, jstats = seen["jax"]
    np.testing.assert_allclose(tk, jk, atol=1e-4)
    np.testing.assert_array_equal(ttok, jtok)
    assert tstats == jstats


def test_bf16_pages_round_trip_bit_exact(setup):
    """bf16 lives in the backing as uint16 bits: bytes written through
    k_view reach the slot pool unchanged, and slot bytes come back
    unchanged through both readback paths (victim-ring drain and
    flush_group's write-back)."""
    tcfg = dataclasses.replace(setup[2], dtype=torch.bfloat16)
    tiered = tserving.TieredKVCache(tcfg, batch=4, max_len=128,
                                    page_size=16, oversub=8, device="cpu")
    try:
        assert tiered.np_dtype == np.uint16 and tiered.n_slots == 8
        rng = np.random.default_rng(11)
        shape = tiered.k_view()[:, :4].shape
        bits = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16).view(torch.int16).numpy()
        tiered.k_view()[:, :4] = bits.view(np.uint16)     # seq 0's pages
        tiered.seq_lens[0] = 63
        view = tiered.activate([0], new_tokens=1)
        slots = [int(view.page_table[0, pg]) for pg in range(4)]
        got = tiered.k_slots[:, slots].view(torch.int16).numpy()
        np.testing.assert_array_equal(got, bits)

        # Seq 0's slots get new bits and are marked written; seq 1 then
        # takes the whole pool, which parks them in the victim ring; the
        # drain must write the NEW bits back.
        new = (-tiered.k_slots[:, slots]).contiguous()
        tiered.k_slots[:, slots] = new
        tiered.sync_from(view, [0], decoded=0, host_lens=np.array([63]))
        tiered.seq_lens[1] = 127
        tiered.sync_from(tiered.activate([1], new_tokens=1), [1])
        assert tiered.stats["flushes"] == 4
        back = tiered.k_view()[:, :4]                   # drains the ring
        np.testing.assert_array_equal(
            back, new.view(torch.int16).numpy().view(np.uint16))
        assert tiered.stats["drains"] == 1

        # flush_group's write-back path: seq 1's slots, written, flushed.
        v1 = tiered.activate([1], new_tokens=0)
        s1 = [int(v1.page_table[0, pg]) for pg in range(8)]
        tiered.k_slots[:, s1] = tiered.k_slots[:, s1] * 2 + 1
        tiered.sync_from(v1, [1], decoded=0, host_lens=np.array([127]))
        expect = tiered.k_slots[:, s1].view(torch.int16).numpy().view(
            np.uint16)
        tiered.flush_group([1])
        np.testing.assert_array_equal(tiered.k_view()[:, 8:16], expect)
    finally:
        tiered.close()


def test_release_keep_len_reactivates_same_kv(setup):
    """A preempted sequence (flush_group + release_sequence(keep_len=True))
    keeps its length, and re-activating it after other groups took its
    slots gives back exactly the KV it had."""
    _, _, tcfg, tparams = setup
    prompts = torch.from_numpy(tokens(5, (4, 9), tcfg.vocab_size))
    tiered = tserving.TieredKVCache(tcfg, batch=4, max_len=64, page_size=8,
                                    oversub=2, device="cpu")
    try:
        for g in ([0, 1], [2, 3]):
            tserving.prefill_group(tcfg, tparams, tiered, g, prompts[g])
        tserving.decode_rounds(tcfg, tparams, tiered, [[0, 1]],
                               tokens_per_turn=2, turns=1)
        view = tiered.activate([0], new_tokens=0)
        pages = [int(view.page_table[0, pg]) for pg in range(2)]
        before = (tiered.k_slots[:, pages].clone(),
                  tiered.v_slots[:, pages].clone())
        tiered.sync_from(view, [0])
        tiered.flush_group([0])
        tiered.release_sequence(0, keep_len=True)
        assert tiered.stats["releases"] == 1
        assert int(tiered.seq_lens[0]) == 11
        assert tiered.slot_of[0] == -1 and tiered.slot_of[1] == -1
        # Seqs 2 and 3 grow over the whole pool, seq 0's old slots too.
        tiered.sync_from(tiered.activate([2, 3], new_tokens=50), [2, 3])
        assert tiered.slot_owner.min() >= 16      # seqs 2 and 3 own all
        view = tiered.activate([0], new_tokens=0)
        pages = [int(view.page_table[0, pg]) for pg in range(2)]
        torch.testing.assert_close(tiered.k_slots[:, pages], before[0],
                                   rtol=0, atol=0)
        torch.testing.assert_close(tiered.v_slots[:, pages], before[1],
                                   rtol=0, atol=0)
        tiered.sync_from(view, [0])
    finally:
        tiered.close()
