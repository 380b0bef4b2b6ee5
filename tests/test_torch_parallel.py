"""The port's parallel layer against the JAX package's, on the CPU.

One spawn of eight gloo ranks (``parallel.mesh.run_ranks``, a file store
under ``tmp_path``) runs every scenario and returns what each rank saw; the
JAX references run in this process on conftest's 8-device CPU mesh.  A
rank's mesh coordinate is its index in the JAX mesh's device array, so each
rank is held against the JAX shard on that device.

This module imports JAX only inside its fixtures: the ranks import it by
name to find ``_rank_body`` and must not import JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from open_gpu_kernel_modules_tpu_torch import entry
from open_gpu_kernel_modules_tpu_torch.models import llama
from open_gpu_kernel_modules_tpu_torch.models.convert import params_from_jax
from open_gpu_kernel_modules_tpu_torch.parallel import mesh as pmesh
from open_gpu_kernel_modules_tpu_torch.parallel import (
    ring_attention_sharded, ulysses_attention_sharded)

WORLD = 8
RANKS_TIMEOUT_S = 120
VOCAB, MAX_SEQ = 256, 64
TRAIN_TOKENS = (4, 32)          # the dryrun's (dp*2, 32) at dp=2
FWD_TOKENS = (4, 16)
# (name, (dp, tp, sp), causal, (b, s, h, d), schemes): the shapes of
# test_ops_parallel.py's ring and Ulysses tests.
ATTN = [("ring_causal", (2, 1, 4), True, (2, 128, 4, 32), ("ring",)),
        ("ring_full", (1, 1, 8), False, (1, 64, 2, 16), ("ring",)),
        ("ulysses_causal", (2, 1, 4), True, (2, 128, 4, 32), ("ulysses",)),
        ("ring_vs_ulysses", (1, 1, 8), False, (1, 64, 8, 16),
         ("ring", "ulysses"))]
SCHEMES = {"ring": ring_attention_sharded,
           "ulysses": ulysses_attention_sharded}
MESHES = {"dp2xtp2xsp2": (2, 2, 2), "dp2xtp4xsp1": (2, 4, 1)}
ATTN_ATOL = 2e-5                # fp32: exact attentions, other sum orders
LOGITS_ATOL = 2e-5              # fp32 logits of order 1, other sum orders
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-7               # lr 1e-3 times fp32 gradient noise


def _seeded(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


def _cfg():
    return dataclasses.replace(
        llama.LlamaConfig.tiny(vocab_size=VOCAB, max_seq_len=MAX_SEQ),
        dtype=torch.float32)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _rank_body(np_params):
    """Every scenario, on this rank: a dict of numpy results."""
    cfg = _cfg()
    params = params_from_jax(np_params, device="cpu")
    out = {}
    try:
        pmesh.make_mesh(4, 2, 2, "cpu")
    except ValueError as e:
        out["too_small"] = str(e)
    surplus = pmesh.make_mesh(1, 2, 2, "cpu")
    out["surplus_coord"] = surplus.get_coordinate()
    for name, (dp, tp, sp) in MESHES.items():
        mesh = pmesh.make_mesh(dp, tp, sp, "cpu")
        rec = out[name] = {"coord": tuple(mesh.get_coordinate()),
                           "names": mesh.mesh_dim_names,
                           "shape": tuple(mesh.shape)}
        local = pmesh.shard_params(params, mesh, cfg)
        rec["shards"] = _np_tree(local)
        toks = torch.from_numpy(_tokens(1, FWD_TOKENS))
        with torch.no_grad():
            rec["logits"] = pmesh.forward(
                cfg, local, pmesh.batch_rows(mesh, toks), mesh).numpy()
        toks = torch.from_numpy(_tokens(2, TRAIN_TOKENS))
        loss, new, _ = entry.sgd_step(cfg, local, toks, toks.roll(-1, 1),
                                      mesh)
        rec["loss"], rec["new"] = loss, _np_tree(new)
    for i, (name, (dp, tp, sp), causal, shape, schemes) in enumerate(ATTN):
        mesh = pmesh.make_mesh(dp, tp, sp, "cpu")
        q, k, v = (torch.from_numpy(_seeded(10 * i + j, shape))
                   for j in range(3))
        out[name] = {f: SCHEMES[f](q, k, v, mesh, causal).numpy()
                     for f in schemes}
    mesh = pmesh.make_mesh(1, 1, 8, "cpu")
    q = torch.from_numpy(_seeded(99, (1, 64, 4, 16)))
    try:
        ulysses_attention_sharded(q, q, q, mesh)
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


@pytest.fixture(scope="module")
def jax_side():
    import jax
    from open_gpu_kernel_modules_tpu.models import llama as jllama
    from torch_port_util import tiny_pair

    jcfg, jparams, _, _ = tiny_pair(vocab_size=VOCAB, max_seq_len=MAX_SEQ)
    return jax, jllama, jcfg, jparams


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    jax, _, _, jparams = jax_side
    np_params = jax.tree.map(np.asarray, jparams)
    return pmesh.run_ranks(_rank_body, WORLD, (np_params,), device="cpu",
                           timeout_s=RANKS_TIMEOUT_S,
                           store_dir=str(tmp_path_factory.mktemp("store")))


def _jmesh(dp, tp, sp):
    from open_gpu_kernel_modules_tpu import parallel as jparallel
    return jparallel.make_mesh(dp=dp, tp=tp, sp=sp)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _shard_on(arr, device):
    """The data of a sharded JAX array's shard on ``device``."""
    return next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device == device)


def test_make_mesh_axes(ranks):
    for r, out in enumerate(ranks):
        rec = out["dp2xtp2xsp2"]
        assert rec["names"] == ("dp", "tp", "sp")
        assert rec["shape"] == (2, 2, 2)
        assert rec["coord"] == tuple(np.unravel_index(r, (2, 2, 2)))


def test_make_mesh_too_small_and_surplus_ranks(ranks):
    for r, out in enumerate(ranks):
        assert out["too_small"] == "need 16 devices, have 8"
        want = tuple(np.unravel_index(r, (1, 2, 2))) if r < 4 else None
        assert (None if out["surplus_coord"] is None
                else tuple(out["surplus_coord"])) == want


def test_shard_params_match_jax_named_sharding(ranks, jax_side):
    """Every shard equals the data of JAX's NamedSharding shard on the
    device at the rank's mesh coordinate."""
    from open_gpu_kernel_modules_tpu import parallel as jparallel

    _, _, _, jparams = jax_side
    mesh = _jmesh(2, 2, 2)
    sharded = jparallel.shard_params(jparams, mesh)
    for out in ranks:
        rec = out["dp2xtp2xsp2"]
        dev = mesh.devices[rec["coord"]]
        for name, shard in _leaves(rec["shards"]):
            np.testing.assert_array_equal(
                shard, _shard_on(_get(sharded, name), dev), err_msg=name)


def test_shard_params_kv_replication(ranks, jax_side):
    """At tp=4 over 2 kv heads each rank keeps the whole kv head its local
    query heads read; every other key is JAX's shard."""
    from open_gpu_kernel_modules_tpu import parallel as jparallel

    _, _, jcfg, jparams = jax_side
    mesh = _jmesh(2, 4, 1)
    sharded = jparallel.shard_params(jparams, mesh)
    hd, per_kv = jcfg.head_dim, 4 // jcfg.num_kv_heads
    for out in ranks:
        rec = out["dp2xtp4xsp1"]
        dev = mesh.devices[rec["coord"]]
        head = rec["coord"][1] // per_kv
        for name, shard in _leaves(rec["shards"]):
            if name in ("layers/wk", "layers/wv"):
                want = np.asarray(_get(jparams, name))[
                    ..., head * hd:(head + 1) * hd]
            else:
                want = _shard_on(_get(sharded, name), dev)
            np.testing.assert_array_equal(shard, want, err_msg=name)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_tp_forward_matches_jax(ranks, jax_side, mesh_name):
    from open_gpu_kernel_modules_tpu import parallel as jparallel

    jax, jllama, jcfg, jparams = jax_side
    mesh = _jmesh(*MESHES[mesh_name])
    toks = _tokens(1, FWD_TOKENS)
    with mesh:
        ref = np.asarray(jax.jit(lambda p, t: jllama.forward(jcfg, p, t))(
            jparallel.shard_params(jparams, mesh), toks))
    dp = MESHES[mesh_name][0]
    rows = FWD_TOKENS[0] // dp
    for out in ranks:
        rec = out[mesh_name]
        d = rec["coord"][0]
        np.testing.assert_allclose(rec["logits"],
                                   ref[d * rows:(d + 1) * rows],
                                   atol=LOGITS_ATOL)


def _jax_train_step(jax, jllama, jcfg, params, tokens, targets):
    """``__graft_entry__.dryrun_multichip``'s train_step."""
    import jax.numpy as jnp

    loss, grads = jax.value_and_grad(
        lambda p: jllama.loss_fn(jcfg, p, tokens, targets))(params)
    new_params = jax.tree_util.tree_map(
        lambda p, g: (p.astype(jnp.float32) - 1e-3 * g).astype(p.dtype),
        params, grads)
    return loss, new_params


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_sgd_step_matches_jax(ranks, jax_side, mesh_name):
    """The loss and every updated shard equal JAX's jitted train_step over
    the same mesh (at tp=4 the kv replicas equal the updated whole head)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from open_gpu_kernel_modules_tpu import parallel as jparallel

    jax, jllama, jcfg, jparams = jax_side
    mesh = _jmesh(*MESHES[mesh_name])
    toks = _tokens(2, TRAIN_TOKENS)
    put = NamedSharding(mesh, P("dp", None))
    step = jax.jit(lambda p, t, y: _jax_train_step(jax, jllama, jcfg, p, t,
                                                   y))
    with mesh:
        loss, new = step(jparallel.shard_params(jparams, mesh),
                         jax.device_put(toks, put),
                         jax.device_put(np.roll(toks, -1, 1), put))
    tp, hd = MESHES[mesh_name][1], jcfg.head_dim
    specs = pmesh.llama_param_specs()
    for out in ranks:
        rec = out[mesh_name]
        np.testing.assert_allclose(rec["loss"], float(loss), rtol=LOSS_RTOL)
        t = rec["coord"][1]
        for name, shard in _leaves(rec["new"]):
            # XLA picks the outputs' shardings: compare with the global
            # array cut by the port's rule.
            want = np.asarray(_get(new, name))
            dim = _get(specs, name)
            if tp > jcfg.num_kv_heads and name in ("layers/wk",
                                                   "layers/wv"):
                head = t // (tp // jcfg.num_kv_heads)
                want = want[..., head * hd:(head + 1) * hd]
            elif dim is not None:
                want = np.split(want, tp, axis=dim)[t]
            np.testing.assert_allclose(shard, want, atol=PARAM_ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("case", ATTN, ids=lambda c: c[0])
def test_sequence_parallel_attention_matches_jax(ranks, case):
    from open_gpu_kernel_modules_tpu import parallel as jparallel

    name, (dp, tp, sp), causal, shape, schemes = case
    i = ATTN.index(case)
    q, k, v = (_seeded(10 * i + j, shape) for j in range(3))
    for scheme in schemes:
        fn = getattr(jparallel, f"{scheme}_attention_sharded")
        ref = np.asarray(fn(q, k, v, _jmesh(dp, tp, sp), causal=causal))
        for out in ranks:
            np.testing.assert_allclose(out[name][scheme], ref,
                                       atol=ATTN_ATOL, err_msg=scheme)


def test_ring_equals_ulysses(ranks):
    """test_ops_parallel.py's ring == Ulysses case on the port."""
    for out in ranks:
        got = out["ring_vs_ulysses"]
        np.testing.assert_allclose(got["ulysses"], got["ring"],
                                   atol=ATTN_ATOL)


def test_ulysses_rejects_indivisible_heads(ranks):
    from open_gpu_kernel_modules_tpu import parallel as jparallel

    q = _seeded(99, (1, 64, 4, 16))
    with pytest.raises(ValueError, match="divide") as jerr:
        jparallel.ulysses_attention_sharded(q, q, q, _jmesh(1, 1, 8))
    for out in ranks:
        assert out["indivisible"] == str(jerr.value)


def _fail_or_wait(fail_rank, sleep_s):
    import time

    import torch.distributed as dist
    if dist.get_rank() == fail_rank:
        raise ValueError("boom")
    time.sleep(sleep_s)
    dist.barrier()


@pytest.mark.parametrize("fail_rank,sleep_s,timeout_s,error,match", [
    (1, 0.0, 60.0, RuntimeError, r"^rank 1 failed:(.|\n)*ValueError: boom"),
    (-1, 30.0, 2.0, TimeoutError, r"ranks \[0, 1\] did not answer")],
    ids=["rank_fails", "timeout"])
def test_run_ranks_fails_fast(tmp_path, fail_rank, sleep_s, timeout_s,
                              error, match):
    """A failing rank is reported at once with its traceback (its peer,
    waiting in a barrier, is killed); ranks that outlast the limit raise
    TimeoutError.  Either way no rank process is left."""
    import multiprocessing
    import time

    t0 = time.monotonic()
    with pytest.raises(error, match=match):
        pmesh.run_ranks(_fail_or_wait, 2, (fail_rank, sleep_s),
                        device="cpu", timeout_s=timeout_s,
                        store_dir=str(tmp_path))
    assert time.monotonic() - t0 < 25
    assert not multiprocessing.active_children()
