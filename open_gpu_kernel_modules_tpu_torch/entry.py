"""Entry points of the port: a single-card forward check and the multichip
dryrun (the counterpart of the JAX package's root ``__graft_entry__.py``).

    python -m open_gpu_kernel_modules_tpu_torch.entry

prints ``entry ok: <shape> <dtype>`` after one forward on the card.
``dryrun_multichip(n)`` runs one SGD train step of tiny Llama over a
dp x tp x sp mesh of ``n`` rank processes, ring attention and Ulysses
attention over sp, then the native multichip serving path (a KV pool over
four device arenas, moved over the engine's ICI model).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .device import DeviceLike, resolve
from .models import llama
from .ops import flash_attention
from .parallel import mesh as pmesh
from .parallel.ring_attention import ring_attention_sharded
from .parallel.ulysses import ulysses_attention_sharded

# ring == Ulysses at fp32 (JAX's dryrun limit): two exact attentions that
# sum in another order, one through the flash kernel's base-2 softmax.
RING_ULYSSES_ATOL = 2e-4
# The rank processes' limit, start-up and the kernels' first use included.
DRYRUN_TIMEOUT_S = 300.0


def entry(device: DeviceLike = None):
    """(fn, example_args): ``llama.forward`` on tiny Llama at a quick size,
    with seeded parameters and (2, 64) zero tokens on ``device``."""
    device = resolve(device)
    cfg = llama.LlamaConfig.tiny(vocab_size=512, max_seq_len=256)
    params = llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    tokens = torch.zeros((2, 64), dtype=torch.int32, device=device)

    def fn(params, tokens):
        return llama.forward(cfg, params, tokens)

    return fn, (params, tokens)


def sgd_step(cfg: llama.LlamaConfig, params: Dict[str, Any],
             tokens: torch.Tensor, targets: torch.Tensor,
             mesh: Optional[DeviceMesh] = None,
             lr: float = 1e-3) -> Tuple[float, Dict[str, Any],
                                        Dict[str, Any]]:
    """One SGD step of ``llama.loss_fn`` (the dryrun's ``train_step``):
    returns (loss, new parameters, gradients); ``params`` is left as it is.

    With a ``mesh``, ``params`` are this rank's shards
    (``parallel.shard_params``), ``tokens``/``targets`` the global batch, of
    which the rank takes its dp rows; the loss is the global batch mean and
    the gradients those of it (``parallel.mesh.sync_grads``).  The update is
    ``(p.float() - lr * g).to(p.dtype)``, as JAX's."""
    leaves = llama.tree_map(lambda p: p.detach().requires_grad_(True), params)
    if mesh is None:
        loss = llama.loss_fn(cfg, leaves, tokens, targets)
    else:
        loss = pmesh.loss_fn(cfg, leaves, pmesh.batch_rows(mesh, tokens),
                             pmesh.batch_rows(mesh, targets), mesh)
    loss.backward()
    grads = llama.tree_map(lambda p: p.grad, leaves)
    loss = loss.detach()
    if mesh is not None:
        pmesh.sync_grads(cfg, grads, mesh)
        dist.all_reduce(loss, group=mesh.get_group("dp"))
        loss = loss / mesh.size(0)
    with torch.no_grad():
        new = llama.tree_map(lambda p, g: (p.float() - lr * g).to(p.dtype),
                        leaves, grads)
    return float(loss), new, grads


def _mesh_shape(n_devices: int) -> Tuple[int, int, int]:
    """JAX's factoring of n into (dp, tp, sp): sp=2 when n is even (a ring
    needs two), then the largest tp <= sqrt(rest), dp the remainder."""
    sp = 2 if n_devices % 2 == 0 else 1
    rest = n_devices // sp
    tp = next(t for t in range(int(rest ** 0.5), 0, -1) if rest % t == 0)
    return rest // tp, tp, sp


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _dryrun_rank(dp: int, tp: int, sp: int, device_type: str) -> dict:
    """One rank of ``dryrun_multichip``: the train step, then ring and
    Ulysses attention on the same q/k/v."""
    device = torch.device(device_type)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mesh = pmesh.make_mesh(dp, tp, sp, device)
    cfg = llama.LlamaConfig.tiny(vocab_size=256, max_seq_len=64)
    params = pmesh.shard_params(llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device),
        mesh, cfg)
    tokens = torch.zeros((dp * 2, 32), dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    loss, params, _ = sgd_step(cfg, params, tokens, tokens, mesh)
    _sync(device)
    t1 = time.perf_counter()

    b, s, h, d = dp * 2, sp * 16, 4, 16
    gen = torch.Generator(device=device).manual_seed(1)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device)
               for _ in range(3))
    out = ring_attention_sharded(q, k, v, mesh, causal=True)
    _sync(device)
    t2 = time.perf_counter()
    launches = flash_attention.launches
    out2 = ulysses_attention_sharded(q, k, v, mesh, causal=True)
    _sync(device)
    t3 = time.perf_counter()
    err = float((out - out2).abs().max())
    if not err <= RING_ULYSSES_ATOL:
        raise AssertionError(f"ring and Ulysses attention differ by {err} "
                             f"(atol {RING_ULYSSES_ATOL})")
    return {"loss": loss, "ring_attn": tuple(out.shape),
            "ring_ulysses_err": err,
            "flash_launches": flash_attention.launches - launches,
            "train_ms": (t1 - t0) * 1e3, "ring_ms": (t2 - t1) * 1e3,
            "ulysses_ms": (t3 - t2) * 1e3,
            "peak_mib": (torch.cuda.max_memory_allocated() / 2 ** 20
                         if device.type == "cuda" else None)}


def _native_ici(device: DeviceLike = None) -> dict:
    """The native multichip segment of the dryrun: tiny fp32 Llama decoding
    over a KV pool homed on four device arenas (``TPUMEM_FAKE_TPU_COUNT``
    must be 4 or more before the engine loads), the direct 0<->1 link failed
    mid-decode (the routing must detour and serving go on), then >= 8 MB of
    page records to and from homes on the failed link's peer, whose per-link
    byte counters must equal hops x payload (store and forward)."""
    from .models import multichip, serving
    from .runtime import ici

    device = resolve(device)
    mcfg = llama.LlamaConfig.tiny(vocab_size=128, max_seq_len=128)
    mcfg = type(mcfg)(**{**mcfg.__dict__, "dtype": torch.float32})
    mparams = llama.init_params(
        mcfg, torch.Generator(device=device).manual_seed(2), device)
    cache = multichip.make_multichip_cache(
        mcfg, batch=4, max_len=64, page_size=8, oversub=4, n_devices=4,
        device=device)
    try:
        prompts = torch.randint(
            0, mcfg.vocab_size, (4, 9),
            generator=torch.Generator(device=device).manual_seed(3),
            device=device)
        for g in ([0, 1], [2, 3]):
            serving.prefill_group(mcfg, mparams, cache, g, prompts[g])
        serving.decode_rounds(mcfg, mparams, cache, [[0, 1], [2, 3]], 3, 2)
        direct = next(link for link in range(ici.link_count(0))
                      if ici.link_info(0, link).peer == 1)
        before_tx = cache.backing.link_traffic()
        ici.inject_link_failure(0, direct)
        detour_hops = ici.route_hops(0, 1)
        if detour_hops < 2:
            raise RuntimeError(
                f"link failure did not reroute (hops={detour_hops})")
        serving.decode_rounds(mcfg, mparams, cache, [[0, 1], [2, 3]], 3, 2)
        cache.drain_flushes()           # victims ride ICI home
        after_tx = cache.backing.link_traffic()
        detour_bytes = after_tx["0->(3)"] - before_tx["0->(3)"]
        if detour_bytes <= 0:
            raise RuntimeError("no detour traffic after link failure")
        st = dict(cache.backing.stats)
        if st["ici_fetch_records"] == 0:
            raise RuntimeError("no ICI traffic: pool not multi-chip")

        mb_pool = multichip.IciPoolBacking(
            pool_shape=(2, 160, 64, 16, 16), np_dtype=np.dtype("f4"),
            page_bytes=64 * 16 * 16 * 4, n_devices=4)
        try:
            peer_pages = [p for p in range(160)
                          if int(mb_pool.home[p]) == 1][:40]
            hops_fwd = ici.route_hops(0, 1)
            hops_rev = ici.route_hops(1, 0)
            tx0 = cache.backing.link_traffic()
            moved = 0
            for p in peer_pages:
                rec = np.full((2,) + mb_pool.rec_shape[1:], p % 251, "f4")
                mb_pool.write_page(p, rec[0], rec[1])
                moved += mb_pool.record_bytes
            k_back, _ = mb_pool.read_pages(peer_pages)
            moved += len(peer_pages) * mb_pool.record_bytes
            if not np.array_equal(k_back[:, 3], np.full_like(
                    k_back[:, 3], peer_pages[3] % 251)):
                raise RuntimeError("MB-scale detour data corrupt")
            tx1 = cache.backing.link_traffic()
            link_delta = sum(tx1[k] - tx0.get(k, 0) for k in tx1)
            payload = len(peer_pages) * mb_pool.record_bytes
            expect = payload * hops_fwd + payload * hops_rev
            if moved < 8 * (1 << 20):
                raise RuntimeError(
                    f"MB-scale segment too small: {moved} bytes")
            if link_delta != expect:
                raise RuntimeError(
                    f"store-and-forward accounting mismatch: links moved "
                    f"{link_delta}, model predicts {expect} ({payload} x "
                    f"({hops_fwd}+{hops_rev}) hops)")
        finally:
            mb_pool.close()
    finally:
        cache.close()
    return {"fetches": st["ici_fetch_records"],
            "flushes": st["ici_flush_records"], "bytes": st["ici_bytes"],
            "link_fail_detour_hops": detour_hops,
            "detour_bytes": detour_bytes, "mb_scale_bytes": moved,
            "mb_link_bytes": link_delta, "hops_fwd": hops_fwd,
            "hops_rev": hops_rev, "payload": payload}


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """Run the dryrun over ``n_devices`` rank processes (all on one card
    when the machine has one), print JAX's ok line and return a summary:
    the loss, the mesh, each rank's record (times, peak memory, the flash
    kernel's launches inside Ulysses) and the native ICI counts."""
    device = resolve(device)
    # Read when the native engine first loads: the segment wants four arenas.
    os.environ.setdefault("TPUMEM_FAKE_TPU_COUNT", "4")
    dp, tp, sp = _mesh_shape(n_devices)
    t0 = time.perf_counter()
    ranks = pmesh.run_ranks(_dryrun_rank, n_devices,
                            (dp, tp, sp, device.type), device=device,
                            timeout_s=DRYRUN_TIMEOUT_S)
    t1 = time.perf_counter()
    ici_rec = _native_ici(device)
    t2 = time.perf_counter()
    r0 = ranks[0]
    print(f"dryrun_multichip(n={n_devices}) ok: loss={r0['loss']:.4f} "
          f"mesh=dp{dp}xtp{tp}xsp{sp} ring_attn={r0['ring_attn']} "
          f"native_ici: fetches={ici_rec['fetches']}"
          f" flushes={ici_rec['flushes']} bytes={ici_rec['bytes']}"
          f" link_fail_detour_hops={ici_rec['link_fail_detour_hops']}"
          f" detour_bytes={ici_rec['detour_bytes']}"
          f" mb_scale_bytes={ici_rec['mb_scale_bytes']}"
          f" mb_link_bytes={ici_rec['mb_link_bytes']}"
          f" (= {ici_rec['hops_fwd']}+{ici_rec['hops_rev']} hops x "
          f"{ici_rec['payload']})", flush=True)
    return {"loss": r0["loss"], "mesh": (dp, tp, sp), "ranks": ranks,
            "flash_launches": sum(r["flash_launches"] for r in ranks),
            "native_ici": ici_rec, "ranks_s": t1 - t0,
            "native_ici_s": t2 - t1}


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype)
