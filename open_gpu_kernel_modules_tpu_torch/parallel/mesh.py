"""Device mesh, Megatron shards and the tensor-parallel forward on
``torch.distributed`` (port of the JAX ``parallel/mesh.py``).

JAX names a ``Mesh`` over dp/tp/sp, annotates the parameter pytree with
``NamedSharding`` and lets XLA derive the collectives.  Here every rank is a
process of one process group (``run_ranks`` starts them), holds only its own
shards, and the collectives XLA would insert are written out, Megatron-style
(``forward``):

- the embedding is split on the hidden dim: an all-gather over tp follows
  the lookup;
- wq/wk/wv/w_gate/w_up are column-parallel (local heads ``H/tp``, local kv
  heads ``KV/tp``), wo/w_down row-parallel: an all-reduce follows each;
- lm_head is split on its input dim: each rank's slice of the hidden dim
  gives partial logits, and an all-reduce sums them.

Autograd runs through the collectives by their conjugate pairs, each its own
``torch.autograd.Function``: identity forward and all-reduce backward in
front of a column-parallel product; all-reduce forward and identity backward
after a row-parallel one; all-gather forward and slice backward after the
embedding.  (``torch.distributed.nn.functional.all_reduce`` all-reduces the
gradient as well, which gives tp-fold gradients on replicated activations.)

Where tp exceeds the kv head count (JAX shards ``wk`` at tp=4 on tiny, whose
KV is 2), each rank keeps the kv heads its local query heads read (Megatron's
kv replication), and ``sync_grads`` sums the replicas' gradients.

The backend is fixed per device type (``BACKEND``).  One card holds every
rank on a one-card machine, and NCCL refuses two ranks of one communicator
on one device, so CUDA tensors go through gloo, which stages them through
the host for its collectives.  Compute stays on the ranks' device.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import DeviceLike, resolve
from ..models import llama

BACKEND = "cpu:gloo,cuda:gloo"
AXES = ("dp", "tp", "sp")
# Every collective of a rank fails after this long instead of hanging.
COLLECTIVE_TIMEOUT_S = 60


# ---------------------------------------------------------------- the ranks

def _rank_main(rank, world, init_method, device_type, call_path, results):
    # Each failure is stamped when it is caught, before the process group
    # goes down and fails the peers' collectives in turn.
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        if device_type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            BACKEND, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    except Exception:           # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc(), time.time()))
        return
    try:
        results.put((rank, True, fn(*args), 0.0))
    except Exception:
        results.put((rank, False, traceback.format_exc(), time.time()))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence = (),
              device: DeviceLike = None, timeout_s: float = 300.0,
              store_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``world_size`` spawned processes, each one rank
    of a process group on ``BACKEND`` (a file store in a temporary directory
    under ``store_dir``).  Returns each rank's result, by rank.

    ``fn`` must be a module-level function and its result picklable without
    torch's shared memory (numbers, numpy arrays).  ``fn`` and ``args`` go
    to the ranks through a file: a spawned child reads its start-up pipe
    only after importing, so large arguments there would start the ranks
    one after another.  CUDA ranks all use the
    card ``rank % device_count``.  Raises with the tracebacks of the ranks
    that failed, the first to fail first, and ``TimeoutError`` if the ranks
    have not all answered
    within ``timeout_s``; every rank process is gone when this returns."""
    import torch.multiprocessing as mp

    device_type = resolve(device).type
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        call_path = os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, init_method, device_type,
                                   call_path, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got: Dict[int, Any] = {}
        failed: Dict[int, tuple] = {}
        try:
            deadline = time.monotonic() + timeout_s
            while len(got) + len(failed) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    if failed:
                        break
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world_size)) - set(got))}"
                        f" did not answer within {timeout_s} s")
                try:
                    rank, ok, out, when = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and r not in failed
                            and p.exitcode is not None]
                    if dead and not failed:
                        raise RuntimeError(f"ranks {dead} exited without "
                                           "a result")
                    continue
                if ok:
                    got[rank] = out
                    continue
                # A failure's peers fail within moments (their connections
                # close) or wait out the collective timeout: gather for two
                # seconds, then report the first to fail first.
                failed[rank] = (when, out)
                deadline = min(deadline, time.monotonic() + 2.0)
        finally:
            grace = 10 if len(got) == world_size else 0
            for p in procs:
                p.join(timeout=grace)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed:
        raise RuntimeError("".join(
            f"rank {r} failed:\n{tb}" for r, (_, tb) in
            sorted(failed.items(), key=lambda item: item[1][0])))
    return [got[r] for r in range(world_size)]


# ----------------------------------------------------------------- the mesh

def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1,
              device: DeviceLike = None) -> DeviceMesh:
    """A ``DeviceMesh`` with dims ("dp", "tp", "sp") over the first
    ``dp*tp*sp`` ranks of the process group; surplus ranks are left out
    (their ``get_coordinate()`` is None).  Every rank must call it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call it in a "
                           "rank (run_ranks)")
    need, have = dp * tp * sp, dist.get_world_size()
    if have < need:
        raise ValueError(f"need {need} devices, have {have}")
    return DeviceMesh(resolve(device).type,
                      torch.arange(need).reshape(dp, tp, sp),
                      mesh_dim_names=AXES)


def llama_param_specs() -> Dict[str, Any]:
    """For each key of the stacked-layer Llama parameters, the dim that is
    split over tp, or None where the tensor is replicated (JAX's table:
    column-parallel wq/wk/wv/w_gate/w_up split their output features,
    row-parallel wo/w_down their input features, the embedding its hidden
    dim and lm_head its input dim; layers stay whole along dim 0)."""
    return {
        "embed": 1,
        "final_norm": None,
        "lm_head": 0,
        "layers": {
            "attn_norm": None,
            "mlp_norm": None,
            "wq": 2,
            "wk": 2,
            "wv": 2,
            "wo": 1,
            "w_gate": 2,
            "w_up": 2,
            "w_down": 1,
        },
    }


def _coord(mesh: DeviceMesh) -> Dict[str, int]:
    c = mesh.get_coordinate()
    if c is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(AXES, c))


def _size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def _kv_heads(cfg: llama.LlamaConfig, tp: int, r: int) -> range:
    """The kv heads tp rank ``r`` holds: its even share where tp divides
    KV; where KV divides tp, the one kv head its local query heads read."""
    kv = cfg.num_kv_heads
    if cfg.num_heads % tp:
        raise ValueError(f"tp={tp} does not divide num_heads "
                         f"{cfg.num_heads}")
    if kv % tp == 0:
        return range(r * kv // tp, (r + 1) * kv // tp)
    if tp % kv == 0:
        first = r // (tp // kv)
        return range(first, first + 1)
    raise ValueError(f"tp={tp} and num_kv_heads={kv}: neither divides the "
                     "other")


def _local(x: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"{n} ways")
    step = x.shape[dim] // n
    return x.narrow(dim, r * step, step).contiguous()


def shard_params(params: Dict[str, Any], mesh: DeviceMesh,
                 cfg: llama.LlamaConfig) -> Dict[str, Any]:
    """This rank's shards of ``params`` (llama_param_specs over tp; dp and
    sp hold replicas).  wk/wv keep whole kv heads (``_kv_heads``)."""
    tp, r = _size(mesh, "tp"), _coord(mesh)["tp"]
    specs = llama_param_specs()

    def cut(key, x, dim):
        if dim is None:
            return x.contiguous()
        if key in ("wk", "wv"):
            heads = _kv_heads(cfg, tp, r)
            return x[..., heads.start * cfg.head_dim:
                     heads.stop * cfg.head_dim].contiguous()
        return _local(x, dim, tp, r)

    out = {k: cut(k, params[k], specs[k])
           for k in ("embed", "final_norm", "lm_head")}
    out["layers"] = {k: cut(k, v, specs["layers"][k])
                     for k, v in params["layers"].items()}
    return out


def data_sharding(mesh: DeviceMesh) -> Callable[[torch.Tensor],
                                                torch.Tensor]:
    """A function that takes this rank's dp slice of the batch (dim 0) and
    sp slice of the sequence (dim 1) of a global tensor."""
    c = _coord(mesh)

    def take(x: torch.Tensor) -> torch.Tensor:
        x = _local(x, 0, _size(mesh, "dp"), c["dp"])
        return _local(x, 1, _size(mesh, "sp"), c["sp"])
    return take


# ---------------------------------------------- collectives with autograd

class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward (in front of a column-parallel
    product: each rank's input gradient is partial)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward (after a row-parallel product:
    the summed output is replicated, and so is its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along the last dim forward, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n, ctx.r = dist.get_world_size(group), dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(ctx.n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=-1)[ctx.r].contiguous(), None


# --------------------------------------------- the tensor-parallel forward

def _tp_layer(cfg, x, lp, cos, sin, mask, group, heads, kv_heads):
    b, s, _ = x.shape
    hd = cfg.head_dim
    attn_in = _CopyToGroup.apply(
        llama.rms_norm(x, lp["attn_norm"], cfg.rms_eps), group)
    q = (attn_in @ lp["wq"]).reshape(b, s, heads, hd)
    k = (attn_in @ lp["wk"]).reshape(b, s, kv_heads, hd)
    v = (attn_in @ lp["wv"]).reshape(b, s, kv_heads, hd)
    q = llama.apply_rope(q, cos, sin)
    k = llama.apply_rope(k, cos, sin)
    k = llama.repeat_kv(k, heads // kv_heads)
    v = llama.repeat_kv(v, heads // kv_heads)
    out = llama.attention(q, k, v, mask).reshape(b, s, heads * hd)
    x = x + _ReduceFromGroup.apply(out @ lp["wo"], group)

    mlp_in = _CopyToGroup.apply(
        llama.rms_norm(x, lp["mlp_norm"], cfg.rms_eps), group)
    gate = torch.nn.functional.silu(
        (mlp_in @ lp["w_gate"]).float()).to(x.dtype)
    return x + _ReduceFromGroup.apply(
        (gate * (mlp_in @ lp["w_up"])) @ lp["w_down"], group)


def forward(cfg: llama.LlamaConfig, local: Dict[str, Any],
            tokens: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``llama.forward`` (plain attention) on this rank's shards
    (``shard_params``): logits [B, S, V] in fp32, the same on every tp rank
    of the mesh, for this rank's ``tokens``."""
    tp, r = _size(mesh, "tp"), _coord(mesh)["tp"]
    group = mesh.get_group("tp")
    heads = cfg.num_heads // tp
    kv_heads = len(_kv_heads(cfg, tp, r))
    b, s = tokens.shape
    x = _GatherFromGroup.apply(local["embed"][tokens], group)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    cos, sin = llama.rope_table(cfg, positions)
    mask = llama.causal_mask(s, s, device=tokens.device)
    for lp in llama.layers(local):
        x = _tp_layer(cfg, x, lp, cos, sin, mask, group, heads, kv_heads)
    xn = _CopyToGroup.apply(
        llama.rms_norm(x, local["final_norm"], cfg.rms_eps), group)
    part = _local(xn, 2, tp, r) @ local["lm_head"]
    return _ReduceFromGroup.apply(part, group).float()


def loss_fn(cfg: llama.LlamaConfig, local: Dict[str, Any],
            tokens: torch.Tensor, targets: torch.Tensor,
            mesh: DeviceMesh) -> torch.Tensor:
    """``llama.loss_fn`` over the tensor-parallel ``forward``: this rank's
    mean next-token loss over its own batch rows."""
    logp = torch.log_softmax(forward(cfg, local, tokens, mesh), dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0].mean()


def batch_rows(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's dp slice of the batch (dim 0) of a global tensor."""
    return _local(x, 0, _size(mesh, "dp"), _coord(mesh)["dp"])


def sync_grads(cfg: llama.LlamaConfig, grads: Dict[str, Any],
               mesh: DeviceMesh) -> None:
    """In place: the gradients of the local loss become those of the
    global batch mean (the mean over dp), and kv-head replicas (tp above
    KV) get the sum over the tp ranks that share their head."""
    tp, r = _size(mesh, "tp"), _coord(mesh)["tp"]
    if tp > cfg.num_kv_heads:
        heads = _kv_heads(cfg, tp, r)
        cols = slice(heads.start * cfg.head_dim, heads.stop * cfg.head_dim)
        for key in ("wk", "wv"):
            g = grads["layers"][key]
            full = g.new_zeros(g.shape[:-1] +
                               (cfg.num_kv_heads * cfg.head_dim,))
            full[..., cols] = g
            dist.all_reduce(full, group=mesh.get_group("tp"))
            g.copy_(full[..., cols])
    dp = _size(mesh, "dp")
    if dp > 1:
        for g in llama.tree_leaves(grads):
            dist.all_reduce(g, group=mesh.get_group("dp"))
            g.div_(dp)
