"""Ulysses sequence parallelism: all-to-all head/sequence reshard (port of
the JAX ``parallel/ulysses.py``).

Inputs arrive sequence-sharded over the sp group.  One
``all_to_all_single`` reshards them to head-sharded with the full sequence
local, the port's ``ops.flash_attention`` runs on that (on a CUDA tensor the
hand-written kernel ``csrc/flash_attn.cu``, B2; on the CPU its plain
version), and a second ``all_to_all_single`` restores sequence sharding.
Two collectives per call whatever the sequence length, against ring
attention's n-1 hops, at the cost of needing heads % n == 0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import flash_attention
from .mesh import data_sharding
from .ring_attention import gather_global


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x: [n, ...]; block j goes to rank j, and block j of the result came
    from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, causal: bool = True) -> torch.Tensor:
    """q,k,v: this rank's shards [B, S/n, H, D] of a sequence split in group
    order over ``group`` (the sp group).  Returns the same local sharding.
    Needs H % n == 0."""
    n = dist.get_world_size(group)
    b, s_local, h, d = q.shape
    if h % n != 0:
        raise ValueError(f"the sp axis size ({n}) must divide "
                         f"the head count ({h}) for all-to-all sequence "
                         f"parallelism")

    # Sequence -> heads: head group j goes to rank j; the sequence chunks
    # arrive in rank order, which is global sequence order.
    def seq_to_head(x):
        x = x.reshape(b, s_local, n, h // n, d).permute(2, 0, 1, 3, 4)
        x = _all_to_all(x, group)                   # [n, B, S/n, H/n, D]
        return x.permute(1, 0, 2, 3, 4).reshape(b, n * s_local, h // n, d)

    out = flash_attention(seq_to_head(q), seq_to_head(k), seq_to_head(v),
                          causal=causal)          # [B, S, H/n, D]

    # Heads -> sequence: sequence chunk j goes back to rank j, and the head
    # groups arrive in rank order.
    o = out.reshape(b, n, s_local, h // n, d).permute(1, 0, 2, 3, 4)
    o = _all_to_all(o, group)                       # [n, B, S/n, H/n, D]
    return o.permute(1, 2, 0, 3, 4).reshape(b, s_local, h, d).to(q.dtype)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mesh: DeviceMesh,
                              causal: bool = True) -> torch.Tensor:
    """q,k,v: GLOBAL [B, S, H, D] on every rank.  Runs
    ``ulysses_attention`` on this rank's (dp, sp) shard over the mesh's sp
    group and returns the global output, gathered on every rank."""
    take = data_sharding(mesh)
    out = ulysses_attention(take(q), take(k), take(v), mesh.get_group("sp"),
                            causal=causal)
    return gather_global(out, mesh)
