"""Ring attention: sequence-parallel exact attention over the sp group
(port of the JAX ``parallel/ring_attention.py``).

Each rank holds a Q/K/V shard of S/n tokens.  The K/V shards travel round
the ring (rank j sends to j+1) while every rank folds each visiting block
into a running online-softmax state in fp32, so memory stays O(S/n) and the
result is exact.  Causal masking uses global positions, from the rank's
place in the group.  As in JAX this is plain tensor math: no kernel.

A hop of a CUDA tensor over gloo goes through the host: gloo's send and
receive hand the raw pointer to its transport, which reads host memory
only.  The attention itself stays on the tensors' device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import data_sharding

NEG_INF = -1e30


def _block_attend(q, k, v, q_pos, k_pos, causal, scale):
    """Partial attention of local q against one visiting K/V block:
    (m, l, acc) = rowmax [B,H,Sq,1], rowsum [B,H,Sq,1], unnormalised output
    [B,Sq,H,D], all fp32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = k_pos[None, None, None, :] <= q_pos[None, None, :, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m, l, acc


def _ring_hop(x: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``ppermute`` j -> j+1 over ``group``: send ``x`` to the next
    rank and return the previous rank's."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    # CUDA tensors go over gloo too (mesh.BACKEND), through the host.
    send = x.cpu() if x.is_cuda else x.contiguous()
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send,
                   dist.get_global_rank(group, (idx + 1) % n), group),
        dist.P2POp(dist.irecv, recv,
                   dist.get_global_rank(group, (idx - 1) % n), group)])
    for w in works:
        w.wait()
    return recv.to(x.device)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = True) -> torch.Tensor:
    """q,k,v: this rank's shards [B, S_local, H, D] of a sequence split in
    group order over ``group`` (the sp group).  Returns the local output
    shard [B, S_local, H, D] in q.dtype."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    b, s_local, h, d = q.shape
    scale = 1.0 / d ** 0.5
    ar = torch.arange(s_local, device=q.device)
    q_pos = idx * s_local + ar

    def merge(state, kc, vc, i):
        m, l, acc = state
        # After i hops this rank holds the shard first on (idx - i) mod n.
        k_pos = ((idx - i) % n) * s_local + ar
        bm, bl, bacc = _block_attend(q, kc, vc, q_pos, k_pos, causal, scale)
        m_new = torch.maximum(m, bm)
        c_old = torch.exp(m - m_new)
        c_blk = torch.exp(bm - m_new)
        l = l * c_old + bl * c_blk
        # The carries are [B,H,S,1] and acc [B,S,H,D]: align the axes.
        acc = acc * c_old.transpose(1, 2) + bacc * c_blk.transpose(1, 2)
        return m_new, l, acc

    # Hop 0 is the local shard, with no transfer; then exactly n-1 hops.
    state = (torch.full((b, h, s_local, 1), NEG_INF, device=q.device),
             torch.zeros((b, h, s_local, 1), device=q.device),
             torch.zeros((b, s_local, h, d), device=q.device))
    state = merge(state, k, v, 0)
    kc, vc = k, v
    for i in range(1, n):
        kc, vc = _ring_hop(kc, group), _ring_hop(vc, group)
        state = merge(state, kc, vc, i)
    _, l, acc = state
    l = torch.where(l == 0.0, torch.ones_like(l), l)    # fully masked rows
    return (acc / l.transpose(1, 2)).to(q.dtype)


def gather_global(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The global tensor from every rank's (dp, sp) shard of it (dim 0 over
    dp, dim 1 over sp), on every rank."""
    for axis, dim in (("sp", 1), ("dp", 0)):
        group = mesh.get_group(axis)
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        x = torch.cat(parts, dim=dim)
    return x


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh: DeviceMesh,
                           causal: bool = True) -> torch.Tensor:
    """q,k,v: GLOBAL [B, S, H, D] on every rank.  Runs ``ring_attention``
    on this rank's (dp, sp) shard over the mesh's sp group and returns the
    global output, gathered on every rank."""
    take = data_sharding(mesh)
    out = ring_attention(take(q), take(k), take(v), mesh.get_group("sp"),
                         causal=causal)
    return gather_global(out, mesh)
