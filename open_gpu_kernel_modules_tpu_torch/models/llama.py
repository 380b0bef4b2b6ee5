"""Llama-family decoder in plain PyTorch (port of the JAX ``models/llama.py``).

Parameters are a dict of tensors in the JAX package's layout: per-layer
weights are stacked along a leading ``num_layers`` axis, and the decoder is a
Python loop over that axis where JAX runs ``lax.scan``.  Weights are stored
``[in, out]`` and applied as ``x @ w``, as in JAX.

- bfloat16 parameters and activations by default; logits come out in fp32.
- GQA: query head ``h`` reads kv head ``h // (num_heads // num_kv_heads)``.
- RoPE rotates split halves of the head dimension, not interleaved pairs.
- ``forward(use_flash=True)`` swaps the plain attention for the flash
  kernel (``ops.flash_attention``), the prefill path on the card.
- ``loss_fn`` is the training objective.  Its gradient is plain autograd
  through ``forward``: the parameters may carry ``requires_grad``, and
  ``layers`` hands out views, so gradients reach the stacked leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve
from ..ops.flash_attention import flash_attention

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(hidden_size=8192, intermediate_size=28672,
                           num_layers=80, num_heads=64, num_kv_heads=8)

    @staticmethod
    def tiny(vocab_size: int = 256, max_seq_len: int = 128) -> "LlamaConfig":
        """Test-sized config: same topology, toy dims."""
        return LlamaConfig(vocab_size=vocab_size, hidden_size=64,
                           intermediate_size=128, num_layers=2, num_heads=4,
                           num_kv_heads=2, head_dim=16, max_seq_len=max_seq_len,
                           rope_theta=10000.0)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random parameters: fp32 normals scaled by 1/sqrt(fan_in), cast to
    ``cfg.dtype``.

    ``generator`` must live on ``device`` (a CUDA generator for the card), so
    full-width weights are drawn where they are used.  Stacked layers are
    drawn one layer at a time, which bounds the fp32 scratch to one layer.
    """
    device = resolve(device)
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = cfg.num_layers

    def w(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * (1.0 / fan_in ** 0.5)).to(cfg.dtype)

    def stacked(shape, fan_in):
        out = torch.empty((L,) + shape, dtype=cfg.dtype, device=device)
        for i in range(L):
            out[i] = w(shape, fan_in)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    return {
        "embed": w((cfg.vocab_size, h), h),
        "layers": {
            "attn_norm": ones((L, h)),
            "wq": stacked((h, nh * hd), h),
            "wk": stacked((h, nkv * hd), h),
            "wv": stacked((h, nkv * hd), h),
            "wo": stacked((nh * hd, h), nh * hd),
            "mlp_norm": ones((L, h)),
            "w_gate": stacked((h, ffn), h),
            "w_up": stacked((h, ffn), h),
            "w_down": stacked((ffn, h), ffn),
        },
        "final_norm": ones((h,)),
        "lm_head": w((h, cfg.vocab_size), h),
    }


def layers(params: Params) -> List[Dict[str, torch.Tensor]]:
    """Each layer's slice of the stacked layer tensors (views, no copy).

    One ``unbind`` of each stacked tensor, whose backward stacks the
    layers' gradients into the leaf at once; indexing layer by layer would
    make each layer's backward add a zero-filled [L, ...] gradient into the
    leaf, L^2 layers' worth of bytes a step."""
    names = list(params["layers"])
    return [dict(zip(names, views)) for views in
            zip(*(params["layers"][k].unbind(0) for k in names))]


def tree_map(fn, *trees):
    """``fn`` over the leaves of parameter trees of one structure (nested
    dicts), leaf by leaf, into a tree of that structure."""
    return {k: tree_map(fn, *(t[k] for t in trees))
            if isinstance(trees[0][k], dict) else fn(*(t[k] for t in trees))
            for k in trees[0]}


def tree_leaves(tree):
    """The leaves of a parameter tree, in ``tree_map``'s order."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dtype)


def rope_table(cfg: LlamaConfig, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given positions [..., seq] -> [..., seq, d/2]."""
    d = cfg.head_dim
    exps = torch.arange(0, d, 2, dtype=torch.float32,
                        device=positions.device) / d
    inv_freq = 1.0 / (cfg.rope_theta ** exps)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [B, S, D/2] (or broadcastable)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, KV*n_rep, D] (GQA head expansion)."""
    if n_rep == 1:
        return x
    b, s, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain attention. q,k,v: [B, S, H, D]; mask broadcast to
    [B, H, Sq, Sk] with -inf at masked positions."""
    scale = 1.0 / q.shape[-1] ** 0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def mlp(cfg: LlamaConfig, x: torch.Tensor,
        lp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Residual SwiGLU block: SiLU in fp32, then cast."""
    mlp_in = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    gate = F.silu((mlp_in @ lp["w_gate"]).float()).to(x.dtype)
    return x + ((gate * (mlp_in @ lp["w_up"])) @ lp["w_down"])


def _layer(cfg: LlamaConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
           cos: torch.Tensor, sin: torch.Tensor, mask: Optional[torch.Tensor],
           kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           cache_pos: int = 0, use_flash: bool = False) -> torch.Tensor:
    """One decoder layer.  With ``kv_cache`` ([B, Smax, KV, D] views) this
    chunk's K/V are written into it IN PLACE at ``cache_pos`` and attention
    runs over the whole cache span."""
    b, s, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    attn_in = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = (attn_in @ lp["wq"]).reshape(b, s, nh, hd)
    k = (attn_in @ lp["wk"]).reshape(b, s, nkv, hd)
    v = (attn_in @ lp["wv"]).reshape(b, s, nkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if kv_cache is not None:
        ck, cv = kv_cache
        ck[:, cache_pos:cache_pos + s] = k
        cv[:, cache_pos:cache_pos + s] = v
        k, v = ck, cv

    k = repeat_kv(k, nh // nkv)
    v = repeat_kv(v, nh // nkv)
    if use_flash and kv_cache is None:
        out = flash_attention(q, k, v, causal=True).reshape(b, s, nh * hd)
    else:
        out = attention(q, k, v, mask).reshape(b, s, nh * hd)
    x = x + out @ lp["wo"]
    return mlp(cfg, x, lp)


def causal_mask(sq: int, sk: int, offset: int = 0,
                device: DeviceLike = None) -> torch.Tensor:
    """[1, 1, Sq, Sk] additive mask; query i attends keys <= i+offset."""
    device = resolve(device)
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(sk, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ki <= qi, zero, -torch.inf)[None, None]


def final_logits(cfg: LlamaConfig, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return (x @ params["lm_head"]).float()


def forward(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
            use_flash: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits [B, S, V] (fp32).

    ``use_flash`` swaps the plain attention for the flash kernel
    (``ops.flash_attention``) — the prefill path on the card."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    cos, sin = rope_table(cfg, positions)
    mask = None if use_flash else causal_mask(s, s, device=tokens.device)
    for lp in layers(params):
        x = _layer(cfg, x, lp, cos, sin, mask, use_flash=use_flash)
    return final_logits(cfg, params, x)


def init_kv_cache(cfg: LlamaConfig, batch: int, device: DeviceLike = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked per-layer KV cache [L, B, Smax, KV, D]."""
    device = resolve(device)
    shape = (cfg.num_layers, batch, cfg.max_seq_len, cfg.num_kv_heads,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def forward_with_cache(cfg: LlamaConfig, params: Params,
                       tokens: torch.Tensor,
                       kv: Tuple[torch.Tensor, torch.Tensor], pos: int
                       ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """Decode/prefill step writing into a fixed KV cache at ``pos``.

    tokens: [B, S] chunk; pos: start position.  Returns (logits [B, S, V],
    kv).  Unlike JAX, the cache tensors are updated in place (no second
    copy of the cache) and returned for symmetry."""
    b, s = tokens.shape
    device = tokens.device
    x = params["embed"][tokens]
    positions = torch.arange(s, device=device)[None, :].expand(b, s) + pos
    cos, sin = rope_table(cfg, positions)
    # Mask over the cache span (taken from the cache shape, so callers can
    # pass right-sized caches): key j visible iff j <= pos + i.
    smax = kv[0].shape[2]
    mask = causal_mask(s, smax, offset=pos, device=device)
    for i, lp in enumerate(layers(params)):
        x = _layer(cfg, x, lp, cos, sin, mask, (kv[0][i], kv[1][i]), pos)
    return final_logits(cfg, params, x), kv


def loss_fn(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy (the dryrun's training objective): fp32
    ``log_softmax`` over ``forward``'s logits (plain attention, as JAX),
    the targets' log-probabilities gathered, their mean negated."""
    logp = torch.log_softmax(forward(cfg, params, tokens), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    return nll.mean()
