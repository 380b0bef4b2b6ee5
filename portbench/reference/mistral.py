"""Mistral decoder in plain float32 PyTorch, computed in blocks.

The published architecture (Mistral-7B, Mistral-NeMo): token embedding;
per layer a pre-norm (RMSNorm) grouped-query causal self-attention with
rotary position embedding (rotate-half form, base ``rope_theta``) and a
pre-norm SwiGLU MLP, each added to the residual stream; a final RMSNorm and
an untied output head.  No sliding window (both configurations set none).
Weights come in the benchmark's layout (``portbench.weights``): stacked per
layer, stored ``[in, out]``.

Everything runs in float32 with TF32 off.  Weights are widened one layer at
a time, and attention runs over blocks of query rows, so the largest
transient is one layer's weights or one block's scores.

``quant="fp8"`` is the control: every matrix weight rounded to float8 e4m3
with a scale per output column (per row for the embedding), the precision
below the bfloat16 the configurations state.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

FP8_MAX = 448.0


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(w: torch.Tensor, dim: int) -> torch.Tensor:
    """``w`` (float32) rounded to e4m3 with one scale per slice along
    ``dim``'s complement: ``dim`` is the axis the absmax runs over."""
    s = w.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (w / s).to(torch.float8_e4m3fn).float() * s


def _widen(w: torch.Tensor, quant: Optional[str], dim: int = 0
           ) -> torch.Tensor:
    w = w.float()
    if quant == "fp8":
        return _fp8(w, dim)
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    """x [S, H, D]; cos, sin [S, D/2]: rotate the halves of D."""
    a, b = x.chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               block: int) -> torch.Tensor:
    """Causal GQA attention.  q [S, H, D], k, v [S, KV, D] -> [S, H*D]."""
    s, h, d = q.shape
    kv = k.shape[1]
    rep = h // kv
    qg = q.reshape(s, kv, rep, d).permute(1, 2, 0, 3)      # [KV, rep, S, D]
    kg = k.permute(1, 0, 2)                                 # [KV, S, D]
    vg = v.permute(1, 0, 2)
    out = torch.empty((kv, rep, s, d), dtype=q.dtype, device=q.device)
    scale = d ** -0.5
    for a in range(0, s, block):
        b = min(s, a + block)
        scores = torch.einsum("grqd,gkd->grqk", qg[:, :, a:b], kg[:, :b])
        scores = scores * scale
        qi = torch.arange(a, b, device=q.device)[:, None]
        ki = torch.arange(b, device=q.device)[None, :]
        scores = scores.masked_fill(ki > qi, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        out[:, :, a:b] = torch.einsum("grqk,gkd->grqd", p, vg[:, :b])
    return out.permute(2, 0, 1, 3).reshape(s, h * d)


def logits_at(m: Dict[str, object], params: Dict[str, object],
              tokens: torch.Tensor, positions: Sequence[int],
              quant: Optional[str] = None, block: int = 512
              ) -> torch.Tensor:
    """float32 logits [len(positions), vocab] of one sequence ``tokens``
    [S] at ``positions`` (each position's logits predict the next token).

    ``m`` holds the sizes (``hidden_size``, ``num_layers``, ``num_heads``,
    ``num_kv_heads``, ``head_dim``, ``rope_theta``, ``rms_eps``)."""
    _no_tf32()
    tokens = tokens.reshape(-1).long()
    s = tokens.shape[0]
    dev = tokens.device
    nh, nkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    eps = m["rms_eps"]
    lay = params["layers"]

    emb = params["embed"]
    if quant is None:
        x = emb[tokens].float()
    else:
        x = _widen(emb[tokens], quant, dim=1)
    inv = 1.0 / (m["rope_theta"] ** (torch.arange(
        0, hd, 2, dtype=torch.float64, device=dev) / hd))
    ang = torch.arange(s, dtype=torch.float64, device=dev)[:, None] * inv
    cos, sin = ang.cos().float(), ang.sin().float()

    for i in range(m["num_layers"]):
        h = _rms(x, lay["attn_norm"][i], eps)
        q = (h @ _widen(lay["wq"][i], quant)).reshape(s, nh, hd)
        k = (h @ _widen(lay["wk"][i], quant)).reshape(s, nkv, hd)
        v = (h @ _widen(lay["wv"][i], quant)).reshape(s, nkv, hd)
        del h
        att = _attention(_rope(q, cos, sin), _rope(k, cos, sin), v, block)
        del q, k, v
        x = x + att @ _widen(lay["wo"][i], quant)
        del att
        h = _rms(x, lay["mlp_norm"][i], eps)
        g = torch.nn.functional.silu(h @ _widen(lay["w_gate"][i], quant))
        g = g * (h @ _widen(lay["w_up"][i], quant))
        del h
        x = x + g @ _widen(lay["w_down"][i], quant)
        del g
    pos = torch.as_tensor(list(positions), device=dev, dtype=torch.long)
    h = _rms(x[pos], params["final_norm"], eps)
    return h @ _widen(params["lm_head"], quant)
