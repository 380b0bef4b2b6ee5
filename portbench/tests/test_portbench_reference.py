"""The plain reference against an independent dense forward, at a tiny
size with seeded weights, on the CPU."""

import math

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference import mistral

M = {"vocab_size": 97, "hidden_size": 48, "intermediate_size": 80,
     "num_layers": 3, "num_heads": 6, "num_kv_heads": 2, "head_dim": 16,
     "rope_theta": 1e6, "rms_eps": 1e-5}


def dense(m, p, tokens):
    """Whole-sequence forward in float64 with SDPA and full rotary
    tables: another formulation of the same published equations."""
    d = torch.float64
    s = tokens.shape[0]
    nh, nkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    x = p["embed"][tokens].to(d)

    def norm(x, w):
        return x / torch.sqrt((x * x).mean(-1, keepdim=True) + m["rms_eps"]) \
            * w.to(d)

    inv = m["rope_theta"] ** (-torch.arange(0, hd, 2, dtype=d) / hd)
    ang = torch.arange(s, dtype=d)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], -1)

    def rope(t):
        half = t.shape[-1] // 2
        rot = torch.cat([-t[..., half:], t[..., :half]], -1)
        return t * ang.cos()[:, None] + rot * ang.sin()[:, None]

    L = p["layers"]
    for i in range(m["num_layers"]):
        h = norm(x, L["attn_norm"][i])
        q = rope((h @ L["wq"][i].to(d)).view(s, nh, hd)).transpose(0, 1)
        k = rope((h @ L["wk"][i].to(d)).view(s, nkv, hd)).transpose(0, 1)
        v = (h @ L["wv"][i].to(d)).view(s, nkv, hd).transpose(0, 1)
        k = k.repeat_interleave(nh // nkv, 0)
        v = v.repeat_interleave(nh // nkv, 0)
        a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + a.transpose(0, 1).reshape(s, nh * hd) @ L["wo"][i].to(d)
        h = norm(x, L["mlp_norm"][i])
        x = x + (F.silu(h @ L["w_gate"][i].to(d)) * (h @ L["w_up"][i].to(d))
                 ) @ L["w_down"][i].to(d)
    return norm(x, p["final_norm"]) @ p["lm_head"].to(d)


def test_reference_matches_a_dense_forward():
    p = weights.make(M, seed=2 ** 31 + 3, device=torch.device("cpu"),
                     dtype=torch.float32)
    tokens = torch.randint(0, M["vocab_size"], (37,),
                           generator=torch.Generator().manual_seed(1))
    want = dense(M, p, tokens)
    pos = [0, 5, 17, 36]
    # blocks smaller than the sequence, so the blocked attention is held
    got = mistral.logits_at(M, p, tokens, pos, block=8)
    assert torch.allclose(got.double(), want[pos], rtol=1e-4, atol=1e-4)
    whole = mistral.logits_at(M, p, tokens, pos, block=64)
    assert torch.allclose(got, whole, rtol=1e-5, atol=1e-5)


def test_fp8_control_departs_from_the_reference():
    p = weights.make(M, seed=11, device=torch.device("cpu"))
    tokens = torch.randint(0, M["vocab_size"], (20,),
                           generator=torch.Generator().manual_seed(2))
    ref = mistral.logits_at(M, p, tokens, range(20))
    low = mistral.logits_at(M, p, tokens, range(20), quant="fp8")
    err = (low - ref).abs().max().item()
    assert 1e-3 < err < 0.5 * ref.abs().max().item()
    assert not math.isnan(err)
