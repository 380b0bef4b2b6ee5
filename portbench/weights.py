"""Seeded weights of a Llama-family decoder, made on the device.

The layout is the port's ``params``: per-layer weights stacked along a
leading layer axis, stored ``[in, out]``.  Each leaf is drawn in one call, in
the type it is served in, by a generator on the device: a dozen calls for the
whole model.  The same tensors go to the program and to the reference.
"""

from __future__ import annotations

from typing import Dict

import torch

NORM_JITTER = 0.05   # norm weights are 1 + this * N(0, 1), so a norm is not a no-op


def shapes(m: Dict[str, int]) -> Dict[str, tuple]:
    """Leaf name -> (shape, fan_in); fan_in 0 marks a norm weight."""
    L, h, ffn = m["num_layers"], m["hidden_size"], m["intermediate_size"]
    q, kv = m["num_heads"] * m["head_dim"], m["num_kv_heads"] * m["head_dim"]
    return {
        "embed": ((m["vocab_size"], h), h),
        "layers.attn_norm": ((L, h), 0),
        "layers.wq": ((L, h, q), h),
        "layers.wk": ((L, h, kv), h),
        "layers.wv": ((L, h, kv), h),
        "layers.wo": ((L, q, h), q),
        "layers.mlp_norm": ((L, h), 0),
        "layers.w_gate": ((L, h, ffn), h),
        "layers.w_up": ((L, h, ffn), h),
        "layers.w_down": ((L, ffn, h), ffn),
        "final_norm": ((h,), 0),
        "lm_head": ((h, m["vocab_size"]), h),
    }


def _fill(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    t.normal_(generator=gen)
    if fan_in:
        t.mul_(fan_in ** -0.5)
    else:
        t.mul_(NORM_JITTER).add_(1.0)


def make(m: Dict[str, int], seed: int, device: torch.device,
         dtype: torch.dtype = torch.bfloat16) -> Dict[str, object]:
    """The model's weights from ``seed``, on ``device``."""
    params: Dict[str, object] = {"layers": {}}
    for name, (shape, _) in shapes(m).items():
        t = torch.empty(shape, dtype=dtype, device=device)
        if name.startswith("layers."):
            params["layers"][name.split(".", 1)[1]] = t
        else:
            params[name] = t
    refill(params, m, seed)
    return params


def refill(params: Dict[str, object], m: Dict[str, int], seed: int) -> None:
    """Draw every leaf of ``params`` anew from ``seed``, in place (the
    tensors the program holds stay the same objects)."""
    leaf = leaves(params)
    device = leaf["embed"].device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    for name, (_, fan_in) in shapes(m).items():
        _fill(leaf[name], fan_in, gen)


def leaves(params: Dict[str, object]) -> Dict[str, torch.Tensor]:
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update({f"layers.{k}": v for k, v in params["layers"].items()})
    return out

