"""The yardstick: the card's published peaks, a model's operations per
token and B1's bytes per call, from shapes alone.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates: 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Dict, Iterable

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def matmul_flops_per_token(m: Dict[str, int]) -> int:
    """2 x the weights every token meets in the decoder's matmuls."""
    h, ffn = m["hidden_size"], m["intermediate_size"]
    q, kv = m["num_heads"] * m["head_dim"], m["num_kv_heads"] * m["head_dim"]
    per_layer = h * q + 2 * h * kv + q * h + 3 * h * ffn
    return 2 * m["num_layers"] * per_layer


def head_flops(m: Dict[str, int]) -> int:
    """The output head, once for each token whose logits are used."""
    return 2 * m["hidden_size"] * m["vocab_size"]


def attention_flops(m: Dict[str, int], context: int) -> int:
    """QK and PV of one query over ``context`` keys, every layer."""
    return 4 * context * m["num_heads"] * m["head_dim"] * m["num_layers"]


def prefill_flops(m: Dict[str, int], s: int) -> int:
    """A prompt of ``s`` tokens: every token's matmuls, causal attention
    (query i over i + 1 keys), and the head at the last token."""
    causal = s * (s + 1) // 2
    return (s * matmul_flops_per_token(m) + head_flops(m) +
            4 * causal * m["num_heads"] * m["head_dim"] * m["num_layers"])


def decode_flops(m: Dict[str, int], contexts: Iterable[int]) -> int:
    """One decoded token per context (its length with the new token)."""
    per = matmul_flops_per_token(m) + head_flops(m)
    return sum(per + attention_flops(m, c) for c in contexts)


def b1_bytes(m: Dict[str, int], contexts: Iterable[int],
             elem_bytes: int = 2) -> int:
    """One B1 call (one layer of one decode step) over sequences of these
    lengths: the live K and V of each, and q and the output, each once."""
    kv_row = 2 * m["num_kv_heads"] * m["head_dim"] * elem_bytes
    qo = 2 * m["num_heads"] * m["head_dim"] * elem_bytes
    return sum(c * kv_row + qo for c in contexts)
