"""Paged decode attention: the CUDA kernel for Hopper and its plain version.

Port of the JAX ``ops/paged_attention.py``: single-token GQA decode
attention where each sequence's KV cache is a list of fixed-size pages in a
shared pool.  ``paged_attention`` launches ``csrc/paged_decode.cu`` (which
replaces the TPU kernel ``_paged_decode_kernel``) on a CUDA tensor, always:
the TPU's gates (``kv*d % 128``, an 8 MB pool, a TPU backend) do not carry
over.  On a CPU tensor it runs ``paged_attention_reference``, the jnp
fallback's arithmetic.  There is no fallback on CUDA: only the caller's
explicit ``impl="jnp"`` runs the plain version there.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import LOG2_E

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448   # bytes of shared memory one CTA may use on Hopper


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, page_table: torch.Tensor,
                              seq_lens: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """Gather each sequence's pages, expand GQA heads, masked softmax in
    fp32.  Rows with ``seq_lens == 0`` give zeros, not NaN.  Page ids are
    clamped to the pool, as JAX clamps an out-of-range gather."""
    b, h, d = q.shape
    n, p, kv, _ = k_pages.shape
    m = page_table.shape[1]
    table = page_table.long().clamp(0, n - 1)
    k = k_pages[table].reshape(b, m * p, kv, d)
    v = v_pages[table].reshape(b, m * p, kv, d)
    rep = num_heads // kv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)

    scale = 1.0 / d ** 0.5
    logits = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * scale
    mask = (torch.arange(m * p, device=q.device)[None, :]
            < seq_lens.to(q.device)[:, None])                       # [B, S]
    logits = logits.masked_fill(~mask[:, None, :], -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask[:, None, :], probs, torch.zeros_like(probs))
    out = torch.einsum("bhs,bshd->bhd", probs, v.float())
    return out.to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, num_heads: int,
                    impl: str = "auto") -> torch.Tensor:
    """Single-token decode attention.

    q:          [B, H, D]      query for the next position
    k_pages:    [N, P, KV, D]  shared page pool (N pages of P tokens)
    v_pages:    [N, P, KV, D]
    page_table: [B, M]         page indices per sequence (int32)
    seq_lens:   [B]            current length per sequence (int32)
    impl:       "auto" or "kernel" launch the kernel on a CUDA tensor;
                "jnp" (JAX's name for its plain path) asks for the plain
                version on any device
    Returns [B, H, D].
    """
    if impl not in ("auto", "kernel", "jnp"):
        raise ValueError(f"impl must be 'auto', 'kernel' or 'jnp', got "
                         f"{impl!r}")
    if impl == "jnp" or q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         seq_lens, num_heads)
    return _paged_cuda(q, k_pages, v_pages, page_table, seq_lens, num_heads)


def _paged_cuda(q, k_pages, v_pages, page_table, seq_lens, num_heads):
    b, h, d = q.shape
    n, p, kv, _ = k_pages.shape
    m = page_table.shape[1]
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"{name} must be on q's CUDA device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("k_pages and v_pages must be 16-byte aligned")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(f"q, k_pages, v_pages must share one dtype in "
                        f"{list(_DTYPES)}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("page_table and seq_lens must be int32")
    if h != num_heads or h % kv or v_pages.shape != k_pages.shape or \
            k_pages.shape[3] != d or page_table.shape[0] != b or \
            seq_lens.shape != (b,):
        raise ValueError(
            f"shapes do not agree: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}, table {tuple(page_table.shape)}, "
            f"seq_lens {tuple(seq_lens.shape)}, num_heads {num_heads}")
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"head_dim {d} must be a multiple of 8 up to 256")
    lib = _build.load("paged_decode")
    # Tokens per shared-memory chunk: 64, or 32 for rows wider than 512 B,
    # so the double-buffered K/V chunks stay near 135 KB.
    tk = 64 if d * q.element_size() <= 512 else 32
    lib.paged_decode_smem_bytes.restype = ctypes.c_int
    lib.paged_decode_smem_bytes.argtypes = [ctypes.c_int] * 4
    smem = lib.paged_decode_smem_bytes(tk, h // kv, d, q.element_size())
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{h // kv} query heads per kv head at head_dim {d} "
                         f"need {smem} bytes of shared memory")

    # Q pre-scaled by log2(e)/sqrt(D) and rounded to q.dtype, as the TPU
    # wrapper does; the kernel's softmax is base-2.
    qf = (q.float() * (LOG2_E / d ** 0.5)).to(q.dtype)
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = lib.paged_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(qf.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
                 b, h, kv, d, n, p, m, tk, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0   # kernel launches since the last reset
