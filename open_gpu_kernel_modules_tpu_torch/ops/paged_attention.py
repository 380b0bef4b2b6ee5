"""Paged decode attention: the CUDA kernel for Hopper and its plain version.

Port of the JAX ``ops/paged_attention.py``: single-token GQA decode
attention where each sequence's KV cache is a list of fixed-size pages in a
shared pool.  ``paged_attention`` launches ``csrc/paged_decode.cu`` (which
replaces the TPU kernel ``_paged_decode_kernel``) on a CUDA tensor, always:
the TPU's gates (``kv*d % 128``, an 8 MB pool, a TPU backend) do not carry
over.  On a CPU tensor it runs ``paged_attention_reference``, the jnp
fallback's arithmetic.  There is no fallback on CUDA: only the caller's
explicit ``impl="jnp"`` runs the plain version there.

The kernel splits each sequence's table entries across CTAs
(``split_plan``, from the shapes alone); the last CTA of a (sequence, kv
head) to finish combines the splits' partials.  It streams the pages through
a ring in shared memory with TMA and runs the tensor cores in bf16 (``body``
names the shapes that do).  It scales Q by log2(e)/sqrt(D) and rounds it to
Q's type itself.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .flash_attention import LOG2_E

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448   # bytes of shared memory one CTA may use on Hopper
SMS = 132              # streaming multiprocessors of an H100
# The tensor-core body: bf16, these head dims, at most 16 query heads per kv
# head (the rows of one mma tile).  Every other shape runs the FMA body.
_TC_HEAD_DIMS = (16, 32, 64, 128, 256)
_TC_MAX_REP = 16
_MAX_SLOTS = 16        # ring stages (csrc/attn_sm90.cuh kMaxSlots)
_RING = 3              # ring stages for a span longer than shared memory holds


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


def split_plan(batch_kv: int, m: int) -> tuple[int, int]:
    """(pages_per_split, splits) for ``batch_kv`` (sequence, kv head) pairs
    over ``m`` table entries each.  The grid (splits, KV, B) aims at two
    waves of CTAs on the H100's ``SMS`` SMs; every split takes whole table
    entries and the last one at least one.  From the shapes alone: the
    lengths stay on the card, so reading them would cost a sync."""
    target = 2 * SMS
    if m <= 1 or batch_kv >= target:
        return max(m, 1), 1
    wanted = -(-target // batch_kv)
    pps = -(-m // min(wanted, m))
    return pps, -(-m // pps)


def body(dtype: torch.dtype, rep: int, d: int) -> str:
    """Which body of the kernel a call runs: "tensor_cores" (mma.sync) or
    "fma" (CUDA cores; fp32, since TF32 cannot meet its tolerance, and the
    bf16 shapes the tensor-core tile does not take)."""
    if dtype == torch.bfloat16 and d in _TC_HEAD_DIMS and rep <= _TC_MAX_REP:
        return "tensor_cores"
    return "fma"


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


_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures, set once."""
    global _lib
    if _lib is None:
        lib = _build.load("paged_decode")
        lib.paged_decode_smem_bytes.restype = ctypes.c_int
        lib.paged_decode_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.paged_decode.restype = ctypes.c_int
        lib.paged_decode.argtypes = ([ctypes.c_void_p] * 8 +
                                     [ctypes.c_int] * 12 +
                                     [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p])
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _tiling(tc: bool, rep: int, d: int, itemsize: int, span: int):
    """(tokens per stage, ring stages) for a CTA span of ``span`` tokens:
    the whole span in flight where it fits, else a ring of ``_RING`` stages
    (or as many as fit, at least three).  The FMA body halves its stage down
    to 16 tokens before giving up; None if nothing fits."""
    smem = _library().paged_decode_smem_bytes
    for tk in (64,) if tc else (64, 32, 16):
        tiles = -(-span // tk)
        if tiles <= _MAX_SLOTS and \
                smem(int(tc), tk, tiles, rep, d, itemsize) <= _SMEM_LIMIT:
            return tk, tiles
        for slots in range(min(_RING, tiles), 2, -1):
            if smem(int(tc), tk, slots, rep, d, itemsize) <= _SMEM_LIMIT:
                return tk, slots
    return None


_counter_bufs = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed ints for the kernel's split counters, one
    buffer per (device, stream): the last CTA of each (sequence, kv head)
    leaves its counter zero again, so calls in stream order share it."""
    buf = _counter_bufs.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counter_bufs[(device, stream)] = buf
    return buf


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
    rep = h // kv
    tc = body(q.dtype, rep, d) == "tensor_cores"
    pps, splits = split_plan(b * kv, m)
    tiling = _tiling(tc, rep, d, q.element_size(), pps * p)
    if tiling is None:
        raise ValueError(f"{rep} query heads per kv head at head_dim {d} "
                         "do not fit in shared memory")
    tk, slots = tiling
    out = torch.empty_like(q)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws_ptr = counters_ptr = None
    if splits > 1:
        # The splits' fp32 partials: acc [B, KV, splits, rep, D], m, l.
        ws = torch.empty(b * kv * splits * rep * (d + 2),
                         dtype=torch.float32, device=q.device)
        ws_ptr = ws.data_ptr()
        counters_ptr = _counters(q.device, stream, b * kv).data_ptr()
    with torch.cuda.device(q.device):
        err = _library().paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            ws_ptr, counters_ptr, b, h, kv, d, n, p, m, pps, splits, tk,
            slots, math.gcd(p, tk), LOG2_E / d ** 0.5, _DTYPES[q.dtype],
            int(tc), stream)
    if err != 0:
        # Past CUDA's own codes (csrc/attn_sm90.cuh): 2000, libcuda has no
        # cuTensorMapEncodeTiled; 3000 + r, it refused a tensor map (r).
        raise RuntimeError(f"paged_decode launch failed: error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0   # kernel calls since the last reset
