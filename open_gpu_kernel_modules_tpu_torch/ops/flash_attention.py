"""Flash attention: CUDA kernels for Hopper and their plain PyTorch version.

Port of the JAX ``ops/flash_attention.py``.  On a CUDA tensor
``flash_attention`` launches ``csrc/flash_attn.cu`` (which replaces the TPU
kernel ``_flash_kernel``, ``impl="grid"``, the default) or
``csrc/flash_rows.cu`` (which replaces ``_flash_kernel_rows``,
``impl="rows"``); on a CPU tensor it runs ``flash_attention_reference``.
There is no fallback on CUDA: the chosen kernel runs or the call raises.

The TPU version's block sizes (``blk_q``/``blk_k``) and ``interpret`` flag
are Pallas tiling and emulation knobs with no counterpart here: the kernels
tile by 64 and mask the ragged edge themselves, so no sequence is padded.
The kernels take head_dim 64 and 128; a smaller head_dim that is a multiple
of 8 is zero-padded up to the next of them (16 and 32 to 64, 96 to 128).
Zero columns add nothing to QK^T and give zero output columns, which are cut
off again, and the softmax scale is that of the true head_dim.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
LOG2_E = 1.4426950408889634   # softmax runs base-2; scale carries log2(e)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The body each dtype runs inside both kernels (the C entry points choose it
# by their dtype argument): bf16 the wgmma/TMA core of csrc/attn_sm90.cuh,
# fp32 the CUDA-core FMA body, since TF32 cannot meet fp32's tolerance.
BODY = {torch.bfloat16: "tensor_cores", torch.float32: "fma"}
_HEAD_DIMS = (64, 128)           # the widths the kernels are built for


def _scale(d: int) -> float:
    return LOG2_E / (d ** 0.5)


def _to_bhsd(x: torch.Tensor, layout: str) -> torch.Tensor:
    return x if layout == "bhsd" else x.transpose(1, 2)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              prescale_q: bool = True,
                              layout: str = "bshd") -> torch.Tensor:
    """Plain version of the kernel's function.  q,k,v: [B, S, H, D]
    (``bshd``) or [B, H, S, D] (``bhsd``); returns q's layout and type.

    Base-2 softmax in fp32 over scores scaled by log2(e)/sqrt(D); with
    ``prescale_q`` the scaled Q is rounded to q.dtype first, as the kernel
    does.  P is cast to V's type before PV.  Rows with no visible key give
    zeros."""
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"layout must be 'bshd' or 'bhsd', got {layout!r}")
    d = q.shape[-1]
    qh, kh, vh = (_to_bhsd(x, layout) for x in (q, k, v))
    scale = _scale(d)
    if prescale_q:
        s = (qh.float() * scale).to(q.dtype).float() @ kh.float().transpose(-1, -2)
    else:
        s = (qh.float() @ kh.float().transpose(-1, -2)) * scale
    sq, sk = s.shape[-2], s.shape[-1]
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(kj > qi, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp2(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = (p.to(v.dtype).float() @ vh.float()) / denom
    out = out.to(q.dtype)
    return out if layout == "bhsd" else out.transpose(1, 2).contiguous()


# impl -> (source under csrc/, its C entry point)
_KERNELS = {"grid": ("flash_attn", "flash_attn_fwd"),
            "rows": ("flash_rows", "flash_rows_fwd")}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, prescale_q: bool = True,
                    impl: str = "auto", layout: str = "bshd") -> torch.Tensor:
    """q,k,v: [B, S, H, D] (layout="bshd", default) or [B, H, S, D]
    (layout="bhsd"); GQA expansion done by the caller.  Returns the same
    layout in q.dtype.

    ``impl`` picks the kernel on a CUDA tensor, as in JAX: "auto" and
    "grid" launch ``csrc/flash_attn.cu``, "rows" the row-resident
    ``csrc/flash_rows.cu``.  Each counts its launches on its own
    (``flash_attention.launches``, ``flash_attention.rows_launches``)."""
    if impl not in ("auto", "grid", "rows"):
        raise ValueError(
            f"impl must be 'auto', 'grid' or 'rows', got {impl!r}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         prescale_q=prescale_q, layout=layout)
    return _flash_cuda(q, k, v, causal, prescale_q, layout,
                       "grid" if impl == "auto" else impl)


def _padded_dim(d: int) -> int:
    """The kernel width a head_dim of ``d`` runs at (zero-padded up to it);
    raises for a head_dim the kernels cannot take."""
    if d % 8 == 0:
        for w in _HEAD_DIMS:
            if 0 < d <= w:
                return w
    raise ValueError(f"head_dim {d} not supported: the kernels take 64 and "
                     f"128, and a multiple of 8 below 128 padded up to one "
                     f"of them")


def _strides(x: torch.Tensor, layout: str):
    """(batch, head, seq) element strides of a contiguous tensor."""
    sb, s1, s2, _ = x.stride()
    return (sb, s1, s2) if layout == "bhsd" else (sb, s2, s1)


def _flash_cuda(q, k, v, causal, prescale_q, layout, impl="grid"):
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"layout must be 'bshd' or 'bhsd', got {layout!r}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device")
        if x.dtype != q.dtype or q.dtype not in _DTYPES:
            raise TypeError("q, k, v must share one dtype in "
                            f"{list(_DTYPES)}; got {x.dtype}")
        if x.dim() != 4 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if layout == "bhsd":
        b, h, sq, d = q.shape
        kb, kh, sk, kd = k.shape
    else:
        b, sq, h, d = q.shape
        kb, sk, kh, kd = k.shape
    if (kb, kh, kd) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, heads or head_dim")
    width = _padded_dim(d)
    if sq == 0 or b * h == 0:
        return torch.empty_like(q)
    if width != d:
        q, k, v = (torch.nn.functional.pad(x, (0, width - d))
                   for x in (q, k, v))
    out = torch.empty_like(q)
    source, entry = _KERNELS[impl]
    fn = getattr(_build.load(source), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 +
                   [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2 +
                   [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, sq, sk, width, *_strides(q, layout),
                 *_strides(k, layout), int(causal), int(prescale_q),
                 _scale(d), _DTYPES[q.dtype], stream)
    if err != 0:
        # attn_sm90.cuh adds two codes past CUDA's own: 2000, libcuda has no
        # cuTensorMapEncodeTiled; 3000 + r, it refused a tensor map (r).
        raise RuntimeError(f"{entry} launch failed: error {err}")
    if impl == "rows":
        flash_attention.rows_launches += 1
    else:
        flash_attention.launches += 1
    return out if width == d else out[..., :d].contiguous()


def rows_segment_tokens(sq: int, sk: int, d: int, dtype: torch.dtype,
                        causal: bool) -> int:
    """Keys one CTA of the "rows" kernel stages at once for this problem; a
    q block whose live key span is longer stages it in segments.  Builds
    the kernel's library (needs nvcc)."""
    fn = _build.load("flash_rows").flash_rows_segment_tokens
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5
    itemsize = torch.empty((), dtype=dtype).element_size()
    return fn(sq, sk, d, itemsize, int(causal))


flash_attention.launches = 0        # grid-kernel launches since the last reset
flash_attention.rows_launches = 0   # rows-kernel launches since the last reset
