"""Inference engine: paged KV cache, prefill, greedy decode, tiered backing.

Port of the JAX ``models/serving.py``, in two layers:

- the dense half (``PagedKVCache``, ``_write_kv``, ``prefill``,
  ``decode_step``, ``decode_scan``, ``generate``): a device-resident page
  pool; decode attention runs through ``ops.paged_attention``, the
  paged-decode CUDA kernel on the card;
- the tiered half (``ManagedKVBacking``, ``TieredKVCache``,
  ``prefill_group``, ``decode_rounds``): BASELINE config #4, a KV pool
  larger than device memory held in UVM managed memory (preferred tier
  CXL) by the native engine, whose pages are faulted in and uploaded into a
  device slot pool one decode group at a time.

Unlike JAX, the page pool is updated IN PLACE: a decode step writes its K/V
into ``cache.k_pages``/``v_pages`` and returns a cache that shares them, so
the pool is never copied.  ``seq_lens`` is replaced, never mutated.  The
tiered cache's slot pool is such a pool: the view ``activate`` returns
shares ``k_slots``/``v_slots``.

Observability: application trace spans (``utils.span``, recorded while
tracing is armed), each with an object and a byte count:

- serving: ``serve.prefill_group`` (sequences; prompt tokens times the KV
  bytes of a token) around ``serve.prefill`` (the forward over the prompt),
  ``serve.decode_scan`` around one ``serve.decode_step`` a token (the step
  and its argmax), both with the batch;
- the tier: ``tier.activate`` (pages missed; bytes uploaded) around
  ``tier.upload`` (the host-to-device copy of missed pages);
  ``tier.read_pages`` (pages; bytes handed up) around ``tier.fault_pass``
  (the memring prefetch pass or the synchronous fault loop) and
  ``tier.gather`` (the page-major to layer-major copy); ``tier.sync_from``
  (sequences); ``tier.flush`` (pages; bytes written) around
  ``tier.download`` (the device gather and readback) and
  ``tier.writeback`` (the page writes into managed memory), which a spill
  of the victim ring also emits; ``tier.release`` (the sequence).

The port's own counters (``utils.port_counter_add``), always on, in the
Prometheus exposition: ``tputier_read_bytes`` and ``tputier_read_ns``
(every ``read_pages``: bytes handed up, host ns in the call),
``tputier_flush_bytes`` and ``tputier_flush_ns`` (every ``flush_group``:
bytes written, host ns of its write-back).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import utils as _utils
from ..device import DeviceLike, resolve
from ..ops.paged_attention import paged_attention
from ..runtime import native as _native
from . import llama

_span = _utils.span


@dataclasses.dataclass
class PagedKVCache:
    """Block-paged KV pool: k/v [L, N, P, KV, D], page tables [B, M]."""

    cfg: llama.LlamaConfig
    page_size: int
    k_pages: torch.Tensor       # [L, N, P, KV, D]
    v_pages: torch.Tensor
    page_table: torch.Tensor    # [B, M] int32
    seq_lens: torch.Tensor      # [B] int32

    @staticmethod
    def create(cfg: llama.LlamaConfig, batch: int, max_len: int,
               page_size: int = 64, device: DeviceLike = None
               ) -> "PagedKVCache":
        device = resolve(device)
        m = (max_len + page_size - 1) // page_size
        n = batch * m
        shape = (cfg.num_layers, n, page_size, cfg.num_kv_heads, cfg.head_dim)
        # Static page assignment: sequence b owns pages [b*m, (b+1)*m).
        table = (torch.arange(batch, dtype=torch.int32)[:, None] * m +
                 torch.arange(m, dtype=torch.int32)[None, :])
        return PagedKVCache(
            cfg=cfg, page_size=page_size,
            k_pages=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v_pages=torch.zeros(shape, dtype=cfg.dtype, device=device),
            page_table=table.to(device),
            seq_lens=torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def max_len(self) -> int:
        return self.page_table.shape[1] * self.page_size


def _slots(cache: PagedKVCache, tok: torch.Tensor) -> torch.Tensor:
    """Flat pool slot of token position ``tok`` [B, S] of each sequence.
    The table column is clamped to the table, which JAX's
    ``take_along_axis`` does implicitly and torch's ``gather`` does not."""
    p = cache.page_size
    col = (tok // p).clamp(0, cache.page_table.shape[1] - 1).long()
    page = torch.gather(cache.page_table.long(), 1, col)
    return page * p + tok % p


def _write_kv(cache: PagedKVCache, layer_k: torch.Tensor,
              layer_v: torch.Tensor, pos: int) -> PagedKVCache:
    """Write a [L, B, S, KV, D] chunk at position ``pos`` into the pool
    (in place)."""
    L, b, s, kv, d = layer_k.shape
    if pos + s > cache.max_len:
        raise ValueError(f"chunk [{pos}, {pos + s}) exceeds cache.max_len "
                         f"({cache.max_len})")
    tok = pos + torch.arange(s, device=layer_k.device)[None, :].expand(b, s)
    flat_idx = _slots(cache, tok).reshape(-1)                   # [B*S]
    for pool, src in ((cache.k_pages, layer_k), (cache.v_pages, layer_v)):
        flat = pool.view(L, -1, kv, d)
        flat.index_copy_(1, flat_idx, src.reshape(L, b * s, kv, d))
    return cache


def prefill(cfg: llama.LlamaConfig, params: Dict, tokens: torch.Tensor,
            cache: PagedKVCache) -> Tuple[torch.Tensor, PagedKVCache]:
    """Run the prompt through the model, filling the paged cache.

    Returns (last-token logits [B, V], cache)."""
    b, s = tokens.shape
    # Dense scratch cache sized to the prompt span for the forward pass.
    shape = (cfg.num_layers, b, s, cfg.num_kv_heads, cfg.head_dim)
    with _span("serve.prefill", obj=b):
        kv = (torch.zeros(shape, dtype=cfg.dtype, device=tokens.device),
              torch.zeros(shape, dtype=cfg.dtype, device=tokens.device))
        logits, kv = llama.forward_with_cache(cfg, params, tokens, kv, 0)
        cache = _write_kv(cache, kv[0], kv[1], 0)
    cache = dataclasses.replace(
        cache, seq_lens=torch.full((b,), s, dtype=torch.int32,
                                   device=tokens.device))
    return logits[:, -1], cache


def decode_step(cfg: llama.LlamaConfig, params: Dict, tokens: torch.Tensor,
                cache: PagedKVCache) -> Tuple[torch.Tensor, PagedKVCache]:
    """One decode step: tokens [B] -> (logits [B, V], updated cache)."""
    b = tokens.shape[0]
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = params["embed"][tokens][:, None, :]                 # [B, 1, H]
    pos = cache.seq_lens                                    # [B]
    cos, sin = llama.rope_table(cfg, pos[:, None])          # [B, 1, D/2]

    # This token's pool slot.  A sequence at max_len has no slot left: JAX
    # drops its write (mode="drop").  Here its index is clamped to its own
    # last slot and the value already there is written back, so the pool is
    # unchanged without a data-dependent (host-syncing) row selection.
    # Sequences own disjoint pages, so no other row writes that slot.
    valid = (pos < cache.max_len)[:, None, None]            # [B, 1, 1]
    slot = _slots(cache, pos.clamp(max=cache.max_len - 1)[:, None])[:, 0]
    seq_lens_next = pos + 1

    for i, lp in enumerate(llama.layers(params)):
        attn_in = llama.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q = (attn_in @ lp["wq"]).reshape(b, 1, nh, hd)
        k = (attn_in @ lp["wk"]).reshape(b, 1, nkv, hd)
        v = (attn_in @ lp["wv"]).reshape(b, 1, nkv, hd)
        q = llama.apply_rope(q, cos, sin)
        k = llama.apply_rope(k, cos, sin)

        lk, lv = cache.k_pages[i], cache.v_pages[i]         # [N, P, KV, D]
        n_, p_, kv_, d_ = lk.shape
        for pool, new in ((lk, k), (lv, v)):
            flat = pool.view(n_ * p_, kv_, d_)
            flat[slot] = torch.where(valid, new[:, 0], flat[slot])

        out = paged_attention(q[:, 0], lk, lv, cache.page_table,
                              seq_lens_next, nh)            # [B, H, D]
        x = x + (out.reshape(b, 1, nh * hd) @ lp["wo"])
        x = llama.mlp(cfg, x, lp)

    logits = llama.final_logits(cfg, params, x[:, 0])
    cache = dataclasses.replace(
        cache, seq_lens=torch.clamp(cache.seq_lens + 1, max=cache.max_len))
    return logits, cache


def decode_scan(cfg: llama.LlamaConfig, params: Dict, tokens: torch.Tensor,
                cache: PagedKVCache, n: int
                ) -> Tuple[torch.Tensor, PagedKVCache, torch.Tensor]:
    """Greedy-decode ``n`` tokens.  JAX runs this as one ``lax.scan``
    dispatch; here it is a plain loop of decode steps.  Returns (next token
    [B], cache, decoded tokens [n, B])."""
    toks = []
    tok = tokens
    b = tokens.shape[0]
    with _span("serve.decode_scan", obj=b):
        for _ in range(n):
            with _span("serve.decode_step", obj=b):
                logits, cache = decode_step(cfg, params, tok, cache)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(tok)
    stacked = torch.stack(toks) if toks else tokens.new_empty((0,) +
                                                              tokens.shape)
    return tok, cache, stacked


def generate(cfg: llama.LlamaConfig, params: Dict, prompt: torch.Tensor,
             max_new_tokens: int, cache: Optional[PagedKVCache] = None
             ) -> Tuple[torch.Tensor, PagedKVCache, float]:
    """Prefill + greedy decode loop.  Returns (tokens [B, S+T], cache,
    tok/s of the decode loop)."""
    b, s = prompt.shape
    if cache is None:
        cache = PagedKVCache.create(cfg, b, s + max_new_tokens,
                                    device=prompt.device)
    if s + max_new_tokens > cache.max_len:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"cache.max_len ({cache.max_len})")
    logits, cache = prefill(cfg, params, prompt, cache)
    out = [prompt]
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)

    _sync(prompt.device)
    t0 = time.perf_counter()
    for _ in range(max_new_tokens):
        out.append(next_tok[:, None].to(prompt.dtype))
        logits, cache = decode_step(cfg, params, next_tok, cache)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(prompt.device)
    dt = time.perf_counter() - t0
    toks_per_s = (b * max_new_tokens) / dt if dt > 0 else 0.0
    return torch.cat(out, dim=1), cache, toks_per_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------- tiering
#
# The backing store holds raw element bytes in numpy.  numpy has no
# bfloat16 without ml_dtypes, so bf16 pages are kept as uint16 with the same
# bits and reinterpreted on the way in and out (int16 on the torch side).

_NP_DTYPES = {torch.float32: np.dtype(np.float32),
              torch.bfloat16: np.dtype(np.uint16)}


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype not in _NP_DTYPES:
        raise TypeError(f"tiered KV supports {list(_NP_DTYPES)}, got {dtype}")
    return _NP_DTYPES[dtype]


def _from_np(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host tensor of ``dtype`` over ``a``'s bytes (no copy)."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_np(t: torch.Tensor) -> np.ndarray:
    """The bytes of ``t`` as a host numpy array in the backing's dtype."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _host_empty(shape: Tuple[int, ...], np_dtype: np.dtype,
                pin: bool) -> np.ndarray:
    """An uninitialised host array; page-locked when ``pin``, so that a
    host-to-device copy from it can run asynchronously."""
    if not pin:
        return np.empty(shape, np_dtype)
    tdt = torch.int16 if np_dtype == np.uint16 else torch.float32
    return torch.empty(shape, dtype=tdt, pin_memory=True).numpy().view(
        np_dtype)


def _h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array (indices, tokens) on ``device`` without waiting
    for the device: staged through pinned memory on a CUDA device."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _index(idx: Sequence[int], device: torch.device) -> torch.Tensor:
    return _h2d(np.asarray(idx, np.int64), device)


def _scatter_pages(pool: torch.Tensor, idx: torch.Tensor,
                   chunk: torch.Tensor) -> None:
    """pool[:, idx] = chunk (idx [n], chunk [L, n, P, KV, D]), in place."""
    pool.index_copy_(1, idx, chunk)


def _gather_pages(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return pool.index_select(1, idx)


def _victim_save(k_slots: torch.Tensor, v_slots: torch.Tensor,
                 vic_k: torch.Tensor, vic_v: torch.Tensor,
                 slot_idx: torch.Tensor, vic_idx: torch.Tensor) -> None:
    """Copy evicted slots' pages into victim-ring entries (device-side, in
    place).  ``index_select`` copies first, so nothing aliases."""
    vic_k.index_copy_(1, vic_idx, k_slots.index_select(1, slot_idx))
    vic_v.index_copy_(1, vic_idx, v_slots.index_select(1, slot_idx))


def _victim_restore(k_slots: torch.Tensor, v_slots: torch.Tensor,
                    vic_k: torch.Tensor, vic_v: torch.Tensor,
                    vic_idx: torch.Tensor, dest_slots: torch.Tensor) -> None:
    """Copy victim-ring entries back into slots (in place)."""
    k_slots.index_copy_(1, dest_slots, vic_k.index_select(1, vic_idx))
    v_slots.index_copy_(1, dest_slots, vic_v.index_select(1, vic_idx))


@dataclasses.dataclass(frozen=True)
class StagedActivation:
    """In-flight activation state from TieredKVCache.prefetch: the page
    list it staged and the device-resident (possibly still streaming)
    upload chunks."""
    pages: Tuple[int, ...]
    k_dev: Optional[torch.Tensor]
    v_dev: Optional[torch.Tensor]
    # Drain epoch at read time: a drain between prefetch and commit
    # folds parked deltas into the backing, making these (pre-drain)
    # base bytes unusable — the commit re-reads instead.
    epoch: int = 0
    # Recorded on the side stream after the copies: the commit makes its
    # stream wait on it before it scatters (None on the CPU).
    ready: Optional[torch.cuda.Event] = None


class ManagedKVBacking:
    """UVM-managed backing pool for TieredKVCache (config #4).

    The full logical pool lives in one managed allocation whose
    preferred location is the CXL tier, read-duplicated (device faults
    must not steal pages the CPU upload path re-reads).  ``read_pages``
    drives the fault engine over each page's span (hotness, prefetch,
    thrashing, tier residency) before handing the bytes up.

    Backing layout is PAGE-MAJOR ([N, L, page...] vs the device pool's
    layer-major [L, N, page...]): one logical page is ONE contiguous
    span covering all its layers, so activation faults it with a single
    device access and reads it as one slice — 2 operations per page
    instead of 2 * num_layers.

    The managed views are host memory the engine protects and services
    through its SIGSEGV handler: they are never handed to CUDA.  Uploads
    read only the contiguous copies ``read_pages`` returns.
    """

    def __init__(self, pool_shape: Tuple[int, ...], np_dtype: np.dtype,
                 page_bytes: int, dev: int):
        from .. import uvm
        from ..uvm import memring
        from ..uvm.managed import Tier

        self.pool_shape = pool_shape            # device layout [L, N, ...]
        self.np_dtype = np_dtype
        self.page_bytes = page_bytes
        self.total_pages = pool_shape[1]
        self.num_layers = pool_shape[0]
        # Page-major storage shape.
        self.store_shape = (self.total_pages, self.num_layers) + \
            pool_shape[2:]
        self.rec_bytes = self.num_layers * page_bytes
        self.dev = dev
        pool_bytes = int(np.prod(pool_shape)) * np_dtype.itemsize
        self.vs = uvm.VaSpace(register_devices=(dev,))
        self.k_buf = self.vs.alloc(pool_bytes)
        self.v_buf = self.vs.alloc(pool_bytes)
        for buf in (self.k_buf, self.v_buf):
            buf.set_preferred(Tier.CXL)
            buf.view(np_dtype)[:] = 0
            buf.set_read_duplication(True)
            buf.migrate(Tier.CXL)
        # Async submission ring (tpumemring): a group's page faults go
        # down as ONE batched submission the worker pool drains instead
        # of 2 blocking uvmDeviceAccess calls per page.  Without a ring
        # the sync fault loop runs.
        try:
            self.ring = memring.MemRing(self.vs, entries=512)
        except Exception:
            self.ring = None        # fall back to the sync loop
        # tpuflow page->flow resolver (optional): when set, every page's
        # prefetch SQEs carry the owning request's flow id.
        self.flow_of_page = None

    def _ring_fault_pages(self, pages: List[int]) -> None:
        """One batched prefetch pass over ``pages`` (both pools)."""
        n = 0
        for page in pages:
            off = page * self.rec_bytes
            fl = self.flow_of_page(page) if self.flow_of_page else 0
            if self.ring.sq_space < 2:
                # Giant group: flush a full SQ wave and keep going.
                self.ring.submit_and_wait(n)
                self.ring.completions(max_cqes=max(n, 64), check=True)
                n = 0
            self.ring.prefetch(self.k_buf.address + off,
                               self.rec_bytes, dev=self.dev, flow=fl)
            self.ring.prefetch(self.v_buf.address + off,
                               self.rec_bytes, dev=self.dev, flow=fl)
            n += 2
        self.ring.submit_and_wait(n)
        self.ring.completions(max_cqes=max(n, 64), check=True)

    def _store_k(self) -> np.ndarray:
        return self.k_buf.view(self.np_dtype, self.store_shape)

    def _store_v(self) -> np.ndarray:
        return self.v_buf.view(self.np_dtype, self.store_shape)

    def k_view(self) -> np.ndarray:
        """Pool view in DEVICE layout [L, N, ...] (test/introspection:
        a transposed view over the page-major store; reads fault)."""
        return self._store_k().transpose(1, 0, *range(2, len(
            self.store_shape)))

    def v_view(self) -> np.ndarray:
        return self._store_v().transpose(1, 0, *range(2, len(
            self.store_shape)))

    def read_pages(self, pages: List[int], pin: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Fault + fetch pages; returns (k, v) chunks [L, n, P, KV, D],
        contiguous copies (page-locked host memory with ``pin``).

        The fault pass is BATCHED async submission through the memring;
        errors come back as per-op CQEs (raised here as RmError, matching
        the sync path's contract).  A CQE carrying DEVICE_RESET is a
        completion the generation fence rejected: the pages' truth is
        intact in the backing, so the idempotent fault pass runs again
        against the new generation — only while the device generation
        keeps advancing between attempts, with a hard cap as the
        backstop.  Any other error raises."""
        t0 = time.monotonic_ns()
        n = len(pages)
        nbytes = 2 * n * self.rec_bytes
        with _span("tier.read_pages", obj=n, nbytes=nbytes):
            with _span("tier.fault_pass", obj=n, nbytes=nbytes):
                self._fault_pass(pages)
            with _span("tier.gather", obj=n, nbytes=nbytes):
                shape = (self.num_layers, n) + self.store_shape[2:]
                k = _host_empty(shape, self.np_dtype, pin)
                v = _host_empty(shape, self.np_dtype, pin)
                store_k, store_v = self._store_k(), self._store_v()
                for i, page in enumerate(pages):
                    k[:, i] = store_k[page]             # [L, page...] record
                    v[:, i] = store_v[page]
        _utils.port_counter_add("tputier_read_bytes", nbytes)
        _utils.port_counter_add("tputier_read_ns",
                                time.monotonic_ns() - t0)
        return k, v

    def _fault_pass(self, pages: List[int]) -> None:
        """Fault ``pages`` in for the device: the memring pass, retried
        across device resets, or without a ring the synchronous loop."""
        if self.ring is not None and pages:
            from ..uvm import reset as _reset

            max_retries = 8
            gen = _reset.generation()
            for attempt in range(max_retries + 1):
                try:
                    self._ring_fault_pages(pages)
                    break
                except _native.RmError as e:
                    new_gen = _reset.generation()
                    advanced = new_gen != gen
                    gen = new_gen
                    if (e.status != _native.TPU_ERR_DEVICE_RESET or
                            not advanced or attempt == max_retries):
                        raise
                    self.ring.drain()
                    self.ring.completions(max_cqes=8192)
        else:
            for page in pages:
                off = page * self.rec_bytes
                self.k_buf.device_access(dev=self.dev, offset=off,
                                         length=self.rec_bytes)
                self.v_buf.device_access(dev=self.dev, offset=off,
                                         length=self.rec_bytes)

    def write_page(self, page: int, k_rec: np.ndarray,
                   v_rec: np.ndarray) -> None:
        self._store_k()[page] = k_rec           # [L, page...] chunk
        self._store_v()[page] = v_rec

    def close(self) -> None:
        if self.ring is not None:
            self.ring.close()
            self.ring = None
        self.vs.close()


class TieredKVCache:
    """Oversubscribed paged KV cache over a tiered backing store.

    Config #4's shape (KV >> device memory): the device-resident slot pool
    holds only ``1/oversub`` of the logical pages; the full pool lives in
    the backing store (default: ManagedKVBacking — UVM managed memory,
    preferred tier CXL).  ``activate`` pins a group of sequences
    device-side: every missing page is faulted in through the backing and
    its bytes are uploaded into a free slot, evicting least-recently-used
    slots first.  Upload and flush move ONLY the pages that changed hands,
    as batched in-place ``index_copy_``/``index_select`` on the slot
    tensors.

    ``device`` holds the slot pool and the victim ring (the CUDA card by
    default, see ``device.resolve``); ``dev`` is the native UVM device id
    the backing faults pages towards.

    ``oversub=1`` degenerates to a fully device-resident pool (after the
    initial faults nothing ever evicts) — the dense baseline runs the
    same code path, which is what makes tiered-vs-dense timing honest.

    The host-side bookkeeping is the JAX package's, step for step, so both
    reach the same state and the same ``stats``.  JAX pads its index
    vectors to fixed lengths so that XLA compiles once; eager PyTorch has
    no such need, and the port moves exactly the pages that change hands.
    """

    def __init__(self, cfg: llama.LlamaConfig, batch: int, max_len: int,
                 page_size: int = 64, oversub: int = 4, dev: int = 0,
                 backing=None, victim_entries: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve(device)
        self.cfg = cfg
        self.page_size = page_size
        self.dev = dev
        self.batch = batch
        m = (max_len + page_size - 1) // page_size
        self.pages_per_seq = m
        self.total_pages = batch * m
        self.n_slots = max(m, self.total_pages // max(1, oversub))
        self.np_dtype = _np_dtype(cfg.dtype)

        page_elems = page_size * cfg.num_kv_heads * cfg.head_dim
        self.page_shape = (page_size, cfg.num_kv_heads, cfg.head_dim)
        self.page_bytes = page_elems * self.np_dtype.itemsize
        self.pool_shape = (cfg.num_layers, self.total_pages) + self.page_shape

        # Device slot pool.
        slot_shape = (cfg.num_layers, self.n_slots) + self.page_shape
        self.k_slots = torch.zeros(slot_shape, dtype=cfg.dtype,
                                   device=self.device)
        self.v_slots = torch.zeros(slot_shape, dtype=cfg.dtype,
                                   device=self.device)
        # Side stream for prefetch uploads (CUDA only), and the pinned host
        # chunks of the last one with its completion event.  PyTorch's
        # pinned-memory allocator cannot see a copy made from a numpy view,
        # so the chunks are held until that copy is known to be done.
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._pinned: Optional[Tuple[torch.cuda.Event, np.ndarray,
                                     np.ndarray]] = None

        self.backing = backing if backing is not None else ManagedKVBacking(
            self.pool_shape, self.np_dtype, self.page_bytes, dev)

        # Bookkeeping (host-side, tiny).
        self.slot_owner = np.full((self.n_slots,), -1, np.int64)
        self.slot_of = np.full((self.total_pages,), -1, np.int64)
        # Insertion-ordered dict as an O(1) LRU: first key = coldest.
        self._lru: Dict[int, None] = dict.fromkeys(range(self.n_slots))
        self._active_slots: set = set()
        self.seq_lens = np.zeros((batch,), np.int32)
        self.last_token = np.zeros((batch,), np.int32)
        # Device-parked last tokens, keyed by group tuple: the serving loop
        # keeps tokens on the device and reads them back only when a
        # caller asks (materialize, flush_group, decode_rounds(force)).
        self._last_token_dev: Dict[Tuple[int, ...], torch.Tensor] = {}
        # Slots a decode WROTE since their last upload/restore.
        # Attention only reads KV, so most slots stay clean and evict
        # as free drops; dirty slots' pages must be preserved.
        self._dirty_slots: set = set()
        # Victim ring: evicted DIRTY pages are copied device-side
        # (_victim_save) into a small ring of page records instead of
        # being read back to the host.  A re-activated page restores from
        # its ring entry (_victim_restore).  Ring entries materialize into
        # the backing only at drain points (host view reads, close, ring
        # pressure at prefetch).  16 entries by default, whatever the pool
        # size: a write-back buffer for the recently-written eviction
        # tail, not a second cache tier.
        self.victim_entries = min(self.n_slots,
                                  victim_entries
                                  if victim_entries is not None else 16)
        vic_shape = (cfg.num_layers, self.victim_entries) + self.page_shape
        self._victim_k = torch.zeros(vic_shape, dtype=cfg.dtype,
                                     device=self.device)
        self._victim_v = torch.zeros(vic_shape, dtype=cfg.dtype,
                                     device=self.device)
        self._victim_map: Dict[int, int] = {}    # page -> ring entry
        self._victim_free: List[int] = list(range(self.victim_entries))
        self._drain_epoch = 0
        self.stats = {"uploads": 0, "flushes": 0, "clean_drops": 0,
                      "upload_bytes": 0, "activations": 0,
                      "prefetched_uploads": 0, "victim_restores": 0,
                      "sync_flushes": 0, "drains": 0,
                      "warm_reinserts": 0}
        # tpuhot, scheduler-level face: decayed per-page activation heat.
        # release_sequence consults it — a released-but-hot page's slot
        # reinserts WARM — and eviction orders each class coldest-first.
        self._page_heat = np.zeros((self.total_pages,), np.float32)
        self.heat_decay = 0.95
        self.release_warm_heat = 1.5

    # ------------------------------------------------------------ views
    # (available only on backings that expose a host view)

    @property
    def k_buf(self):
        self.drain_flushes()
        return self.backing.k_buf

    @property
    def v_buf(self):
        self.drain_flushes()
        return self.backing.v_buf

    def k_view(self) -> np.ndarray:
        self.drain_flushes()
        return self.backing.k_view()

    def v_view(self) -> np.ndarray:
        self.drain_flushes()
        return self.backing.v_view()

    # ----------------------------------------------------- slot machine

    def _touch_lru(self, slot: int) -> None:
        self._lru.pop(slot, None)
        self._lru[slot] = None          # reinsert at warm end

    def _flush_slots(self, slots: List[int]) -> None:
        """Evict slots: CLEAN slots (device copy never written since
        upload/restore) just drop — the backing or a victim entry
        already reconstructs them.  DIRTY slots' pages are copied into
        victim-ring entries with ONE device op; no device->host transfer
        happens here."""
        if not slots:
            return
        dirty = [s for s in slots if s in self._dirty_slots]
        for s in slots:
            if s not in self._dirty_slots:
                page = int(self.slot_owner[s])
                self.slot_of[page] = -1
                self.slot_owner[s] = -1
        self.stats["clean_drops"] += len(slots) - len(dirty)
        if not dirty:
            return
        evicting = set(dirty)
        saves: List[Tuple[int, int]] = []      # (slot, entry)
        spill: List[int] = []
        for s in dirty:
            page = int(self.slot_owner[s])
            e = self._victim_map.get(page)
            if e is None:
                e = self._alloc_victim_entry(evicting)
            if e is None:
                spill.append(s)
                continue
            self._victim_map[page] = e
            saves.append((s, e))
            self.slot_of[page] = -1
            self.slot_owner[s] = -1
            self._dirty_slots.discard(s)
        if spill:
            # Ring truly exhausted (even after reclaim): spill the
            # overflow synchronously.  NEVER drain here — eviction runs
            # inside an activation whose staged bases were read before
            # this point; a drain now would clear entries those bases
            # still compose with.
            self._write_back([(s, int(self.slot_owner[s])) for s in spill])
            for s in spill:
                page = int(self.slot_owner[s])
                if page >= 0:
                    self.slot_of[page] = -1
                self.slot_owner[s] = -1
            self.stats["sync_flushes"] += len(spill)
        if not saves:
            return
        _victim_save(self.k_slots, self.v_slots, self._victim_k,
                     self._victim_v,
                     _index([s for s, _ in saves], self.device),
                     _index([e for _, e in saves], self.device))
        self.stats["flushes"] += len(saves)

    def _alloc_victim_entry(self, evicting: set) -> Optional[int]:
        """A free ring entry, reclaiming one from a RESIDENT page if the
        free list is dry: the slot holds that page's truth, so dropping
        its entry only obliges the slot to re-save on eviction (mark it
        dirty).  Entries of evicted pages are never reclaimed — they are
        the only copy."""
        if self._victim_free:
            return self._victim_free.pop()
        for pg, e in list(self._victim_map.items()):
            slot = int(self.slot_of[pg])
            if slot >= 0 and slot not in evicting:
                del self._victim_map[pg]
                self._dirty_slots.add(slot)
                return e
        return None

    def drain_flushes(self) -> None:
        """Materialize every victim-ring entry into the backing: ONE
        batched device readback, then host-side page writes.  Never
        called on the decode hot path — only from host view reads,
        close(), or ring pressure at prefetch.  Bumps the drain epoch:
        staged bases read before a drain no longer compose with the
        (now-recycled) entries, so their activations must re-read."""
        if not self._victim_map:
            return
        vk, vv = _to_np(self._victim_k), _to_np(self._victim_v)
        for page, e in self._victim_map.items():
            self.backing.write_page(page, vk[:, e], vv[:, e])
        self._victim_map.clear()
        self._victim_free = list(range(self.victim_entries))
        self._drain_epoch += 1
        self.stats["drains"] += 1

    def _maybe_drain_for_cap(self) -> None:
        # Prefetch-time pressure valve: fires only when the ring is full
        # AND nothing is reclaimable (entries of resident pages can be
        # dropped by _alloc_victim_entry instead).  A drain costs a
        # readback AND invalidates in-flight stagings (epoch bump), so it
        # must stay off the steady-state path.
        if self._victim_free:
            return
        if any(int(self.slot_of[pg]) >= 0 for pg in self._victim_map):
            return
        self.drain_flushes()

    def _evict_for(self, need: int) -> List[int]:
        """Free `need` slots, returning them.  CLEAN slots go first (a
        clean drop is free; evicting a dirty slot parks a delta), each
        class ordered COLDEST-FIRST by the page-heat tracker (stable on
        the LRU order, so uniform heat keeps plain LRU order), always
        skipping pinned slots."""
        clean: List[int] = []
        dirty: List[int] = []
        for s in self._lru:
            if s in self._active_slots:
                continue
            (dirty if s in self._dirty_slots else clean).append(s)

        def _heat(s: int) -> float:
            page = int(self.slot_owner[s])
            return float(self._page_heat[page]) if page >= 0 else 0.0

        clean.sort(key=_heat)
        dirty.sort(key=_heat)
        freed = (clean + dirty)[:need]
        if len(freed) < need:
            raise RuntimeError(
                f"slot pool exhausted: need {need}, "
                f"{len(self._active_slots)} pinned of {self.n_slots}")
        for s in freed:
            del self._lru[s]
        self._flush_slots([s for s in freed if self.slot_owner[s] >= 0])
        return freed

    def _needed_pages(self, seq_ids: Sequence[int], new_tokens: int
                      ) -> List[int]:
        """Non-resident pages the group's activation will upload, in
        the exact order ``_activate_body`` walks them (prefetch and
        commit must agree on this order)."""
        m, P = self.pages_per_seq, self.page_size
        needed: List[int] = []
        for b in seq_ids:
            npages = min(m, (int(self.seq_lens[b]) + new_tokens + P - 1) // P)
            npages = max(npages, 1)
            for pg in range(npages):
                page = b * m + pg
                if self.slot_of[page] < 0:
                    needed.append(page)
        return needed

    def _upload(self, k_chunk: np.ndarray, v_chunk: np.ndarray
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Synchronous upload of host chunks to the slot pool's device."""
        with _span("tier.upload", obj=k_chunk.shape[1],
                   nbytes=k_chunk.nbytes + v_chunk.nbytes):
            return (_from_np(k_chunk, self.cfg.dtype).to(self.device),
                    _from_np(v_chunk, self.cfg.dtype).to(self.device))

    def prefetch(self, seq_ids: Sequence[int], new_tokens: int
                 ) -> "StagedActivation":
        """Start the group's next activation while the device computes.

        Runs everything that does NOT need the slot pool's final state:
        faults the group's missing pages through the backing into
        page-locked host memory and starts their host->device copy on a
        side CUDA stream into a staging buffer — parked deltas are
        re-applied on-device at commit, so no drain is needed here.
        ``activate(..., staged=...)`` then only picks slots and runs
        on-device scatters, after making its stream wait on the copy."""
        self._maybe_drain_for_cap()
        needed = self._needed_pages(seq_ids, new_tokens)
        # Pages with live victim entries need NO base upload — the
        # entry holds the full page and the commit's device-side
        # restore overwrites whatever the slot held.
        misses = [p for p in needed if p not in self._victim_map]
        if not misses:
            return StagedActivation(tuple(misses), None, None,
                                    self._drain_epoch)
        side = self._copy_stream
        self._release_pinned()
        k_chunk, v_chunk = self.backing.read_pages(misses,
                                                   pin=side is not None)
        if side is None:
            k_dev, v_dev = self._upload(k_chunk, v_chunk)
            return StagedActivation(tuple(misses), k_dev, v_dev,
                                    self._drain_epoch)
        # The staging buffers belong to the side stream, so the copy need
        # not wait for the decode queued on the current one.
        with torch.cuda.stream(side):
            k_dev = _from_np(k_chunk, self.cfg.dtype).to(self.device,
                                                         non_blocking=True)
            v_dev = _from_np(v_chunk, self.cfg.dtype).to(self.device,
                                                         non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        self._pinned = (ready, k_chunk, v_chunk)
        return StagedActivation(tuple(misses), k_dev, v_dev,
                                self._drain_epoch, ready)

    def _release_pinned(self) -> None:
        """Drop the last prefetch's pinned chunks once their copy has
        finished.  A decode turn runs between two prefetches, so the wait
        is normally empty."""
        if self._pinned is not None:
            self._pinned[0].synchronize()
            self._pinned = None

    def activate(self, seq_ids: Sequence[int], new_tokens: int,
                 staged: Optional["StagedActivation"] = None
                 ) -> PagedKVCache:
        """Fault the group's pages device-side; return a decode view.

        Pages covering each sequence's current tokens plus `new_tokens`
        of growth become slot-resident and pinned until ``sync_from``.
        ``staged`` (from a prior ``prefetch`` of the same group) serves
        the uploads from device-staged bytes when its page list still
        matches; a stale staging falls back to the synchronous path.
        The view shares the slot pool (``k_slots``/``v_slots``).

        On failure (slot pool exhausted, backing read error) every pin
        taken by this call is rolled back and evicted-but-unfilled slots
        rejoin the LRU, so a failed activation never shrinks the pool
        visible to later ones.
        """
        pinned_before = set(self._active_slots)
        lru_before = list(self._lru)
        uploads, upload_bytes = (self.stats["uploads"],
                                 self.stats["upload_bytes"])
        with _span("tier.activate") as sp:
            try:
                return self._activate_body(seq_ids, new_tokens, staged)
            except BaseException:
                self._active_slots = pinned_before
                # Rebuild the LRU in its pre-call order: slots _evict_for
                # removed rejoin at their old (cold) position whether or
                # not they were flushed, and slots added mid-call keep a
                # warm position at the tail.
                self._lru = dict.fromkeys(lru_before) | self._lru
                raise
            finally:
                sp.obj = self.stats["uploads"] - uploads
                sp.nbytes = self.stats["upload_bytes"] - upload_bytes

    def _activate_body(self, seq_ids: Sequence[int], new_tokens: int,
                       staged: Optional["StagedActivation"] = None
                       ) -> PagedKVCache:
        self.stats["activations"] += 1
        m, P = self.pages_per_seq, self.page_size
        # Heat decays once per activation wave; the covered pages are
        # bumped below.
        self._page_heat *= self.heat_decay
        # Ring pressure valve runs FIRST, before anything reads
        # _victim_map: a drain clears the map, so firing it between the
        # miss-list computation and the victim-restore below would leave
        # victim-hit pages with neither an upload nor a restore.
        self._maybe_drain_for_cap()
        # ONE page walker shared with prefetch().
        needed = self._needed_pages(seq_ids, new_tokens)
        needed_set = set(needed)
        # Pin the group's already-resident slots BEFORE any eviction, so
        # a large activation can never reclaim a page this same group
        # still needs.
        for b in seq_ids:
            npages = min(m, (int(self.seq_lens[b]) + new_tokens + P - 1) // P)
            npages = max(npages, 1)
            base = b * m
            for pg in range(npages):
                page = base + pg
                self._page_heat[page] += 1.0
                if page in needed_set:
                    continue
                s = self.slot_of[page]
                if s >= 0:
                    self._touch_lru(int(s))
                    self._active_slots.add(int(s))

        if needed:
            slots = self._evict_for(len(needed))
            # Slot bookkeeping for the WHOLE group (victim hits get a
            # slot too; their bytes arrive via the device-side restore
            # below, never over the transport).
            for page, s in zip(needed, slots):
                self.slot_of[page] = s
                self.slot_owner[s] = page
                self._lru[s] = None
                self._active_slots.add(int(s))
                # Fresh tenant: any stale dirty bit from the previous
                # occupant must not survive into the new page.
                self._dirty_slots.discard(int(s))
            misses = [p for p in needed if p not in self._victim_map]
            if misses:
                if (staged is not None and staged.pages == tuple(misses)
                        and staged.epoch == self._drain_epoch):
                    # Bytes already staged on the device by prefetch():
                    # faults, backing reads and the host->device copy
                    # all ran under the previous group's compute.
                    k_up, v_up = staged.k_dev, staged.v_dev
                    if staged.ready is not None:
                        cur = torch.cuda.current_stream(self.device)
                        cur.wait_event(staged.ready)
                        # Used here too: the allocator must not hand the
                        # side stream these blocks before the scatter ran.
                        k_up.record_stream(cur)
                        v_up.record_stream(cur)
                    self.stats["prefetched_uploads"] += len(misses)
                else:
                    # Synchronous path (no/stale staging): fault + fetch
                    # through the backing, then upload.
                    k_up, v_up = self._upload(
                        *self.backing.read_pages(misses))
                idx = _index([int(self.slot_of[p]) for p in misses],
                             self.device)
                _scatter_pages(self.k_slots, idx, k_up)
                _scatter_pages(self.v_slots, idx, v_up)
                self.stats["uploads"] += len(misses)
                self.stats["upload_bytes"] += (2 * len(misses) *
                                               self.page_bytes *
                                               self.cfg.num_layers)
            # Restore pages with live victim entries: the victim entry
            # holds the page's full truth at eviction.  Entries stay LIVE
            # and the restored slots stay CLEAN: slot == entry content, so
            # a later clean eviction drops the slot for free and the entry
            # remains the truth.
            hits = [p for p in needed if p in self._victim_map]
            if hits:
                _victim_restore(
                    self.k_slots, self.v_slots, self._victim_k,
                    self._victim_v,
                    _index([self._victim_map[p] for p in hits], self.device),
                    _index([int(self.slot_of[p]) for p in hits],
                           self.device))
                self.stats["victim_restores"] += len(hits)

        # Map the group's pages onto slots (entries past the resident
        # span are masked by seq_lens in attention).
        table = np.zeros((len(seq_ids), m), np.int32)
        for i, b in enumerate(seq_ids):
            base = b * m
            live = min(m, (int(self.seq_lens[b]) + new_tokens + P - 1) // P)
            for pg in range(m):
                s = self.slot_of[base + pg]
                if s >= 0:
                    table[i, pg] = s
                    self._active_slots.add(int(s))
                elif pg < live:
                    raise RuntimeError(
                        f"seq {b} page {pg} lost its slot during "
                        f"activation — slot pool too small for the group")
        return PagedKVCache(
            cfg=self.cfg, page_size=P,
            k_pages=self.k_slots, v_pages=self.v_slots,
            page_table=_h2d(table, self.device),
            seq_lens=_h2d(self.seq_lens[np.array(seq_ids)], self.device))

    def pages_of(self, b: int, new_tokens: int = 0) -> List[int]:
        """Logical pages sequence ``b`` covers at its current length
        (plus ``new_tokens`` of projected growth) — the covered working
        set (always at least one page, the activation floor)."""
        P, m = self.page_size, self.pages_per_seq
        n = min(m, max(1, (int(self.seq_lens[b]) + new_tokens + P - 1)
                       // P))
        return list(range(b * m, b * m + n))

    def seq_heat(self, b: int, new_tokens: int = 0) -> float:
        """Decayed activation heat summed over sequence ``b``'s covered
        pages: lower means its pages were activated less recently/often."""
        return float(sum(self._page_heat[p]
                         for p in self.pages_of(b, new_tokens)))

    def page_heat(self, page: int) -> float:
        return float(self._page_heat[page])

    def set_last_tokens_dev(self, seq_ids: Sequence[int],
                            toks: torch.Tensor) -> None:
        """Park the group's last tokens ON DEVICE (no readback);
        decode_rounds picks them up, host readers get them at the next
        materialize."""
        self._last_token_dev[tuple(int(b) for b in seq_ids)] = toks

    def materialize(self, seq_ids: Optional[Sequence[int]] = None
                    ) -> np.ndarray:
        """Fold device-parked last tokens into host ``last_token``.

        ``seq_ids=None`` materializes every parked group; otherwise only
        groups overlapping the given sequences.  Costs one device
        readback per parked group.  Returns ``last_token`` (the requested
        sequences' slice when ``seq_ids`` is given)."""
        ids = None if seq_ids is None else {int(b) for b in seq_ids}
        for key in list(self._last_token_dev):
            if ids is None or set(key) & ids:
                self.last_token[np.array(key)] = _to_np(
                    self._last_token_dev.pop(key)).astype(np.int32)
        if seq_ids is None:
            return self.last_token
        return self.last_token[np.array(list(seq_ids), dtype=np.intp)]

    def sync_from(self, view: PagedKVCache, seq_ids: Sequence[int],
                  last_tokens: Optional[np.ndarray] = None,
                  decoded: int = 0,
                  host_lens: Optional[np.ndarray] = None) -> None:
        """Adopt the decode view's pool + lengths; unpin the group.

        Length bookkeeping is HOST-side arithmetic (`decoded` tokens were
        appended per sequence), so no readback of view.seq_lens is
        needed unless lengths are adopted from the view."""
        with _span("tier.sync_from", obj=len(seq_ids)):
            self._sync_from(view, seq_ids, last_tokens, decoded, host_lens)

    def _sync_from(self, view: PagedKVCache, seq_ids: Sequence[int],
                   last_tokens: Optional[np.ndarray], decoded: int,
                   host_lens: Optional[np.ndarray]) -> None:
        self.k_slots = view.k_pages
        self.v_slots = view.v_pages
        idx = np.array(seq_ids)
        # Pages that received writes this turn: the span each sequence
        # appended ([len, len+decoded)), or everything it covers when
        # lengths are adopted from the view (prefill writes its whole
        # prompt span).
        P, m = self.page_size, self.pages_per_seq
        view_lens = None if decoded else (
            host_lens if host_lens is not None
            else _to_np(view.seq_lens))
        for i, b in enumerate(seq_ids):
            if decoded:
                old = int(self.seq_lens[b])
                new = min(old + decoded, m * P)
            else:
                old = 0                      # prefill wrote [0, new)
                new = int(view_lens[i])
            first_pg = old // P
            last_pg = min(m - 1, max(new - 1, 0) // P)
            for pg in range(first_pg, last_pg + 1):
                slot = int(self.slot_of[b * m + pg])
                if slot >= 0:
                    self._dirty_slots.add(slot)
        if decoded:
            self.seq_lens[idx] = np.minimum(
                self.seq_lens[idx] + decoded,
                self.pages_per_seq * self.page_size)
        else:
            self.seq_lens[idx] = view_lens
        if last_tokens is not None:
            self.last_token[idx] = np.asarray(last_tokens)
        self._active_slots.clear()

    def _write_back(self, pairs: List[Tuple[int, int]]) -> None:
        """Synchronously materialize (slot, page) pairs into the
        backing (one batched device readback) and clear their dirty
        bits.  Shared by the ring-spill path and flush_group."""
        if not pairs:
            return
        n = len(pairs)
        nbytes = 2 * n * self.cfg.num_layers * self.page_bytes
        with _span("tier.download", obj=n, nbytes=nbytes):
            idx = _index([s for s, _ in pairs], self.device)
            k_c = _to_np(_gather_pages(self.k_slots, idx))
            v_c = _to_np(_gather_pages(self.v_slots, idx))
        with _span("tier.writeback", obj=n, nbytes=nbytes):
            for i, (slot, page) in enumerate(pairs):
                self.backing.write_page(page, k_c[:, i], v_c[:, i])
                self._dirty_slots.discard(slot)

    def flush_group(self, seq_ids: Sequence[int]) -> None:
        """Write a group's dirty RESIDENT pages to the backing and mark
        them clean (one batched device readback).  A setup-time call —
        prefill marks every prompt page dirty, and flushing them here
        turns the decode phase's evictions of prompt pages into free
        clean drops instead of victim-ring traffic.  Any parked ring
        entries for these pages are superseded and recycle.  Parked last
        tokens of the group materialize here too."""
        with _span("tier.flush") as sp:
            self.materialize(seq_ids)
            m = self.pages_per_seq
            flush: List[Tuple[int, int]] = []       # (slot, page)
            for b in seq_ids:
                for pg in range(m):
                    page = b * m + pg
                    slot = int(self.slot_of[page])
                    if slot >= 0 and slot in self._dirty_slots:
                        flush.append((slot, page))
            if not flush:
                return
            sp.obj = len(flush)
            sp.nbytes = 2 * len(flush) * self.cfg.num_layers * \
                self.page_bytes
            t0 = time.monotonic_ns()
            self._write_back(flush)
            _utils.port_counter_add("tputier_flush_bytes", sp.nbytes)
            _utils.port_counter_add("tputier_flush_ns",
                                    time.monotonic_ns() - t0)
            self.stats["setup_flushes"] = \
                self.stats.get("setup_flushes", 0) + len(flush)
            for _, page in flush:
                e = self._victim_map.pop(page, None)
                if e is not None:
                    self._victim_free.append(e)

    def release_sequence(self, b: int, keep_len: bool = False) -> None:
        """Drop sequence ``b``'s device residency NOW (retire/preempt
        hook): its slots rejoin the LRU at the COLD end so the next
        activation reclaims them first, its victim-ring entries recycle,
        and any parked device tokens overlapping it fold to host.
        ``keep_len=True`` (preemption) preserves ``seq_lens`` — the
        sequence's KV truth stays in the backing keyed by its seq index,
        ready for a later restore; the default (retire) resets the length
        so a new request can reuse the slot.

        DIRTY slots are NOT written back here — callers that need the
        backing current (preemption) must ``flush_group([b])`` first."""
        with _span("tier.release", obj=b):
            self._release_sequence(b, keep_len)

    def _release_sequence(self, b: int, keep_len: bool) -> None:
        self.materialize([b])
        m = self.pages_per_seq
        if keep_len and any((b * m + pg) in self._victim_map
                            for pg in range(m)):
            # A victim-ring entry can be the ONLY copy of an evicted
            # dirty page: a preempted sequence must materialize those
            # into the backing before the entries recycle.
            self.drain_flushes()
        freed_cold: List[int] = []
        freed_warm: List[int] = []
        for pg in range(m):
            page = b * m + pg
            s = int(self.slot_of[page])
            if s >= 0:
                self.slot_of[page] = -1
                self.slot_owner[s] = -1
                self._dirty_slots.discard(s)
                self._active_slots.discard(s)
                if s in self._lru:
                    del self._lru[s]
                # A released-but-HOT page of a still-live sequence
                # (keep_len preempt) reinserts at the WARM end; retire
                # always goes cold.
                if keep_len and \
                        self._page_heat[page] >= self.release_warm_heat:
                    freed_warm.append(s)
                else:
                    freed_cold.append(s)
            e = self._victim_map.pop(page, None)
            if e is not None:
                self._victim_free.append(e)
        if freed_cold:
            # Cold end = FRONT of the insertion-ordered dict.
            self._lru = dict.fromkeys(freed_cold) | self._lru
        for s in freed_warm:
            self._lru[s] = None            # warm end (tail)
        if freed_warm:
            self.stats["warm_reinserts"] += len(freed_warm)
        if not keep_len:
            self.seq_lens[b] = 0
            self.last_token[b] = 0
            # Retired KV is garbage: its pages are definitionally cold.
            self._page_heat[b * m:(b + 1) * m] = 0.0
        self.stats["releases"] = self.stats.get("releases", 0) + 1

    def close(self) -> None:
        try:
            # Parked tokens materialize first: last_token must hold the
            # true final tokens after close, never stale zeros.
            self.materialize()
            self.drain_flushes()
            self._release_pinned()
        finally:
            self.backing.close()


def prefill_group(cfg: llama.LlamaConfig, params: Dict,
                  cache: TieredKVCache, seq_ids,
                  prompt: torch.Tensor) -> None:
    """Prefill a group of sequences into the tiered cache.  The group's
    pages are flushed to the backing before returning (setup cost), so the
    decode phase starts with a clean pool and its evictions of prompt
    pages are free drops.  The prompt's last tokens park on the device
    until the flush, which folds them to host, so ``cache.last_token`` is
    correct right after prefill."""
    kv_token_bytes = 2 * cfg.num_layers * cache.page_bytes // cache.page_size
    with _span("serve.prefill_group", obj=len(seq_ids),
               nbytes=int(prompt.numel()) * kv_token_bytes):
        view = cache.activate(seq_ids, new_tokens=prompt.shape[1])
        logits, view = prefill(cfg, params, prompt, view)
        cache.sync_from(view, seq_ids, decoded=0,
                        host_lens=np.full((len(seq_ids),), prompt.shape[1],
                                          np.int32))
        cache.set_last_tokens_dev(
            seq_ids, torch.argmax(logits, dim=-1).to(torch.int32))
        cache.flush_group(seq_ids)


def decode_rounds(cfg: llama.LlamaConfig, params: Dict,
                  cache: TieredKVCache, groups, tokens_per_turn: int,
                  turns: int, force: bool = True) -> Tuple[int, float]:
    """Round-robin grouped decode: each turn activates one group and
    decodes ``tokens_per_turn`` for it — the config #4 serving shape
    (many resident sequences, an active working set cycling through the
    device pool).  Returns (decoded tokens, seconds).

    Software pipeline over the turn schedule: after queueing group A's
    decode on the device (asynchronous: the host regains control at once),
    the host prefetches group B's activation — faulting B's missing pages
    through the UVM backing and copying the bytes to a device staging
    buffer on a side stream — under A's compute.  B's activate() then
    only picks slots and scatters on the device."""
    # Device-resident token caching assumes DISJOINT groups.
    seen: set = set()
    for g in groups:
        for b in g:
            if b in seen:
                raise ValueError(f"groups must be disjoint (seq {b})")
            seen.add(b)

    total = 0
    t0 = time.perf_counter()
    # Last-token state stays ON DEVICE per group between its turns.
    dev_tok: Dict[Tuple[int, ...], torch.Tensor] = {}
    schedule = [g for _ in range(turns) for g in groups]
    staged: Dict[Tuple[int, ...], StagedActivation] = {}
    try:
        for i, g in enumerate(schedule):
            key = tuple(g)
            view = cache.activate(g, new_tokens=tokens_per_turn,
                                  staged=staged.pop(key, None))
            tok = dev_tok.get(key)
            if tok is None:
                tok = cache._last_token_dev.pop(key, None)
            if tok is None:
                # Grouping differs from the one that parked tokens:
                # materialize any parked groups overlapping this one
                # into host last_token first, or decode would seed from
                # stale host tokens.
                for pk in [k for k in list(cache._last_token_dev)
                           if set(k) & set(int(b) for b in g)]:
                    cache.last_token[np.array(pk)] = _to_np(
                        cache._last_token_dev.pop(pk)).astype(np.int32)
                tok = _h2d(cache.last_token[np.array(g)], cache.device)
            tok, view, _ = decode_scan(cfg, params, tok, view,
                                       tokens_per_turn)
            dev_tok[key] = tok
            cache.sync_from(view, g, decoded=tokens_per_turn)
            if i + 1 < len(schedule):
                nxt = schedule[i + 1]
                staged[tuple(nxt)] = cache.prefetch(
                    nxt, new_tokens=tokens_per_turn)
            total += len(g) * tokens_per_turn
    finally:
        # force=True: materialize final tokens once — ALSO on error
        # paths, so cache.last_token stays consistent with the seq_lens
        # that already advanced for completed turns.  force=False parks
        # them on the device for the next rounds to pick up.
        for g, tok in dev_tok.items():
            if force:
                cache.last_token[np.array(g)] = _to_np(tok).astype(np.int32)
            else:
                cache._last_token_dev[g] = tok
    return total, time.perf_counter() - t0
