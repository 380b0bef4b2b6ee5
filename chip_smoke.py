#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``open_gpu_kernel_modules_tpu_torch/ops/
csrc`` with nvcc (and the native UVM engine with ``make -C native``, at the
same time), holds each kernel against its plain PyTorch version at the
shapes Llama-3-8B gives it, then drives the port's paths at full Llama-3-8B
width (random weights from a seed):

1. identify the card, build the kernels and the native library; count the
   tensor-core products (HGMMA) and TMA loads (UTMALDG) in the SASS of the
   two flash libraries, and the tensor-core products (HMMA) and async
   copies (UBLKCP, UTMALDG or LDGSTS) in paged decode's, and fail if any
   kind is missing;
2. paged decode (B1) against its reference, bf16 and fp32, ragged lengths;
   then bf16 at the shapes of dense serving (the main one), of a tiered
   decode group, of one 8192-token context and of a large batch, and the
   main grid with one live token per sequence (the latency floor), each
   with its splits, time, bound, SDPA's time and the host's enqueue time;
3. flash attention (B2, ``impl="grid"``) against its reference, causal and
   full, odd length, both layouts, with each case's TFLOP/s; and at the
   head_dims the wrapper zero-pads (16, 32, 96), bf16 and fp32, with the
   padding copies' time;
4. row-resident flash attention (B3, ``impl="rows"``) on B2's cases plus a
   short row that fits shared memory whole; its entry point driven once at
   its two main shapes (S=256 and S=2048);
5. serving: ``generate`` on 8 prompts of 512 tokens, 32 new tokens each,
   through the paged-decode kernel; the last decode logits are held against
   a dense ``forward`` over the same tokens;
6. ``forward(use_flash=True)`` at S=2048 against ``forward(use_flash=False)``;
7. tiered serving (BASELINE config #4): ``TieredKVCache`` over the UVM
   engine, 16 sequences of 512-token prompts (max_len 576) in groups of 4,
   ``prefill_group`` then ``decode_rounds`` (8 tokens a turn, 2 turns), at
   ``oversub`` 1 and then 4; the greedy tokens of the two runs must be
   equal, and equal to a dense ``generate`` of the first group; the
   ``oversub=4`` run must park written pages in the victim ring;
8. scheduler: the continuous-batching ``Scheduler`` over the tiered cache,
   8 streams of 504-token prompts, 64 new tokens each, 8 a round (5
   submitted, two rounds, then 3 more mid-decode): run A at ``oversub`` 1,
   runs D1, N1, N2, D2 in that order, each A with streams on tenants
   i % 2 and every ``step`` inside a ``utils.span`` application span, the
   N runs with the native trace armed for the whole run (their tokens must
   equal A's; in each N the ``sched.round``, ``sched.admit`` and step-span
   histograms must count its rounds and admissions, the Chrome export must
   parse and hold both span kinds and a request's flow start paired with a
   finish on another thread, each tenant's ITL and TTFT series must count
   its tokens and streams, every flow ledger must close within its wall,
   and the scrape must match the stats and the ring accounting; it prints
   the N runs' tok/s against the D runs' (the cost of arming) and A's, the
   trace's ring accounting, the ``sched.round`` and ``fault.latency``
   quantiles and the export's size), run A' the same
   as A with three forced device resets (its tokens must equal A's), run B
   at ``oversub`` 2, where decode growth must preempt and every preempted
   stream must be restored, and an untimed run T, A again with one steady
   round traced by the profiler (its tokens must equal A's); B1 must launch
   once per layer per decode step of every round, and no flash kernel;
9. multichip (BASELINE config #5): the KV pool striped over four native
   device arenas (``TPUMEM_FAKE_TPU_COUNT=4``, set before the engine loads)
   and moved over its ICI model, in pages of 16 tokens (a page's record is
   one PMM chunk, at most the engine's 2 MiB block).  M1: phase 7's decode
   over ``make_multichip_cache`` with the direct 0<->1 link failed before
   the last turn; its tokens must equal an ``oversub=4`` managed tiered run
   of the same shape, records must cross ICI both ways, and the 0->3 detour
   must carry traffic.  M2_0
   and M2: the ``Scheduler`` over the pool on phase 8's shape at oversub 2,
   without and with evacuations (1->2, a 2->3 that the ``vac.migrate``
   inject site forces to abort, 0->1, then chip 3 on the reset watchdog's
   request); M3: disaggregated (``DisaggConfig(decode_devs=(1, 2, 3))``)
   through a device reset and an evacuation of a decode home.  Every stream
   must finish, committed moves empty their source, tenant charges follow
   the homes, vac's inject site reconciles; tokens decoded before the first
   evacuation must equal M2_0's (all of them when every round's batch
   matched); B1 must launch once per layer per decode step, no flash kernel.
   After M1 the failed link is reset and trained (``ici.reset_link``,
   ``ici.train_links``): it must report ACTIVE, route 0 -> 1 in one hop,
   count its training and carry a record to chip 1 directly;
10. real arena (BASELINE configs #2 and #1): device 0's arena registered as
   REAL, its HBM tier mirrored onto the card by ``runtime.hbm.HbmRuntime``
   (drain thread, copy stream, page-locked shadow) at its defaults.  Two
   device passes over 4x the arena in 32 MB managed slices, the slices'
   first device touch (cold, bench.py's shape), the fence inside the timed
   span; then warm pairs of the same passes, REAL, alone, alone, REAL (the
   arena not REAL while alone).  After each REAL pair every HBM-resident
   page is read on the card and must hold its pattern, the engine must
   have evicted, and the bytes uploaded (less resyncs) must be positive
   and at most what the engine published.  Then
   an explicit 256 MiB migrate checked on the card; one ``MemRing`` batch
   of 256 MIGRATEs of 64 KiB behind a ring FENCE (bench.py:346's shape),
   its pages checked on the card and the ring's counts exact; a card
   computation
   written back through ``write_arena`` that a CPU read (sync) and a
   migration home (left chip-dirty) must carry; suspend/resume, after which
   the card must show the restored bytes; a forced mirror-queue overflow
   whose resync the card must show; and 64 MiB of CXL P2P DMA each way
   through ``RmClient``, the card's bytes going out.  Launches none of the
   three kernels.  Prints one ``{"hbm_real": {...}}`` line: chip-verified
   and engine GB/s, the upload busy share, fault p50/p95/p99 and wake/svc
   p50 µs, evictions, resyncs, CE channel bytes, in-HBM copy GB/s and the
   north-star ratio, migrate, ring-migrate and CXL GB/s, all of the cold
   pair; and the warm pairs' engine GB/s, REAL against alone;
11. training (runs last: its steps update the parameters in place):
   ``loss_fn``, ``.backward()`` and JAX's SGD update, three times on one
   seeded B=1 x S=1024 batch at 32 layers, bf16; the losses finite, every
   gradient leaf finite and non-zero, the autograd loss equal to a
   ``no_grad`` one; step ms, training tok/s, peak memory and the busy share
   of one profiled, untimed step; then at 2 layers, fp32, S=128 the card's
   loss and the gradients of wq[0] and lm_head against the CPU's.  No kernel
   launches;
12. parallel (runs after phase 4, before the 8B parameters exist): eight
   rank processes on the card over gloo (``parallel.mesh.BACKEND``).  (a)
   ``entry.dryrun_multichip(8)`` as a user calls it; (b) dp2 x tp2 x sp2 at
   Llama-3-8B widths cut to 2 layers, tokens (4, 256): the sharded SGD
   step's loss, the updated shards and gradients of wq[0], wo[0] and
   lm_head against one unsharded step computed first; ring and Ulysses
   attention at S=2048, H=32, D=128 equal at fp32 and each within the flash
   limits of the plain fp32 version in bf16.  B2 launches inside the ranks'
   Ulysses calls count toward its ``launches``;
13. chaos and containment (after phase 10, before phase 11), the JAX
   package's tests/test_stress.py soak and containment at full width on
   phase 8's prompts: 4 slots at oversub 4, 32 new tokens, 4 a round, tenant
   i % 2, streams 5 and 6 cancelled after round 3.  (a) an uninjected
   reference; (a1) every inject site at 1% (dump.write 12.5%); (a2) the
   soak: every site at 1% but mem.corrupt at SOAK_CORRUPT_PPM, three forced
   device resets; (b) scoped one-shot mem.corrupt flips on a parked
   stream's K page, a fresh scheduler on the same arena (its batches and
   tokens the reference's), and on phase 9's pool an evacuation 1 -> 2
   under mem.corrupt every second evaluation (its tokens held to M2_0's).
   The JAX tests' invariants hold: streams finished or ERROR (poisoned, or
   unservable once every slot is retired) or cancelled, each poison costing
   its own stream and slot and never a reset, resets = forced + injected,
   shield, dump.write, hot.decide, journal, spine and vac reconciliations;
   tokens equal the reference's in the rounds whose decode batch matched;
   every arm is taken back, and no site hits afterwards.  Prints hits per
   site, MTTR p50 and max, blackouts, rounds, tok/s and the scrub pass.

Prints one ``{"kernels": [...]}`` line with each kernel's launches on the
main path, its error against the plain version, its time, its bound, the
plain version's time, one PyTorch library call's time and the body it runs
for bf16 and for fp32 (``tensor_cores`` or ``fma``); then the card's
name and power limit; and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, without CUDA or when any check fails.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12,     # dense tensor-core bf16
              torch.float32: 67e12}       # fp32 on the CUDA cores
# Kernel against plain version, (atol, rtol): bf16 allows two bf16 ulps
# (2 * 2^-7 relative) on top of 2e-2, since the kernels round the pre-scaled
# Q and P to bf16 where the plain versions keep fp32; fp32 only differs in
# the order of sums.
TOL = {torch.bfloat16: (2e-2, 1.6e-2), torch.float32: (1e-4, 0.0)}
SEED = 0
# The native engine's fake device arena (TPUMEM_FAKE_HBM_MB, default 128):
# one full-width group faults about 300 MB through it.
ARENA_MB = 1024


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def log(*args) -> None:
    print(*args, flush=True)


GUARD_CYCLES = 200_000_000   # ~0.1 s of device sleep at H100 clocks


def cuda_ms(calls, iters: int = 20, warmup: int = 3, host: list = None
            ) -> float:
    """Mean device ms per call, by CUDA events, cycling through ``calls``
    (closures over distinct input copies, so repeated launches do not find
    their inputs in the 50 MB L2 cache).

    The timed launches are queued behind a device-side sleep, so the card
    runs them back to back and the events read device time, not the rate at
    which the host enqueues them.  Fails if the host took longer to enqueue
    than the sleep lasted.  Appends the host's enqueue ms per call to
    ``host`` when given."""
    for i in range(warmup):
        calls[i % len(calls)]()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(GUARD_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for i in range(iters):
        calls[i % len(calls)]()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    ev[2].synchronize()
    check(enqueue_ms < ev[0].elapsed_time(ev[1]),
          f"host enqueue ({enqueue_ms:.1f} ms) outlasted the device sleep")
    if host is not None:
        host.append(enqueue_ms / iters)
    return ev[1].elapsed_time(ev[2]) / iters


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def host_ms(fn, iters: int = 5) -> float:
    """Mean ms per call on the host clock, each call synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profiled(fn):
    """(host ms of one synchronised call of ``fn``, total ms of its CUDA
    kernels, [(name, ms)] of every kernel, largest first) from a
    torch.profiler trace; the kernel total is None when the trace holds no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(ms for _, ms in rows)
    return host, (total or None), sorted(rows, key=lambda r: -r[1])


def device_kernel_ms(fn):
    """(total ms of CUDA kernels in one call, [(name, ms)] of every kernel,
    largest first) after one warm-up call; (None, []) when the trace holds
    no device time."""
    fn()
    _, total, rows = profiled(fn)
    return (total, rows) if total else (None, [])


def reset_counts() -> None:
    """Zero every kernel's launch count, just before a main-path run."""
    from open_gpu_kernel_modules_tpu_torch.ops import (flash_attention,
                                                       paged_attention)
    paged_attention.launches = 0
    flash_attention.launches = 0
    flash_attention.rows_launches = 0


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def within_tol(out: torch.Tensor, ref: torch.Tensor) -> bool:
    atol, rtol = TOL[out.dtype]
    diff = (out.float() - ref.float()).abs()
    return bool((diff <= atol + rtol * ref.float().abs()).all())


# ------------------------------------------------------------------ phase 1

def phase_build():
    from open_gpu_kernel_modules_tpu_torch.ops import _build
    from open_gpu_kernel_modules_tpu_torch.runtime import native
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}  ({torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    # The native library builds with make while nvcc builds the kernels.
    native_err = []

    def make():
        try:
            native.build_native()
        except Exception as e:          # reported after the join
            native_err.append(e)
    maker = threading.Thread(target=make)
    maker.start()
    try:
        logs = _build.build_all()
    finally:
        maker.join()
    if native_err:
        raise native_err[0]
    log(f"build: {time.perf_counter() - t0:.1f} s (kernels and "
        f"native/build/libtpurm.so)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    check_sass(_build)
    return smi


# Per library: kinds of instruction its SASS must hold, each kind a tuple of
# opcodes of which at least one must appear.
SASS_KINDS = {
    "flash_attn": {"tensor cores": ("HGMMA",), "TMA loads": ("UTMALDG",)},
    "flash_rows": {"tensor cores": ("HGMMA",), "TMA loads": ("UTMALDG",)},
    "paged_decode": {"tensor cores": ("HMMA", "HGMMA"),
                     "async copies": ("UTMALDG", "UBLKCP", "LDGSTS")},
}


def check_sass(_build) -> None:
    """Each kernel library's machine code must hold its tensor-core products
    and its asynchronous copies (SASS_KINDS)."""
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    for name, kinds in SASS_KINDS.items():
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(_build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = {op: sass.count(op) for ops in kinds.values() for op in ops}
        log(f"  {name} SASS: {counts}")
        for kind, ops in kinds.items():
            check(any(counts[op] for op in ops),
                  f"{name}: no {kind} ({' or '.join(ops)}) in its SASS")


# ------------------------------------------------------------------ phase 2

def paged_case(b, h, kv, d, p, m, lens, dtype, copies, gen):
    """Random pool and permuted page table; returns the kernel's record."""
    from open_gpu_kernel_modules_tpu_torch.ops.paged_attention import (
        body, paged_attention, paged_attention_reference, split_plan)
    n = b * m
    args = []
    for _ in range(copies):
        q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
        kp = torch.randn((n, p, kv, d), generator=gen, device="cuda").to(dtype)
        vp = torch.randn((n, p, kv, d), generator=gen, device="cuda").to(dtype)
        table = torch.randperm(n, generator=gen, device="cuda").to(
            torch.int32).reshape(b, m)
        args.append((q, kp, vp, table,
                     torch.tensor(lens, dtype=torch.int32, device="cuda")))
    out = paged_attention(*args[0], h)
    ref = paged_attention_reference(*args[0], h)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    check(bool(torch.isfinite(out).all()), "paged decode: non-finite output")
    zero_rows = [i for i, s in enumerate(lens) if s == 0]
    check(all(float(out[i].abs().max()) == 0.0 for i in zero_rows),
          "paged decode: seq_len=0 row is not zero")
    check(within_tol(out, ref), f"paged decode {dtype}: max err {err} "
          f"beyond (atol, rtol) {TOL[dtype]}")

    item = torch.tensor([], dtype=dtype).element_size()
    live = sum(min(max(s, 0), m * p) for s in lens)
    nbytes = (2 * live * kv * d * item + 2 * b * h * d * item +
              4 * b + 4 * sum(-(-min(s, m * p) // p) for s in lens))
    flops = 4 * live * h * d
    bms, by = bound_ms(nbytes, flops, dtype)
    host = []
    ms = cuda_ms([lambda a=a: paged_attention(*a, h) for a in args],
                 host=host)
    plain = cuda_ms([lambda a=a: paged_attention_reference(*a, h)
                     for a in args], iters=5)

    # Library yardstick, timed here only: SDPA over the K/V gathered into
    # dense [B, KV, M*P, D] tensors (the gather itself is not timed).
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_args = []
    for q, kp, vp, table, sl in args:
        kd = kp[table.long()].reshape(b, m * p, kv, d).transpose(1, 2)
        vd = vp[table.long()].reshape(b, m * p, kv, d).transpose(1, 2)
        mask = (torch.arange(m * p, device="cuda")[None, :] <
                sl[:, None])[:, None, None, :]
        lib_args.append((q[:, :, None, :], kd.contiguous(), vd.contiguous(),
                         mask))
    lib = cuda_ms([lambda a=a: sdpa(a[0], a[1], a[2], attn_mask=a[3],
                                    enable_gqa=True) for a in lib_args])
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
               bound_by=by, library_ms=lib)
    pps, splits = split_plan(b * kv, m)
    shown = lens if len(lens) <= 8 else f"{lens[:4]}...({len(lens)})"
    log(f"B1 paged decode {str(dtype)[6:]} ({body(dtype, h // kv, d)}) B={b} "
        f"H={h} KV={kv} D={d} P={p} M={m} lens={shown}: {splits} splits of "
        f"{pps} pages, {b * kv * splits} CTAs: " + json.dumps(rec)
        + f"; {rec['ms'] / bms:.2f}x bound, {rec['ms'] / lib:.2f}x SDPA; "
        f"host enqueue {host[0]:.4f} ms/call")
    return rec


def phase_paged():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ragged = [0, 1, 100, 2048, 777, 64, 1500, 3]
    for dtype in (torch.bfloat16, torch.float32):
        paged_case(8, 32, 8, 128, 64, 32, ragged, dtype, copies=4, gen=gen)
    # The shape the serving phase gives the kernel (prompt 512 + 32 new
    # tokens in pages of 64), cycled over enough pools to exceed L2.
    main = paged_case(8, 32, 8, 128, 64, 9, [544] * 8, torch.bfloat16,
                      copies=8, gen=gen)
    # A tiered decode group (4 of 16 sequences, permuted slot tables), one
    # Llama-3-8B context of 8192 tokens, and a large batch.
    paged_case(4, 32, 8, 128, 64, 9, [513, 518, 523, 528], torch.bfloat16,
               copies=16, gen=gen)
    paged_case(1, 32, 8, 128, 64, 128, [8192], torch.bfloat16, copies=4,
               gen=gen)
    paged_case(32, 32, 8, 128, 64, 32, [2048] * 32, torch.bfloat16,
               copies=2, gen=gen)
    # The latency floor: the main grid with one live token per sequence.
    paged_case(8, 32, 8, 128, 64, 9, [1] * 8, torch.bfloat16, copies=8,
               gen=gen)
    return main


# ------------------------------------------------------------------ phase 3

def flash_case(b, h, s, d, causal, layout, dtype, gen, copies=2,
               impl="grid"):
    from open_gpu_kernel_modules_tpu_torch.ops.flash_attention import (
        BODY, flash_attention, flash_attention_reference)
    shape = (b, h, s, d) if layout == "bhsd" else (b, s, h, d)
    args = [tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                  for _ in range(3)) for _ in range(copies)]
    kw = dict(causal=causal, layout=layout, impl=impl)
    counts = (flash_attention.launches, flash_attention.rows_launches)
    out = flash_attention(*args[0], **kw)
    rose = (flash_attention.launches - counts[0],
            flash_attention.rows_launches - counts[1])
    check(rose == ((0, 1) if impl == "rows" else (1, 0)),
          f"flash impl={impl} moved the (grid, rows) counts by {rose}")
    ref = flash_attention_reference(*args[0], causal=causal, layout=layout)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "flash: non-finite output")
    err = max_err(out, ref)
    check(within_tol(out, ref), f"flash {impl} {dtype} causal={causal} "
          f"{layout} S={s}: max err {err} beyond (atol, rtol) {TOL[dtype]}")

    item = torch.tensor([], dtype=dtype).element_size()
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    nbytes = 4 * b * h * s * d * item
    bms, by = bound_ms(nbytes, flops, dtype)
    host = []
    ms = cuda_ms([lambda a=a: flash_attention(*a, **kw) for a in args],
                 host=host)
    plain = cuda_ms([lambda a=a: flash_attention_reference(
        *a, causal=causal, layout=layout) for a in args], iters=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if layout == "bhsd":
        lib_args = args
    else:
        lib_args = [tuple(x.transpose(1, 2) for x in a) for a in args]
    lib = cuda_ms([lambda a=a: sdpa(*a, is_causal=causal) for a in lib_args])
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
               bound_by=by, library_ms=lib)
    if d not in (64, 128):
        # The wrapper zero-pads such a head_dim up to the kernel's width and
        # cuts the output back: the cost of those copies alone.
        width = 64 if d <= 64 else 128
        rec["pad_ms"] = cuda_ms([lambda a=a: (
            [torch.nn.functional.pad(x, (0, width - d)) for x in a],
            torch.nn.functional.pad(a[0], (0, width - d))[..., :d]
            .contiguous()) for a in args])
    log(f"{'B3 flash rows' if impl == 'rows' else 'B2 flash'} "
        f"{str(dtype)[6:]} ({BODY[dtype]}) B={b} H={h} S={s} D={d} "
        f"causal={causal} {layout}: " + json.dumps(rec)
        + f"; {flops / ms / 1e9:.1f} TFLOP/s (SDPA {flops / lib / 1e9:.1f}); "
        f"host enqueue {host[0]:.4f} ms/call")
    return rec


# B2's cases (b, h, s, d, causal, layout, dtype); the first is the main
# shape, the S=2048 prefill of one Llama-3-8B layer.
FLASH_CASES = [(1, 32, 2048, 128, True, "bshd", torch.bfloat16),
               (1, 32, 2048, 128, False, "bshd", torch.bfloat16),
               (1, 32, 1000, 128, True, "bshd", torch.bfloat16),
               (2, 8, 1000, 64, False, "bhsd", torch.bfloat16),
               (1, 8, 1000, 128, True, "bhsd", torch.float32),
               (1, 8, 333, 64, False, "bshd", torch.float32)]
# The head_dims the kernels take by zero-padding (16 and 32 run at 64, 96 at
# 128; tiny's head_dim is 16), each in bf16 and fp32.
PAD_CASES = [(1, 8, 1000, d, causal, layout, dtype)
             for d, causal, layout in ((16, True, "bshd"),
                                       (32, False, "bhsd"),
                                       (96, True, "bshd"))
             for dtype in (torch.bfloat16, torch.float32)]
# B3's own short case: a row that fits shared memory whole.
ROWS_SHORT = (4, 32, 256, 128, True, "bshd", torch.bfloat16)


def phase_flash():
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    recs = [flash_case(*c, gen) for c in FLASH_CASES + PAD_CASES]
    return recs[0]


# ------------------------------------------------------------------ phase 4

def phase_flash_rows():
    """B3 against its reference on B2's cases and its short case; then its
    entry point, counted, once at each of its two main shapes."""
    from open_gpu_kernel_modules_tpu_torch.ops.flash_attention import (
        flash_attention, rows_segment_tokens)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for b, h, s, d, causal, layout, dtype in [ROWS_SHORT] + FLASH_CASES:
        seg = rows_segment_tokens(s, s, d, dtype, causal)
        log(f"B3 S={s} D={d} {str(dtype)[6:]}: {seg} keys per segment, "
            f"{-(-s // seg)} segment(s) for the longest row")
    check(rows_segment_tokens(256, 256, 128, torch.bfloat16, True) >= 256,
          "B3: the short row does not fit shared memory whole")
    check(rows_segment_tokens(2048, 2048, 128, torch.bfloat16, True) < 2048,
          "B3: the S=2048 row was expected to need segments")
    recs = [flash_case(*c, gen, impl="rows") for c in [ROWS_SHORT]
            + FLASH_CASES + PAD_CASES]

    reset_counts()
    for b, h, s, d, causal, layout, dtype in (ROWS_SHORT, FLASH_CASES[0]):
        q, k, v = (torch.randn((b, s, h, d), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        out = flash_attention(q, k, v, causal=causal, impl="rows")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), "B3: non-finite output")
    launches = flash_attention.rows_launches
    check(launches == 2, f"B3 launched {launches} times, expected 2")
    check(flash_attention.launches == 0, "impl='rows' launched B2")
    return recs[1], launches


# ------------------------------------------------------------------ phase 5

def logits_tol(ref: torch.Tensor) -> float:
    """bf16 through 32 layers: both paths round every activation to bf16
    (8 significant bits) at different places, so the logits may differ by a
    few percent of their largest magnitude."""
    return 0.05 * float(ref.abs().max())


def phase_serving(cfg, params, gen):
    from open_gpu_kernel_modules_tpu_torch.models import llama, serving
    from open_gpu_kernel_modules_tpu_torch.ops import (flash_attention,
                                                       paged_attention)
    b, s, new = 8, 512, 32
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    tokens, cache, tps = serving.generate(cfg, params, prompt, new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    check(launches == cfg.num_layers * new,
          f"paged decode launched {launches} times, expected "
          f"{cfg.num_layers * new}")
    check(flash_attention.launches == 0, "serving launched the flash kernel")
    check(tokens.shape == (b, s + new), f"tokens shape {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "token out of vocabulary")
    check(bool((cache.seq_lens == s + new).all()), "seq_lens wrong")
    log(f"serving: generate B={b} prompt={s} new={new}: {tps:.1f} tok/s "
        f"decode, {wall:.2f} s wall incl. prefill; paged launches "
        f"{launches}")

    # One more decode step on the filled cache, held against a dense
    # forward over the same token stream.
    nxt = tokens[:, -1].to(torch.int32)
    dec, _ = serving.decode_step(cfg, params, nxt, cache)
    dense = llama.forward(cfg, params,
                          torch.cat([tokens, nxt[:, None].long()], 1))[:, -1]
    check(bool(torch.isfinite(dec).all()), "decode logits not finite")
    err = max_err(dec, dense)
    tol = logits_tol(dense)
    agree = float((dec.argmax(-1) == dense.argmax(-1)).float().mean())
    log(f"serving: decode vs dense logits max|diff| {err:.4g} (tol {tol:.4g},"
        f" max|logit| {float(dense.abs().max()):.4g}); argmax agreement "
        f"{agree:.3f}")
    check(err <= tol, "decode logits disagree with the dense forward")

    # Where a decode step's time goes: host clock against the sum of the
    # step's kernel times in a profiler trace (same step, same cache).
    def step():
        serving.decode_step(cfg, params, nxt, cache)
    step_ms = host_ms(step)
    dev_ms, rows = device_kernel_ms(step)
    busy = "not measured" if dev_ms is None else f"{dev_ms / step_ms:.3f}"
    b1_ms = sum(ms for name, ms in rows if "paged_decode" in name)
    log(f"serving: decode step {step_ms:.3f} ms (host clock, mean of 5); "
        f"kernels {dev_ms if dev_ms is None else round(dev_ms, 3)} ms, of "
        f"which B1 {b1_ms:.3f} ms; device busy share {busy}")
    for name, ms in rows[:5]:
        log(f"  {ms:8.3f} ms  {name[:90]}")
    return launches


# ------------------------------------------------------------------ phase 6

def phase_flash_forward(cfg, params, gen):
    from open_gpu_kernel_modules_tpu_torch.models import llama
    from open_gpu_kernel_modules_tpu_torch.ops import (flash_attention,
                                                       paged_attention)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    lf = llama.forward(cfg, params, tokens, use_flash=True)
    torch.cuda.synchronize()
    t_flash = time.perf_counter() - t0
    launches = flash_attention.launches
    check(launches == cfg.num_layers,
          f"flash launched {launches} times, expected {cfg.num_layers}")
    check(paged_attention.launches == 0, "forward launched the paged kernel")
    t0 = time.perf_counter()
    ld = llama.forward(cfg, params, tokens, use_flash=False)
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    check(bool(torch.isfinite(lf).all()), "flash forward logits not finite")
    err = max_err(lf, ld)
    tol = logits_tol(ld)
    log(f"flash forward B=1 S=2048: {t_flash * 1e3:.1f} ms (flash) vs "
        f"{t_dense * 1e3:.1f} ms (plain attention), first calls; logits "
        f"max|diff| {err:.4g} (tol {tol:.4g}); flash launches {launches}")
    check(err <= tol, "flash forward logits disagree with the plain forward")
    return launches


# ------------------------------------------------------------------ phase 7

# max_len 576 (9 pages of 64) makes the 4x-oversubscribed slot pool hold
# exactly one group (36 slots), so every activation evicts the previous
# group's written pages into the victim ring.  At max_len 1024 the pool
# (64 slots) always keeps enough clean slots for a 36-page group, and the
# clean-first eviction order never parks a written page: no flush at all.
TIERED = dict(seqs=16, prompt=512, max_len=576, page=64, group=4,
              tokens_per_turn=8, turns=2)


def _timed(fn, into):
    def call(*a, **k):
        t1 = time.perf_counter()
        out = fn(*a, **k)
        into.append((time.perf_counter() - t1) * 1e3)
        return out
    return call


def time_activations(cache) -> dict:
    """Host-clock every activation (``act`` without a staged prefetch,
    ``commit`` with one), every prefetch (``pre``) and the backing's page
    reads inside them (``read``); ``under`` records whether the decode
    queued before a prefetch was still running when the prefetch returned
    (its copy then ran fully under the decode).  Returns the sample lists,
    which fill as the cache runs."""
    ms = {k: [] for k in ("act", "commit", "pre", "read", "under")}
    activate, prefetch = cache.activate, cache.prefetch

    def timed_activate(*a, staged=None, **k):
        t1 = time.perf_counter()
        view = activate(*a, staged=staged, **k)
        ms["act" if staged is None else "commit"].append(
            (time.perf_counter() - t1) * 1e3)
        return view

    def timed_prefetch(*a, **k):
        busy = torch.cuda.Event()
        busy.record()
        t1 = time.perf_counter()
        staged = prefetch(*a, **k)
        ms["pre"].append((time.perf_counter() - t1) * 1e3)
        ms["under"].append(not busy.query())
        return staged

    cache.activate, cache.prefetch = timed_activate, timed_prefetch
    cache.backing.read_pages = _timed(cache.backing.read_pages, ms["read"])
    return ms


def activation_record(ms: dict) -> dict:
    def mean(k):
        return sum(ms[k]) / max(len(ms[k]), 1)
    return dict(
        unstaged_activations=len(ms["act"]),
        unstaged_activate_host_ms_mean=mean("act"),
        staged_activations=len(ms["commit"]),
        staged_activate_host_ms_mean=mean("commit"),
        prefetch_host_ms_mean=mean("pre"),
        page_reads=len(ms["read"]), read_pages_ms_mean=mean("read"),
        prefetches_under_decode=f"{sum(ms['under'])} of {len(ms['under'])}")


def tiered_run(cfg, params, prompts, oversub, page=TIERED["page"]):
    """One tiered serving run in pages of ``page`` tokens: prefill every
    group, then decode_rounds.  Returns (last tokens, stats, record of
    host-side measurements)."""
    from open_gpu_kernel_modules_tpu_torch.models import serving
    from open_gpu_kernel_modules_tpu_torch.uvm import fault_stats
    t = TIERED
    groups = [list(range(i, i + t["group"]))
              for i in range(0, t["seqs"], t["group"])]
    t0 = time.perf_counter()
    cache = serving.TieredKVCache(cfg, t["seqs"], t["max_len"],
                                  page_size=page, oversub=oversub)
    setup_s = time.perf_counter() - t0
    # Host time of every activation and prefetch, of the backing's page
    # reads inside them and of the UVM fault pass inside those.
    ms = time_activations(cache)
    fault_ms = []
    backing = cache.backing
    backing._ring_fault_pages = _timed(backing._ring_fault_pages, fault_ms)
    try:
        t0 = time.perf_counter()
        for g in groups:
            serving.prefill_group(cfg, params, cache, g, prompts[g])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        before = dict(cache.stats)
        for samples in (ms["act"], ms["commit"], ms["read"], fault_ms):
            del samples[:]
        faults = fault_stats()
        total, secs = serving.decode_rounds(
            cfg, params, cache, groups, tokens_per_turn=t["tokens_per_turn"],
            turns=t["turns"])
        stats = dict(cache.stats)
        after = fault_stats()
        rec = dict(
            oversub=oversub, n_slots=cache.n_slots, setup_s=setup_s,
            prefill_s=prefill_s, decode_tokens=total, decode_s=secs,
            tok_per_s=total / secs,
            decode_upload_bytes=stats["upload_bytes"] - before["upload_bytes"],
            decode_uploads=stats["uploads"] - before["uploads"],
            **activation_record(ms),
            fault_pass_ms_mean=sum(fault_ms) / max(len(fault_ms), 1),
            uvm_cpu_faults=after.faults_cpu - faults.faults_cpu,
            uvm_device_faults=after.faults_device - faults.faults_device,
            uvm_migrated_bytes=after.migrated_bytes - faults.migrated_bytes,
            memring=cache.backing.ring is not None)
        tokens = cache.last_token.copy()
    finally:
        cache.close()
    return tokens, stats, rec


def phase_tiered(cfg, params, gen):
    """Config #4 at full width: the same 16 prompts through the tiered cache
    at oversub 1 and then 4 (the first closed before the second starts)."""
    from open_gpu_kernel_modules_tpu_torch.models import serving
    from open_gpu_kernel_modules_tpu_torch.ops import (flash_attention,
                                                       paged_attention)
    t = TIERED
    prompts = torch.randint(0, cfg.vocab_size, (t["seqs"], t["prompt"]),
                            generator=gen, device="cuda")
    log(f"tiered: native arena TPUMEM_FAKE_HBM_MB="
        f"{os.environ['TPUMEM_FAKE_HBM_MB']}; {t}")
    torch.cuda.synchronize()
    reset_counts()
    runs = {o: tiered_run(cfg, params, prompts, o) for o in (1, 4)}
    launches = paged_attention.launches
    expect = (cfg.num_layers * t["turns"] * (t["seqs"] // t["group"]) *
              t["tokens_per_turn"] * 2)
    check(launches == expect,
          f"tiered: paged decode launched {launches} times, expected {expect}")
    check(flash_attention.launches == 0 and flash_attention.rows_launches == 0,
          "tiered serving launched a flash kernel")
    for o, (tokens, stats, rec) in runs.items():
        log(f"tiered oversub={o}: " + json.dumps(rec))
        log(f"tiered oversub={o} stats: " + json.dumps(stats))
        check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
              "tiered: token out of vocabulary")
    check(bool((runs[1][0] == runs[4][0]).all()),
          f"tiered: oversub 1 and 4 disagree: {runs[1][0]} vs {runs[4][0]}")
    check(runs[4][1]["flushes"] > 0, "tiered: oversub=4 never flushed")
    check(runs[1][1]["flushes"] == 0, "tiered: oversub=1 flushed")

    # The first group through the dense path: prefill + 16 greedy steps
    # give the token the tiered runs ended on.
    n_new = t["tokens_per_turn"] * t["turns"] + 1
    dense, cache, _ = serving.generate(cfg, params, prompts[:t["group"]],
                                       n_new)
    want = dense[:, -1].cpu().numpy()
    log(f"tiered: last tokens {runs[4][0].tolist()}; dense generate of "
        f"group 0 ends on {want.tolist()}")
    check(bool((runs[4][0][:t["group"]] == want).all()),
          "tiered tokens disagree with dense generate")

    # Kernel time of one turn (tokens_per_turn greedy steps at the group's
    # batch, on that dense cache), against the host clock of the turns.
    tok = dense[:, -1].to(torch.int32)
    turn_ms, _ = device_kernel_ms(lambda: serving.decode_scan(
        cfg, params, tok, cache, t["tokens_per_turn"]))
    if turn_ms is None:
        log("tiered: device busy share not measured (no device time in "
            "the profiler trace)")
    else:
        for o, (_, _, rec) in runs.items():
            turns = t["turns"] * (t["seqs"] // t["group"])
            log(f"tiered oversub={o}: decode kernels {turn_ms:.3f} ms a turn "
                f"(profiler); device busy share of decode_rounds about "
                f"{turns * turn_ms / (rec['decode_s'] * 1e3):.3f}")
    # Phase 9 decodes the same prompts on the same schedule over the ICI
    # pool and is held to the oversub=4 run.
    return launches, prompts, runs[4]


# ------------------------------------------------------------------ phase 8

# Continuous batching over the tiered cache.  A KV page is 8 MiB at this
# width (32 layers x 64 tokens x 8 kv heads x 128 x bf16, K and V), the
# backing 80 pages (640 MiB, inside the 1024 MB arena).  At oversub 2 the
# slot pool holds 40 pages: five admitted streams (8 pages each at 504 + 8
# tokens) fill it, and the next round's growth past 512 tokens needs 9
# pages each, so decode growth must preempt.
SCHED = dict(streams=8, first=5, prompt=504, new=64, max_seqs=8,
             max_len=640, page=64, tokens_per_round=8)
SCHED_RESETS = (2, 4, 6)        # run A': device resets after these rounds
# Run T: the round traced by the profiler, one at batch 8 with no admission,
# no reset and no retirement in it.
SCHED_PROFILED_ROUND = 6


def sched_drive(s, prompts, after=None, traced_round=0, step_span=None):
    """Drive a Scheduler the way its users would: submit 5 streams, step
    twice, submit 3 more, step until idle.  ``after[r](s)`` runs after round
    r; ``traced_round`` runs that round under the profiler (the run's wall
    then includes the profiler's cost: it is not a throughput).  With
    ``step_span`` stream i is tenant i % 2 (else tenant 0) and each step
    runs inside that application span of the native trace, its object the
    step's number.  Returns (requests, wall s, (host ms, kernel
    ms) of the traced round or None, the decode batch of every round that
    decoded)."""
    from open_gpu_kernel_modules_tpu_torch import utils
    t = SCHED
    after = after or {}
    traced = None
    batches = []
    step = s.step

    def counted_step():
        before = s.stats["decoded_tokens"]
        with (utils.span(step_span, obj=steps) if step_span
              else contextlib.nullcontext()):
            out = step()
        n = (s.stats["decoded_tokens"] - before) // s.tokens_per_round
        if n:
            batches.append(n)
        return out

    def submit(first, last):
        return [s.submit(prompts[i], t["new"],
                         tenant=i % 2 if step_span else 0)
                for i in range(first, last)]
    s.step = counted_step
    t0 = time.perf_counter()
    reqs = submit(0, t["first"])
    steps = 0
    while not s.idle or steps < 2:
        if steps == 2 and len(reqs) < t["streams"]:
            reqs += submit(t["first"], t["streams"])
        steps += 1
        if steps == traced_round:
            host, kern, _ = profiled(s.step)
            traced = (host, kern)
        else:
            s.step()
        if steps in after:
            after[steps](s)
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0, traced, batches


def sched_run(cfg, params, prompts, oversub, resets=(), traced_round=0,
              step_span=None, native_trace=None):
    """One scheduler run over a managed tiered cache (``sched_drive``, with
    ``step_span``); ``resets`` force a device reset after those rounds.
    With ``native_trace`` (a ``NativeTrace``) the native trace is armed for
    the whole drive and read before the scheduler closes.  Returns (tokens
    [streams, new], report with ``reset_s``, the host time spent inside the
    forced resets, and (host ms, kernel ms) of the traced round or None)."""
    from open_gpu_kernel_modules_tpu_torch.runtime import sched
    from open_gpu_kernel_modules_tpu_torch.uvm import reset
    t = SCHED
    s = sched.Scheduler(cfg, params, max_seqs=t["max_seqs"],
                        max_len=t["max_len"], page_size=t["page"],
                        oversub=oversub,
                        tokens_per_round=t["tokens_per_round"])
    reset_s = [0.0]

    def timed_reset(_s):
        r0 = time.perf_counter()
        reset.device_reset()
        reset_s[0] += time.perf_counter() - r0
    try:
        with native_trace or contextlib.nullcontext():
            reqs, wall, traced, _ = sched_drive(
                s, prompts, {r: timed_reset for r in resets}, traced_round,
                step_span)
        rep = s.report(wall)
        if native_trace is not None:
            native_trace.read(s, reqs, rep)
        rep["reset_s"] = round(reset_s[0], 3)
        check(all(r.state is sched.RequestState.FINISHED for r in reqs),
              f"scheduler oversub={oversub}: a stream did not finish")
        tokens = np.stack([r.tokens for r in reqs])
    finally:
        s.close()
    return tokens, rep, traced


class NativeTrace:
    """A run N's native trace, as a context: entering arms it (rings, site
    histograms, flows and SLO series cleared first), leaving disarms it.
    ``read`` then holds it to the run: the round, admission and step-span
    histograms to the Scheduler's counts, the Chrome export's format,
    events and request flow pairs, the per-tenant SLO series to the tokens,
    every flow ledger closed within its wall, the scrape's scheduler
    counters to the Scheduler's stats and its trace records to the ring
    accounting.  The export is saved to ``export_dir`` under the run's
    ``name``.  ``facts`` gathers what the phase prints."""

    STEP_SPAN = "chip_smoke.sched_step"

    def __init__(self, export_dir: str, name: str):
        self.export_dir = export_dir
        self.name = name
        self.facts = {}

    def __enter__(self) -> "NativeTrace":
        self.arm()
        return self

    def __exit__(self, *exc) -> None:
        from open_gpu_kernel_modules_tpu_torch import utils
        utils.trace_stop()

    @staticmethod
    def scrape(text: str, name: str) -> int:
        """The value of one engine counter in the Prometheus scrape, summed
        over its labels."""
        head = f'tpurm_counter{{name="{name}"'
        return sum(int(float(line.rsplit(" ", 1)[1]))
                   for line in text.splitlines() if line.startswith(head))

    def arm(self) -> None:
        from open_gpu_kernel_modules_tpu_torch import utils
        utils.flow_reset()
        utils.trace_reset()
        text = utils.metrics_text()
        self.before = {n: self.scrape(text, n)
                       for n in ("tpusched_rounds", "tpusched_admitted")}
        utils.trace_start()

    def read(self, s, reqs, rep) -> None:
        from open_gpu_kernel_modules_tpu_torch import utils
        f = self.facts
        who = f"scheduler {self.name}"
        rounds, admitted = rep["rounds"], rep["admitted"]
        passes = utils.trace_hist_count("sched.round")
        check(passes == rounds,
              f"{who}: {passes} sched.round spans for {rounds} rounds")
        # sched.admit: one span per admission pass (one a round) and one
        # per admitted stream (its prefill, the flow's start).
        admits = utils.trace_hist_count("sched.admit")
        check(admits == rounds + admitted,
              f"{who}: {admits} sched.admit spans for {rounds} rounds and "
              f"{admitted} admissions")
        f["trace_stats"] = utils.trace_stats()
        for site in ("sched.round", "fault.latency"):
            f[site] = [utils.trace_quantile_ns(site, q) / 1e3
                       for q in (0.5, 0.99)]
        path = utils.trace_save(os.path.join(
            self.export_dir, f"sched_trace_{self.name}.json"))
        f["export_bytes"] = os.path.getsize(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        f["export_events"] = len(events)
        meta = [e for e in events if e["name"] == "tpurm.export"]
        check(len(meta) == 1, f"{who}: no tpurm.export event")
        f["export_dropped"] = meta[0]["args"]["exportDropped"]
        names = {e["name"] for e in events}
        for want in ("sched.round", self.STEP_SPAN):
            check(want in names, f"{who}: no {want} in the export")
        # Every step is one round inside one application span of its own
        # name (serving's spans are application spans too).
        steps = sum(e["name"] == self.STEP_SPAN for e in events)
        check(steps == rounds,
              f"{who}: {steps} step spans for {rounds} rounds")
        starts = [e for e in events if e.get("ph") == "s"]
        ends = [e for e in events if e.get("ph") == "f"]
        minted = {r.flow & ~0xFFFF for r in reqs}
        check(bool(starts) and all(int(e["id"], 16) in minted
                                   for e in starts),
              f"{who}: {len(starts)} flow starts, not all minted request "
              f"flows")
        ends_by_id = {}
        for e in ends:
            ends_by_id.setdefault(e["id"], set()).add(e["tid"])
        paired = sum(1 for e in starts
                     if ends_by_id.get(e["id"], set()) - {e["tid"]})
        check(paired >= 1,
              f"{who}: none of {len(starts)} flow starts paired with a "
              f"finish on another thread ({len(ends)} finishes)")
        f["flows"] = {"starts": len(starts), "finishes": len(ends),
                      "paired": paired}
        for tenant in (0, 1):
            mine = [r for r in reqs if r.tenant == tenant]
            itl, ttft = (utils.slo_count(tenant, k) for k in ("itl", "ttft"))
            check(itl == sum(r.decoded for r in mine) and
                  ttft == len(mine),
                  f"{who}: tenant {tenant} itl {itl} ttft {ttft} for "
                  f"{sum(r.decoded for r in mine)} tokens of {len(mine)} "
                  f"streams")
        flows = utils.flow_report()
        check(len(flows) == len(reqs) and
              all(fl["state"] == "closed" and
                  sum(fl["blame_ns"].values()) <= fl["wall_ns"]
                  for fl in flows),
              f"{who}: flow ledgers {flows}")
        scrape = utils.metrics_text()
        for name, stat in (("tpusched_rounds", "rounds"),
                           ("tpusched_admitted", "admitted")):
            delta = self.scrape(scrape, name) - self.before[name]
            check(delta == s.stats[stat],
                  f"{who}: scrape {name} moved {delta}, stats {stat} "
                  f"{s.stats[stat]}")
        recorded = [int(float(line.split()[-1]))
                    for line in scrape.splitlines()
                    if line.startswith("tpurm_trace_records_total")]
        check(recorded == [utils.trace_stats()["recorded"]],
              f"{who}: tpurm_trace_records_total {recorded}, recorded "
              f"{utils.trace_stats()['recorded']}")


def phase_sched(cfg, params, gen, export_dir):
    """The Scheduler at full width: runs A (oversub 1); D1, N1, N2, D2 (A
    on two tenants with every step an application span, N with the native
    trace armed and its export saved to ``export_dir``, D disarmed, in that
    order so that the N/D ratio is the cost of arming alone); A' (A with
    three forced device resets), B (oversub 2, preempting) and T (A with one
    round traced, untimed).  Returns B1's launches and the prompts."""
    from open_gpu_kernel_modules_tpu_torch.ops import (flash_attention,
                                                       paged_attention)
    t = SCHED
    prompts = torch.randint(0, cfg.vocab_size, (t["streams"], t["prompt"]),
                            generator=gen, device="cuda").cpu().numpy()
    log(f"scheduler: {t}; device resets after rounds {SCHED_RESETS} of "
        f"run A'")
    torch.cuda.synchronize()
    reset_counts()
    traces = {n: NativeTrace(export_dir, n) for n in ("N1", "N2")}
    runs = {"A": sched_run(cfg, params, prompts, 1)}
    for name in ("D1", "N1", "N2", "D2"):
        runs[name] = sched_run(cfg, params, prompts, 1,
                               step_span=NativeTrace.STEP_SPAN,
                               native_trace=traces.get(name))
    runs["A'"] = sched_run(cfg, params, prompts, 1, SCHED_RESETS)
    runs["B"] = sched_run(cfg, params, prompts, 2)
    trace = sched_run(cfg, params, prompts, 1,
                      traced_round=SCHED_PROFILED_ROUND)
    launches = paged_attention.launches
    rounds = sum(rep["rounds"] for _, rep, _ in runs.values()) \
        + trace[1]["rounds"]
    expect = cfg.num_layers * t["tokens_per_round"] * rounds
    check(launches == expect, f"scheduler: paged decode launched {launches} "
          f"times, expected {expect} ({rounds} rounds)")
    check(flash_attention.launches == 0 and flash_attention.rows_launches == 0,
          "scheduler launched a flash kernel")
    for name, (tokens, rep, _) in runs.items():
        log(f"scheduler {name}: " + json.dumps(
            {k: v for k, v in rep.items() if k != "slo"}))
        check(tokens.shape == (t["streams"], t["new"]),
              f"scheduler {name}: tokens shape {tokens.shape}")
        check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
              f"scheduler {name}: token out of vocabulary")
        check(rep["finished"] == t["streams"],
              f"scheduler {name}: {rep['finished']} streams finished")
    a, a2, b = (runs[k] for k in ("A", "A'", "B"))
    for name in ("D1", "N1", "N2", "D2"):
        check(bool((runs[name][0] == a[0]).all()),
              f"scheduler: tokens of run {name} differ from A's")
    check(a2[1]["device_resets_observed"] >= len(SCHED_RESETS),
          f"scheduler A': observed {a2[1]['device_resets_observed']} resets")
    check(bool((a2[0] == a[0]).all()),
          "scheduler: tokens through device resets differ from run A's")
    check(bool((trace[0] == a[0]).all()),
          "scheduler: tokens of the traced run T differ from run A's")
    check(b[1]["preempted"] >= 1, "scheduler B: oversub 2 never preempted")
    check(b[1]["restored"] == b[1]["preempted"],
          f"scheduler B: restored {b[1]['restored']} of "
          f"{b[1]['preempted']} preempted")
    # Across batch buckets bf16 cuBLAS and B1's split plan may round
    # differently, so B is held to A only where batches match (A and A').
    same = (b[0] == a[0])
    log(f"scheduler: B against A: {int(same.all(axis=1).sum())} of "
        f"{t['streams']} streams equal, {float(same.mean()):.3f} of tokens")
    for name, (_, rep, _) in runs.items():
        log(f"scheduler {name}: agg_toks_per_s {rep['agg_toks_per_s']}, "
            f"p50_token_ms {rep['p50_token_ms']}, p99_token_ms "
            f"{rep['p99_token_ms']}, preempted {rep['preempted']}, restored "
            f"{rep['restored']}, rounds {rep['rounds']}, wall_s "
            f"{rep['wall_s']}, reset_s {rep['reset_s']}")
    def toks(*names):
        return sum(runs[k][1]["agg_toks_per_s"] for k in names) / len(names)
    log(f"scheduler: native trace armed against disarmed (D1, N1, N2, D2): "
        f"N {toks('N1', 'N2'):.2f} tok/s, D {toks('D1', 'D2'):.2f}: ratio "
        f"{toks('N1', 'N2') / toks('D1', 'D2'):.4f}; N against A "
        f"{toks('N1', 'N2') / toks('A'):.4f}")
    for name, nt in traces.items():
        f = nt.facts
        log(f"scheduler {name}: trace_stats {f['trace_stats']}; sched.round "
            f"p50/p99 {f['sched.round'][0]:.1f}/{f['sched.round'][1]:.1f} "
            f"us, fault.latency p50/p99 {f['fault.latency'][0]:.1f}/"
            f"{f['fault.latency'][1]:.1f} us; export {f['export_bytes']} "
            f"bytes, {f['export_events']} events ({f['export_dropped']} "
            f"dropped by the export); flows {f['flows']}")
    host, kern = trace[2]
    busy = "not measured" if kern is None else f"{kern / host:.3f}"
    log(f"scheduler T round {SCHED_PROFILED_ROUND} (profiled): {host:.1f} ms "
        f"host clock, kernels {kern if kern is None else round(kern, 3)} ms; "
        f"device busy share {busy}")
    # The same round's decode without the profiler: run A's median token
    # time over a round's tokens.
    a_round = a[1]["p50_token_ms"] * t["tokens_per_round"]
    log(f"scheduler: A's median round {a_round:.1f} ms (no profiler); "
        f"device busy share against it "
        f"{'not measured' if kern is None else f'{kern / a_round:.3f}'}")
    return launches, prompts


# ------------------------------------------------------------------ phase 9

# BASELINE config #5: the KV pool striped round-robin over the native engine's
# device arenas (host memory, TPUMEM_FAKE_TPU_COUNT of them) and moved over
# its ICI model; the decode runs on the card.  A page's record (K and V of
# every layer) is one PMM chunk, which the engine caps at its 2 MiB VA block
# (uvmHbmChunkAlloc refuses more with TPU_ERR_INVALID_LIMIT), so the pool's
# pages hold 16 tokens: 2 x 32 layers x 16 x 8 kv heads x 128 x bf16 = 2 MiB.
# M1 is phase 7's shape at oversub 4 in those pages: 576 records, 288 MiB on
# each arena plus 16 MiB of staging on device 0; its reference is a managed
# tiered run at the same shape.  M2 and M3 are phase 8's at oversub 2: 320
# records, 160 MiB an arena.
ARENAS = 4
MC_PAGE = 16
MC_OVERSUB = 2                  # M2's and M3's slot pool: 160 of 320 pages
# M2: after round 3 move chip 1 -> 2; after round 5 a move 2 -> 3 that the
# vac.migrate inject site forces to abort; after round 7 move 0 -> 1, then
# the reset watchdog evacuates chip 3 on synthetic health evidence.
# M3 (disaggregated, decode homes 1-3): a device reset after round 2, the
# move 1 -> 2 after round 4.
WATCHDOG_DEADLINE_S = 30.0


def multichip_decode(cfg, params, prompts):
    """M1: prefill every group into the ICI-striped pool, then phase 7's
    decode turns one decode_rounds call at a time, with the direct 0<->1
    link failed before the last; then the victim ring drains home over ICI.
    Returns (last tokens, record)."""
    from open_gpu_kernel_modules_tpu_torch.models import multichip, serving
    from open_gpu_kernel_modules_tpu_torch.runtime import ici
    t = TIERED
    groups = [list(range(i, i + t["group"]))
              for i in range(0, t["seqs"], t["group"])]
    t0 = time.perf_counter()
    cache = multichip.make_multichip_cache(cfg, t["seqs"], t["max_len"],
                                           MC_PAGE, oversub=4,
                                           n_devices=ARENAS)
    setup_s = time.perf_counter() - t0
    backing = cache.backing
    ms = time_activations(cache)
    try:
        t0 = time.perf_counter()
        for g in groups:
            serving.prefill_group(cfg, params, cache, g, prompts[g])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_stats = dict(backing.stats)
        for samples in (ms["act"], ms["commit"], ms["read"]):
            del samples[:]
        decoded, secs = 0, 0.0
        for turn in range(t["turns"]):
            if turn == t["turns"] - 1:
                direct = next(li for li in range(ici.link_count(0))
                              if ici.link_info(0, li).peer == 1)
                before = backing.link_traffic()
                ici.inject_link_failure(0, direct)
                hops = ici.route_hops(0, 1)
            n, dt = serving.decode_rounds(
                cfg, params, cache, groups,
                tokens_per_turn=t["tokens_per_turn"], turns=1)
            decoded, secs = decoded + n, secs + dt
        cache.drain_flushes()
        torch.cuda.synchronize()
        after = backing.link_traffic()
        rec = dict(setup_s=setup_s, prefill_s=prefill_s,
                   decode_tokens=decoded, decode_s=secs,
                   tok_per_s=decoded / secs, detour_hops=hops,
                   tx_0_to_3_after_failure=after["0->(3)"] - before["0->(3)"],
                   prefill_ici=prefill_stats, ici=dict(backing.stats),
                   **activation_record(ms))
        tokens = cache.last_token.copy()
        rec["retrain"] = retrain_link(backing, direct)
    finally:
        cache.close()
    return tokens, rec


def retrain_link(backing, direct):
    """The failed 0 <-> 1 link reset and trained back: it must report
    ACTIVE, route 0 -> 1 in one hop, count its training, and carry a record
    written back to one of chip 1's pages (the same bytes, so the pool's
    data is unchanged)."""
    from open_gpu_kernel_modules_tpu_torch import utils
    from open_gpu_kernel_modules_tpu_torch.runtime import ici
    from open_gpu_kernel_modules_tpu_torch.uvm import inject
    trained0 = utils.counter("ici_links_trained")
    recovery0 = inject.recovery_counters(detail=True)
    ici.reset_link(0, direct)
    down = ici.link_info(0, direct).state
    ici.train_links(0)
    state = ici.link_info(0, direct).state
    check(down == ici.LinkState.DOWN and state == ici.LinkState.ACTIVE,
          f"multichip M1: the 0 <-> 1 link went {down.name} -> "
          f"{state.name} through reset and training")
    check(ici.route_hops(0, 1) == 1, "multichip M1: 0 -> 1 still detours "
          "after training")
    trained = utils.counter("ici_links_trained") - trained0
    check(trained >= 1, "multichip M1: no link training was counted")
    page = next(p for p in range(len(backing.home)) if backing.home[p] == 1)
    k, v = backing.read_pages([page])
    before = backing.link_traffic()["0->(1)"]
    backing.write_page(page, k[:, 0], v[:, 0])
    sent = backing.link_traffic()["0->(1)"] - before
    check(sent >= backing.record_bytes, f"multichip M1: a record to chip 1 "
          f"sent {sent} bytes on the direct link after training")
    recovery = {n: c - recovery0[n]
                for n, c in inject.recovery_counters(detail=True).items()
                if c != recovery0[n]}
    return {"links_trained": trained, "direct_bytes": sent,
            "recovery_delta": recovery}


def tenant_charges_match(backing) -> bool:
    """Each arena's per-tenant device charges equal the records homed on it
    (every stream here is tenant 0)."""
    import ctypes
    lib = backing._lib
    lib.uvmTenantDevPages.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.uvmTenantDevPages.restype = ctypes.c_uint64
    rows = {d: (lib.uvmTenantDevPages(0, d), len(backing.pages_homed(d)))
            for d in range(backing.n_devices)}
    log(f"  charged vs homed records per arena: {rows}")
    return all(c == h for c, h in rows.values())


def multichip_sched_run(cfg, params, prompts, after=None, disagg=None):
    """One Scheduler run over a fresh ICI-striped pool at phase 8's shape
    (``sched_drive``, with ``after`` actions).  Every evacuation is checked:
    a committed one leaves nothing homed on its source.  Returns (tokens
    [streams, new], report, decode batch of every round, tokens each stream
    had decoded before the first evacuation, the scheduler's moves, blackout
    and ship-leg lists)."""
    from open_gpu_kernel_modules_tpu_torch.models import multichip
    from open_gpu_kernel_modules_tpu_torch.runtime import sched
    from open_gpu_kernel_modules_tpu_torch.uvm import vac
    t = SCHED
    # Earlier phases' resets and link failures left health evidence; only
    # this run's own evacuations may move pages.
    for d in range(ARENAS):
        vac.clear(d)
    cache = multichip.make_multichip_cache(cfg, t["max_seqs"], t["max_len"],
                                           MC_PAGE, oversub=MC_OVERSUB,
                                           n_devices=ARENAS)
    s = sched.Scheduler(cfg, params, tokens_per_round=t["tokens_per_round"],
                        cache=cache, disagg=disagg)
    decoded_before = {}
    moves = []
    evacuate = s.evacuate_device

    def checked_evacuate(src, dst=None, tenant=None):
        if not decoded_before:
            decoded_before.update({r.rid: r.decoded
                                   for r in s._by_rid.values()})
        rep = evacuate(src, dst, tenant)
        if rep is not None:
            check(rep.pages > 0 and s.cache.backing.pages_homed(src) == [],
                  f"evacuation {src} -> {rep.dst} left pages on {src}")
        moves.append((src, None if rep is None else rep.dst,
                      0 if rep is None else rep.pages))
        return rep
    s.evacuate_device = checked_evacuate
    try:
        reqs, wall, _, batches = sched_drive(s, prompts, after)
        rep = s.report(wall)
        check(all(r.state is sched.RequestState.FINISHED for r in reqs),
              "multichip scheduler: a stream did not finish")
        check(tenant_charges_match(s.cache.backing),
              "multichip scheduler: tenant charges differ from the homes")
        rep["ici"] = dict(s.cache.backing.stats)
        tokens = np.stack([r.tokens for r in reqs])
        before = [decoded_before.get(r.rid, 0) for r in reqs]
        extra = (list(s.evac_blackouts_s), list(s.disagg_ship_s))
    finally:
        s.close()
    return tokens, rep, batches, before, moves, extra


def compare_tokens(name, tokens, batches, before, ref):
    """``name``'s tokens against M2_0's: those decoded before the run's first
    evacuation must be equal; all of them when every round's decode batch
    matched M2_0's (bf16 cuBLAS and B1's split plan round alike within a
    batch bucket, apart across buckets)."""
    ref_tokens, ref_batches = ref
    for i, n in enumerate(before):
        check(bool((tokens[i, :n] == ref_tokens[i, :n]).all()),
              f"{name}: stream {i}'s first {n} tokens differ from M2_0's")
    same = tokens == ref_tokens
    differ = [i + 1 for i, (a, b) in enumerate(zip(batches, ref_batches))
              if a != b]
    matched = batches == ref_batches
    log(f"multichip {name}: decode batch per round {batches} (M2_0 "
        f"{ref_batches}); rounds that differ {differ}; tokens before the "
        f"first evacuation {before}; {int(same.all(axis=1).sum())} of "
        f"{len(tokens)} streams equal M2_0's, {float(same.mean()):.3f} of "
        f"tokens")
    if matched:
        check(bool(same.all()), f"{name}: every round's batch matched "
              f"M2_0's but the tokens differ")


def phase_multichip(cfg, params, gen, tiered, smi):
    """Config #5 at full width: M1 (ICI-striped tiered decode through a link
    failure, then the link reset and retrained), M2_0 / M2 (the Scheduler
    over the pool, without and with evacuations) and M3 (disaggregated,
    through a reset and an evacuation of a decode home).  Returns B1's
    launches and M2_0's prompts, tokens and decode batches."""
    from open_gpu_kernel_modules_tpu_torch import utils
    from open_gpu_kernel_modules_tpu_torch.ops import (flash_attention,
                                                       paged_attention)
    from open_gpu_kernel_modules_tpu_torch.runtime import tpusplit
    from open_gpu_kernel_modules_tpu_torch.uvm import inject, reset, vac
    t = SCHED
    tiered_prompts, (phase7_tokens, _, _) = tiered
    prompts = torch.randint(0, cfg.vocab_size, (t["streams"], t["prompt"]),
                            generator=gen, device="cuda").cpu().numpy()
    log(f"multichip: {ARENAS} native device arenas of "
        f"{os.environ['TPUMEM_FAKE_HBM_MB']} MB (TPUMEM_FAKE_TPU_COUNT="
        f"{os.environ['TPUMEM_FAKE_TPU_COUNT']}); pages of {MC_PAGE} tokens; "
        f"M1 {TIERED} at oversub 4; M2_0/M2/M3 {t} at oversub {MC_OVERSUB}")
    split = ("tpusplit_ships", "tpusplit_reclaims", "tpusplit_pages_shipped")
    ctr0 = {n: utils.counter(n) for n in
            ("vac_inject_retries", "vac_inject_aborts") + split}
    hits0 = inject.counts(inject.Site.VAC_MIGRATE)[1]
    wd0 = reset.stats().watchdog_evacuations
    torch.cuda.synchronize()
    reset_counts()

    # M1's reference: phase 7's prompts and schedule at oversub 4 over the
    # managed backing, in M1's pages; then M1 itself.
    ref_m1_tokens, _, managed_rec = tiered_run(cfg, params, tiered_prompts, 4,
                                               page=MC_PAGE)
    log(f"multichip M1 reference (ManagedKVBacking, pages of {MC_PAGE}, "
        f"oversub 4): " + json.dumps(managed_rec))
    m1_tokens, m1 = multichip_decode(cfg, params, tiered_prompts)
    log("multichip M1: " + json.dumps(m1))
    check(bool((m1_tokens == ref_m1_tokens).all()),
          f"multichip M1: tokens {m1_tokens.tolist()} differ from the "
          f"ManagedKVBacking run's {ref_m1_tokens.tolist()}")
    log(f"multichip M1: {int((m1_tokens == phase7_tokens).sum())} of "
        f"{len(m1_tokens)} last tokens equal phase 7's (pages of "
        f"{TIERED['page']})")
    check(m1["ici"]["ici_fetch_records"] > 0 and
          m1["ici"]["ici_flush_records"] > 0,
          f"multichip M1: no ICI traffic both ways: {m1['ici']}")
    check(m1["detour_hops"] == 3,
          f"multichip M1: 0 -> 1 routes over {m1['detour_hops']} hops")
    check(m1["tx_0_to_3_after_failure"] > 0,
          "multichip M1: the 0 -> 3 detour carried no traffic")
    log(f"multichip M1: the 0 <-> 1 link reset and trained back: "
        f"{json.dumps(m1['retrain'])}")
    for k in ("unstaged_activate_host_ms_mean",
              "staged_activate_host_ms_mean", "read_pages_ms_mean"):
        log(f"multichip M1 vs ManagedKVBacking at its shape: {k} "
            f"{m1[k]:.3f} vs {managed_rec[k]:.3f}")

    # M2_0, then M2 with its evacuations.
    ref_tokens, ref_rep, ref_batches, _, ref_moves, _ = multichip_sched_run(
        cfg, params, prompts)
    check(not ref_moves, f"multichip M2_0 evacuated: {ref_moves}")

    def move(src, dst):
        def act(s):
            check(s.evacuate_device(src, dst) is not None,
                  f"multichip: the evacuation {src} -> {dst} aborted")
        return act

    def forced_abort(s):
        homed = s.cache.backing.pages_homed(2)
        inject.enable(inject.Site.VAC_MIGRATE, inject.Mode.PPM, 1000000,
                      burst=64)
        try:
            rep = s.evacuate_device(2, 3)
        finally:
            inject.disable(inject.Site.VAC_MIGRATE)
        check(rep is None and s.cache.backing.pages_homed(2) == homed,
              "multichip M2: the forced abort moved pages")

    def watchdog_evacuation(s):
        move(0, 1)(s)
        reset.watchdog_start()
        for d in range(ARENAS - 1):
            vac.clear(d)
        for _ in range(4):
            vac.note(3, vac.Event.PAGE_QUARANTINE)
        check(vac.state(3) == vac.HealthState.EVACUATING,
              f"multichip M2: chip 3 is {vac.state(3).name}")
        n0 = s.stats["evacuations"]
        deadline = time.perf_counter() + WATCHDOG_DEADLINE_S
        while (s.stats["evacuations"] == n0 and
               time.perf_counter() < deadline):
            s.step()
            time.sleep(0.02)
        check(s.stats["evacuations"] > n0 and
              s.cache.backing.pages_homed(3) == [],
              "multichip M2: the watchdog's evacuation of chip 3 never came")

    m2_tokens, m2_rep, m2_batches, m2_before, m2_moves, (m2_black, _) = \
        multichip_sched_run(cfg, params, prompts, after={
            3: move(1, 2), 5: forced_abort, 7: watchdog_evacuation})
    log(f"multichip M2 moves (src, dst or None if aborted, pages): "
        f"{m2_moves}")
    check(m2_rep["evacuations"] >= 3 and m2_rep["evac_aborts"] >= 1,
          f"multichip M2: {m2_rep['evacuations']} evacuations, "
          f"{m2_rep['evac_aborts']} aborts")
    check(reset.stats().watchdog_evacuations > wd0,
          "multichip M2: the watchdog posted no evacuation")
    compare_tokens("M2", m2_tokens, m2_batches, m2_before,
                   (ref_tokens, ref_batches))

    # M3: disaggregated, a reset after round 2, decode home 1 -> 2 after 4.
    homes = {}

    def evacuate_decode_home(s):
        homes.update(s._disagg_home)
        move(1, 2)(s)
        rewritten = [sq for sq, h in homes.items()
                     if h == 1 and s._disagg_home[sq] == 2]
        check(len(rewritten) >= 1,
              f"multichip M3: no decode home rewritten 1 -> 2: {homes} -> "
              f"{s._disagg_home}")
    m3_tokens, m3_rep, m3_batches, m3_before, m3_moves, (m3_black, ship_s) = \
        multichip_sched_run(
            cfg, params, prompts,
            after={2: lambda s: reset.device_reset(),
                   4: evacuate_decode_home},
            disagg=tpusplit.DisaggConfig(decode_devs=(1, 2, 3)))
    log(f"multichip M3 moves: {m3_moves}")
    check(m3_rep["device_resets_observed"] >= 1,
          "multichip M3: the reset was not observed")
    check(m3_rep["disagg_ships"] + m3_rep["disagg_ship_aborts"] >=
          t["streams"], f"multichip M3: {m3_rep['disagg_ships']} ships, "
          f"{m3_rep['disagg_ship_aborts']} aborts")
    check(m3_rep["disagg_pages_shipped"] > 0 and
          m3_rep["disagg_reclaims"] > 0,
          "multichip M3: nothing shipped or reclaimed")
    ctr = {n: utils.counter(n) - ctr0[n] for n in ctr0}
    check((ctr["tpusplit_ships"], ctr["tpusplit_reclaims"],
           ctr["tpusplit_pages_shipped"]) ==
          (m3_rep["disagg_ships"], m3_rep["disagg_reclaims"],
           m3_rep["disagg_pages_shipped"]),
          f"multichip M3: tpusplit counters {ctr} differ from its stats")
    compare_tokens("M3", m3_tokens, m3_batches, m3_before,
                   (ref_tokens, ref_batches))

    check(vac.txns_active() == 0, "multichip: a vac manifest is still open")
    hits = inject.counts(inject.Site.VAC_MIGRATE)[1] - hits0
    check(hits == ctr["vac_inject_retries"] + ctr["vac_inject_aborts"],
          f"multichip: vac.migrate hits {hits} != retries "
          f"{ctr['vac_inject_retries']} + aborts {ctr['vac_inject_aborts']}")
    launches = paged_attention.launches
    rounds = ref_rep["rounds"] + m2_rep["rounds"] + m3_rep["rounds"]
    m1_steps = TIERED["turns"] * (TIERED["seqs"] // TIERED["group"]) * \
        TIERED["tokens_per_turn"]
    # M1 and its managed reference decode the same steps.
    expect = cfg.num_layers * (2 * m1_steps + t["tokens_per_round"] * rounds)
    check(launches == expect, f"multichip: paged decode launched {launches} "
          f"times, expected {expect} (2 x {m1_steps} M1 steps, {rounds} "
          f"rounds)")
    check(flash_attention.launches == 0 and flash_attention.rows_launches == 0,
          "multichip launched a flash kernel")

    for name, rep in (("M2_0", ref_rep), ("M2", m2_rep), ("M3", m3_rep)):
        log(f"multichip {name}: " + json.dumps(
            {k: v for k, v in rep.items() if k != "slo"}))
        log(f"multichip {name}: agg_toks_per_s {rep['agg_toks_per_s']}, "
            f"p50_token_ms {rep['p50_token_ms']}, p99_token_ms "
            f"{rep['p99_token_ms']}, rounds {rep['rounds']}, wall_s "
            f"{rep['wall_s']}, ICI bytes {rep['ici']['ici_bytes']} "
            f"(fetched {rep['ici']['ici_fetch_records']}, flushed "
            f"{rep['ici']['ici_flush_records']} records)")
    legs = np.array(ship_s) * 1e3
    log(f"multichip: evacuation blackouts ms M2 "
        f"{[round(b * 1e3, 3) for b in m2_black]}, M3 "
        f"{[round(b * 1e3, 3) for b in m3_black]}; M3 ship legs "
        f"{len(legs)}, p50 {np.percentile(legs, 50):.3f} ms, p99 "
        f"{np.percentile(legs, 99):.3f} ms; vac.migrate hits {hits}; "
        f"B1 launches {launches}; {smi}")
    return launches, (prompts, ref_tokens, ref_batches)


# ----------------------------------------------------------------- phase 10

# BASELINE config #2 (the UVM oversubscription microbench, bench.py:185-345)
# and config #1's data path (CXL P2P DMA into the arena), on device 0's
# arena of ARENA_MB registered as REAL: runtime/hbm.HbmRuntime, at its
# defaults, mirrors every range the engine dirties onto the card.  OVERSUB x
# the arena in managed slices of SLICE_BYTES, two device passes over all of
# them; then an explicit migrate of MIGRATE_BYTES and spans of SPAN_BYTES for
# the card->host writes, suspend/resume and the CXL DMA.
SLICE_BYTES = 32 << 20
OVERSUB = 4
MIGRATE_BYTES = 256 << 20
SPAN_BYTES = 64 << 20
HBM_PAGE = 64 << 10              # uvm_page_size default
RING_SPANS = 256                 # bench.py:346: 256 MIGRATEs of 64 KiB
RING_SPAN = 64 << 10


def _arena_pages(bufs, page=HBM_PAGE):
    """(buffer index, page index, arena offset) of every HBM-resident page of
    ``bufs``, as int64 arrays."""
    rows = [(i, p, r.hbm_offset)
            for i, b in enumerate(bufs)
            for p in range(b.nbytes // page)
            for r in (b.residency(offset=p * page),) if r.hbm]
    return np.array(rows, dtype=np.int64).reshape(-1, 3).T


def _check_pages(rt, bufs, tiles, what, page=HBM_PAGE) -> int:
    """Every HBM-resident page of ``bufs`` read from the card's arena
    (``read_arena``) holds its pattern, ``(tiles[buffer] + page) mod 256``:
    its sum, computed on the card, equals the numpy sum of its pattern, and
    its bytes equal the pattern's.  Returns the number of pages."""
    idx, pg, off = _arena_pages(bufs, page)
    check(len(off) > 0, f"{what}: no page is HBM-resident")
    check(bool((off % page == 0).all()), f"{what}: unaligned arena pages")
    # numpy: the sum of (t + p) mod 256 over a tile t is counts_t . ((v + p)
    # mod 256), counts_t the tile's byte histogram.
    counts = np.stack([np.bincount(t, minlength=256) for t in tiles])
    shift = (np.arange(256)[:, None] + np.arange(256)[None, :]) % 256
    want_sums = (counts @ shift)[idx, pg % 256]
    arena = rt.read_arena(0, rt.arena_bytes).view(-1, page)
    dev = arena.device
    got = arena[torch.from_numpy(off // page).to(dev)]
    sums = got.sum(dim=1, dtype=torch.int64).cpu().numpy()
    check(bool((sums == want_sums).all()),
          f"{what}: {int((sums != want_sums).sum())} of {len(off)} pages "
          f"sum differently on the card")
    want = (torch.from_numpy(np.stack(tiles)).to(dev)[torch.from_numpy(
        idx).to(dev)] + torch.from_numpy(pg % 256).to(
        dev, torch.uint8)[:, None])
    check(torch.equal(got, want), f"{what}: page bytes differ on the card")
    return len(off)


def _fill(buf, tile, page=HBM_PAGE):
    """Page p of ``buf`` gets ``(tile + p) mod 256``."""
    ramp = (np.arange(buf.nbytes // page) % 256).astype(np.uint8)[:, None]
    np.add(tile[None, :], ramp, out=buf.view().reshape(-1, page))


def _cpu_read(buf, offset, length):
    """Managed bytes read through ctypes (the GIL is released while the CPU
    fault is serviced, so the drain thread can serve a readback)."""
    out = np.empty(length, np.uint8)
    ctypes.memmove(out.ctypes.data, buf.address + offset, length)
    return out


def _arena_runs(buf, page=HBM_PAGE):
    """The HBM-resident span of ``buf`` as (buffer offset, arena offset,
    bytes) runs, each contiguous in both."""
    runs = []
    for p in range(buf.nbytes // page):
        r = buf.residency(offset=p * page)
        check(r.hbm, "card->host: a page left HBM")
        if runs and runs[-1][1] + runs[-1][2] == r.hbm_offset and \
                runs[-1][0] + runs[-1][2] == p * page:
            runs[-1][2] += page
        else:
            runs.append([p * page, r.hbm_offset, page])
    return runs


def hbm_slices(vs, rng, arena_bytes, slice_bytes, oversub):
    """``oversub`` x the arena in managed slices of ``slice_bytes``, slice i
    filled with its own pattern (tiles[i] + page) mod 256; returns (slices,
    tiles, seconds the fill took)."""
    nbufs = max(4, oversub * arena_bytes // slice_bytes)
    bufs = [vs.alloc(slice_bytes) for _ in range(nbufs)]
    tiles = [rng.integers(0, 256, HBM_PAGE, dtype=np.uint8)
             for _ in range(nbufs)]
    t0 = time.perf_counter()
    for b, tile in zip(bufs, tiles):
        _fill(b, tile)
    return bufs, tiles, time.perf_counter() - t0


def _passes(bufs) -> float:
    """Two device passes over every slice: pass 1 faults them in, pass 2
    re-faults the evicted ones (the steady fault+evict pipeline)."""
    t0 = time.perf_counter()
    for _ in range(2):
        for b in bufs:
            b.device_access(dev=0, write=False)
    return time.perf_counter() - t0


def hbm_alone(bufs) -> float:
    """Engine GB/s of one pair of passes with the arena not REAL."""
    return 2 * sum(b.nbytes for b in bufs) / _passes(bufs) / 1e9


def hbm_oversub(rt, bufs, tiles):
    """One pair of passes with the arena REAL, the fence inside the timed
    span (bench.py's measure_oversub_fault_bandwidth); then the engine's
    evictions, uploaded <= published, and every HBM-resident page checked
    on the card."""
    from open_gpu_kernel_modules_tpu_torch import utils, uvm
    from open_gpu_kernel_modules_tpu_torch.runtime import native
    lib = native.load()
    uvm.fault_stats_reset_windows()
    before = uvm.fault_stats()
    ce0 = [ch.bytes for ch in uvm.ce.stats().channels]
    m0, r0, n0 = rt.mirrored_bytes, rt.resync_bytes, rt.resyncs
    u0 = rt.upload_seconds
    p0 = lib.tpurmCounterGet(b"hbm_mirror_bytes")
    t0 = time.perf_counter()
    passes_s = _passes(bufs)
    rt.fence()                  # the bytes are on the card before we stop
    dt = time.perf_counter() - t0
    after = uvm.fault_stats()
    crossed = (rt.mirrored_bytes - m0) - (rt.resync_bytes - r0)
    published = lib.tpurmCounterGet(b"hbm_mirror_bytes") - p0
    ce1 = uvm.ce.stats()
    total = 2 * sum(b.nbytes for b in bufs)
    evictions = after.evictions - before.evictions
    check(evictions > 0, "oversub: the engine evicted nothing")
    check(0 < crossed <= published,
          f"oversub: {crossed} bytes crossed to the card, {published} "
          f"published by the engine")
    pages = _check_pages(rt, bufs, tiles, "oversub")
    return {
        "slices": len(bufs), "slice_mb": bufs[0].nbytes >> 20,
        "oversub_bytes": total, "dt_s": dt, "passes_s": passes_s,
        "fence_s": dt - passes_s,
        "chip_verified_gbps": crossed / dt / 1e9,
        "engine_gbps": total / dt / 1e9,
        "chip_verified_mb": crossed / 1e6, "published_dirty_mb":
        published / 1e6, "resync_mb": (rt.resync_bytes - r0) / 1e6,
        "resyncs": rt.resyncs - n0,
        "upload_busy_frac": (rt.upload_seconds - u0) / dt,
        "fault_p50_us": after.service_ns_p50 / 1e3,
        "fault_p95_us": after.service_ns_p95 / 1e3,
        "fault_p99_us": utils.trace_quantile_ns("fault.latency", 0.99) / 1e3,
        "fault_wake_p50_us": after.wake_ns_p50 / 1e3,
        "fault_svc_p50_us": after.svc_one_ns_p50 / 1e3,
        "evictions": evictions, "resident_pages_checked": pages,
        "ce_channels": uvm.ce.channels(),
        "ce_channel_bytes": [ch.bytes - (ce0[i] if i < len(ce0) else 0)
                             for i, ch in enumerate(ce1.channels)],
    }


def hbm_migrate(rt, vs, rng, nbytes):
    """Explicit migrate (bench.py:791-815): HOST -> HBM, fence, the pages
    checked on the card, then HBM -> HOST."""
    from open_gpu_kernel_modules_tpu_torch import uvm
    buf = vs.alloc(nbytes)
    tile = rng.integers(0, 256, HBM_PAGE, dtype=np.uint8)
    _fill(buf, tile)
    m0, r0 = rt.mirrored_bytes, rt.resync_bytes
    t0 = time.perf_counter()
    buf.migrate(uvm.Tier.HBM)
    up = time.perf_counter() - t0
    rt.fence()
    up_chip = time.perf_counter() - t0
    crossed = (rt.mirrored_bytes - m0) - (rt.resync_bytes - r0)
    pages = _check_pages(rt, [buf], [tile], "migrate")
    check(pages == nbytes // HBM_PAGE, f"migrate: {pages} of "
          f"{nbytes // HBM_PAGE} pages in HBM")
    t0 = time.perf_counter()
    buf.migrate(uvm.Tier.HOST)
    down = time.perf_counter() - t0
    check(np.array_equal(_cpu_read(buf, 0, HBM_PAGE), tile),
          "migrate: bytes changed on the way home")
    buf.free()
    return {"migrate_mb": nbytes >> 20,
            "migrate_engine_htod_gbps": nbytes / up / 1e9,
            "migrate_chip_verified_gbps": crossed / up_chip / 1e9,
            "migrate_engine_dtoh_gbps": nbytes / down / 1e9}


def hbm_ring_migrate(rt, vs, rng, spans=RING_SPANS, span_bytes=RING_SPAN):
    """One MemRing batch of ``spans`` MIGRATEs to HBM (bench.py:346's
    shape) and a ring FENCE behind them; the engine's time to the fence's
    completion, then the mirror's fence, then every page checked on the
    card."""
    from open_gpu_kernel_modules_tpu_torch import uvm
    from open_gpu_kernel_modules_tpu_torch.uvm import memring
    nbytes = spans * span_bytes
    buf = vs.alloc(nbytes)
    tile = rng.integers(0, 256, HBM_PAGE, dtype=np.uint8)
    _fill(buf, tile)
    m0, r0 = rt.mirrored_bytes, rt.resync_bytes
    with memring.MemRing(vs, entries=2 * spans) as ring:
        t0 = time.perf_counter()
        for i in range(spans):
            ring.migrate(buf.address + i * span_bytes, span_bytes,
                         uvm.Tier.HBM)
        fence = ring.fence()
        ring.submit_and_wait()
        up = time.perf_counter() - t0
        cqes = ring.completions(max_cqes=2 * spans, check=True)
        rt.fence()
        up_chip = time.perf_counter() - t0
        counts = ring.counts
    check(len(cqes) == spans + 1 and cqes[-1].user_data == fence and
          sum(c.bytes for c in cqes) == nbytes,
          f"ring migrate: {len(cqes)} completions, fence last "
          f"{cqes[-1].user_data == fence}, {sum(c.bytes for c in cqes)} "
          f"bytes")
    check((counts.submitted, counts.completed, counts.error_cqes,
           counts.cq_overflows) == (spans + 1, spans + 1, 0, 0),
          f"ring migrate: counts {counts}")
    crossed = (rt.mirrored_bytes - m0) - (rt.resync_bytes - r0)
    pages = _check_pages(rt, [buf], [tile], "ring migrate")
    check(pages == nbytes // HBM_PAGE, f"ring migrate: {pages} of "
          f"{nbytes // HBM_PAGE} pages in HBM")
    buf.free()
    return {"ring_migrate_mb": nbytes >> 20, "ring_spans": spans,
            "ring_migrate_engine_gbps": nbytes / up / 1e9,
            "ring_migrate_chip_verified_gbps": crossed / up_chip / 1e9,
            "ring_counts": vars(counts)}


def hbm_card_to_host(rt, vs, rng, nbytes):
    """A card computation written into the arena through ``write_arena``:
    with sync=True a CPU read of the managed pages returns the computed
    bytes; with sync=False ``migrate(HOST)`` makes the engine ask for a
    readback and carries them."""
    from open_gpu_kernel_modules_tpu_torch import uvm
    from open_gpu_kernel_modules_tpu_torch.runtime import native
    lib = native.load()
    out = {}
    for sync in (True, False):
        buf = vs.alloc(nbytes)
        src = rng.integers(0, 256, nbytes, dtype=np.uint8)
        buf.view()[:] = src
        buf.device_access(dev=0, write=False)
        rt.fence()
        want = src * np.uint8(3) + np.uint8(7)
        req0 = lib.tpurmCounterGet(b"hbm_readback_requests")
        rb0 = rt.readbacks
        t0 = time.perf_counter()
        for b_off, a_off, length in _arena_runs(buf):
            rt.write_arena(a_off, rt.read_arena(a_off, length) * 3 + 7,
                           sync=sync)
        write_s = time.perf_counter() - t0
        if sync:
            got = _cpu_read(buf, 0, nbytes)
        else:
            t0 = time.perf_counter()
            buf.migrate(uvm.Tier.HOST)
            out["card_to_host_migrate_s"] = time.perf_counter() - t0
            check(lib.tpurmCounterGet(b"hbm_readback_requests") > req0,
                  "card->host: the engine never asked for a readback")
            got = _cpu_read(buf, 0, nbytes)
        check(np.array_equal(got, want),
              f"card->host (sync={sync}): the CPU reads "
              f"{int((got != want).sum())} bytes other than the card's")
        out[f"card_to_host_{'sync' if sync else 'async'}_write_s"] = write_s
        out[f"card_to_host_{'sync' if sync else 'async'}_readbacks"] = \
            rt.readbacks - rb0
        buf.free()
    return out


def hbm_cxl(rt, rng, nbytes):
    """Config #1's data path: CXL -> arena DMA, checked on the card; then a
    card computation left chip-dirty (sync=False) is what arena -> CXL
    carries."""
    import mmap
    from open_gpu_kernel_modules_tpu_torch.runtime import native
    host = mmap.mmap(-1, nbytes)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(host))
    cxl = np.frombuffer(host, dtype=np.uint8)
    pattern = rng.integers(0, 256, nbytes, dtype=np.uint8)
    cxl[:] = pattern
    gpu_off = 0
    try:
        with native.RmClient() as rm:
            handle = rm.register_cxl_buffer(addr, nbytes)
            t0 = time.perf_counter()
            rm.cxl_dma(handle, gpu_off, 0, nbytes, to_device=True)
            to_dev = time.perf_counter() - t0
            rt.fence()
            got = rt.read_arena(gpu_off, nbytes)
            want = torch.from_numpy(pattern).to(got.device)
            check(torch.equal(got, want), "CXL -> arena: the card's bytes "
                  "differ from the CXL buffer's")
            rt.write_arena(gpu_off, got * 5 + 1, sync=False)
            cxl[:] = 0
            t0 = time.perf_counter()
            rm.cxl_dma(handle, gpu_off, 0, nbytes, to_device=False)
            to_cxl = time.perf_counter() - t0
            check(np.array_equal(cxl, pattern * np.uint8(5) + np.uint8(1)),
                  "arena -> CXL: the CXL buffer does not hold the card's "
                  "bytes")
            rm.unregister_cxl_buffer(handle)
    finally:
        del cxl                 # the mapping goes with its last view
    return {"cxl_mb": nbytes >> 20,
            "cxl_to_device_gbps": nbytes / to_dev / 1e9,
            "cxl_from_device_gbps": nbytes / to_cxl / 1e9}


def hbm_suspend_resume(rt, vs, rng, nbytes):
    """uvm.suspend() then resume(): the card's view equals the restored
    bytes."""
    from open_gpu_kernel_modules_tpu_torch import uvm
    buf = vs.alloc(nbytes)
    tile = rng.integers(0, 256, HBM_PAGE, dtype=np.uint8)
    _fill(buf, tile)
    buf.device_access(dev=0, write=True)
    t0 = time.perf_counter()
    uvm.suspend()
    uvm.resume()
    pm_s = time.perf_counter() - t0
    check(buf.residency().hbm, "suspend/resume: the buffer left HBM")
    rt.fence()
    pages = _check_pages(rt, [buf], [tile], "suspend/resume")
    buf.free()
    return {"suspend_resume_s": pm_s, "suspend_resume_pages": pages}


def hbm_overflow(rt):
    """More dirty ranges than the mirror queue holds, published while the
    drain thread is held off its next upload: the overflow latch makes it
    resync the whole arena, and the card then shows the new bytes."""
    from open_gpu_kernel_modules_tpu_torch.runtime import native
    lib = native.load()
    base, _ = native.hbm_view(rt.dev)
    shadow = np.frombuffer((ctypes.c_char * 4096).from_address(base),
                           dtype=np.uint8)
    over0 = lib.tpurmCounterGet(b"hbm_mirror_overflows")
    n0 = rt.resyncs
    shadow[:] = 77
    with rt.hold_drain():
        for _ in range(3 * 8192):   # > hbm_mirror_queue_entries default
            lib.tpuHbmMirrorNotify(base, 4096)
    overflowed = lib.tpurmCounterGet(b"hbm_mirror_overflows") > over0
    t0 = time.perf_counter()
    rt.fence()
    fence_s = time.perf_counter() - t0
    if overflowed:
        check(rt.resyncs > n0, "overflow: no whole-arena resync")
    else:
        log("real arena: the mirror queue never overflowed")
    got = rt.read_arena(0, 4096)
    check(bool((got == 77).all()), "overflow: the card missed the new bytes")
    return {"overflowed": overflowed, "overflow_resyncs": rt.resyncs - n0,
            "overflow_fence_s": fence_s}


def hbm_paths(rt, vs, rng, migrate_bytes, span_bytes):
    """The real arena's other paths, once each: explicit migrate, card->host
    writes, suspend/resume, the forced overflow and CXL DMA each way.  The
    overflow and the CXL DMA write arena offset 0 directly, so they run
    once no managed page of ``vs`` lives in the arena."""
    rec = hbm_migrate(rt, vs, rng, migrate_bytes)
    rec.update(hbm_ring_migrate(rt, vs, rng))
    rec.update(hbm_card_to_host(rt, vs, rng, span_bytes))
    rec.update(hbm_suspend_resume(rt, vs, rng, span_bytes))
    rec.update(hbm_overflow(rt))
    rec.update(hbm_cxl(rt, rng, span_bytes))
    return rec


def in_hbm_copy_gbps(mib: int = 256, iters: int = 10) -> float:
    """Device-to-device copy bandwidth (bytes read plus bytes written per
    second) of a ``mib`` MiB copy, by CUDA events."""
    src = torch.empty(mib << 20, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    dst.copy_(src)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(iters):
        dst.copy_(src)
    ev[1].record()
    ev[1].synchronize()
    ms = ev[0].elapsed_time(ev[1]) / iters
    return 2 * (mib << 20) / (ms / 1e3) / 1e9


def phase_hbm_real(smi):
    """Configs #2 and #1 on device 0's arena registered as REAL, mirrored
    onto the card by HbmRuntime at its defaults.  Launches none of the
    three kernels.

    The first REAL pair is the slices' first device touch (cold), as
    bench.py's first trial is: its numbers are the metric of record.  Then
    warm pairs alternate REAL, alone, alone, REAL (the arena not REAL while
    alone), so a drift from pair to pair cancels in what the consumer costs
    the engine: the REAL pairs' mean engine GB/s over the alone pairs'."""
    from open_gpu_kernel_modules_tpu_torch import uvm
    from open_gpu_kernel_modules_tpu_torch.ops import (flash_attention,
                                                       paged_attention)
    from open_gpu_kernel_modules_tpu_torch.runtime import hbm, native
    launches0 = (paged_attention.launches, flash_attention.launches,
                 flash_attention.rows_launches)
    rng = np.random.default_rng(SEED + 10)
    rec = {}
    t0 = time.perf_counter()
    with uvm.VaSpace() as vs:
        bufs, tiles, rec["populate_s"] = hbm_slices(
            vs, rng, native.hbm_view(0)[1], SLICE_BYTES, OVERSUB)
        with hbm.HbmRuntime(dev=0) as rt:
            check(rt.is_real, "real arena: device 0 is not REAL")
            check(rt.shadow_pinned, "real arena: the shadow is not "
                  "page-locked")
            log(f"real arena: {rt.arena_bytes >> 20} MB on {rt.device}, "
                f"shadow pinned {rt.shadow_pinned}, blocks of "
                f"{rt.block_bytes >> 10} KiB")
            rec.update(hbm_oversub(rt, bufs, tiles))
            warm_real = [hbm_oversub(rt, bufs, tiles)]
        warm_alone = [hbm_alone(bufs), hbm_alone(bufs)]
        with hbm.HbmRuntime(dev=0) as rt:
            warm_real.append(hbm_oversub(rt, bufs, tiles))
            for b in bufs:
                b.free()
            rec["in_hbm_copy_gbps"] = in_hbm_copy_gbps()
            rec["north_star_ratio"] = (rec["chip_verified_gbps"] /
                                       rec["in_hbm_copy_gbps"])
            rec.update(hbm_paths(rt, vs, rng, MIGRATE_BYTES, SPAN_BYTES))
            log(f"real arena: MemRing migrate of {rec['ring_spans']} x "
                f"{RING_SPAN >> 10} KiB: engine "
                f"{rec['ring_migrate_engine_gbps']:.3f} GB/s, chip-verified "
                f"{rec['ring_migrate_chip_verified_gbps']:.3f}; explicit "
                f"migrate of {MIGRATE_BYTES >> 20} MiB: engine "
                f"{rec['migrate_engine_htod_gbps']:.3f}, chip-verified "
                f"{rec['migrate_chip_verified_gbps']:.3f}; ring counts "
                f"{rec['ring_counts']}")
            rec.update(mirrored_mb=rt.mirrored_bytes / 1e6,
                       resync_mb_total=rt.resync_bytes / 1e6,
                       drain_batches=rt.drain_batches,
                       upload_calls=rt.upload_calls,
                       readbacks=rt.readbacks,
                       readback_mb=rt.readback_bytes / 1e6,
                       shadow_pinned=rt.shadow_pinned,
                       block_kib=rt.block_bytes >> 10)
    real_gbps = [r["engine_gbps"] for r in warm_real]
    rec["warm"] = {
        "order": "REAL, alone, alone, REAL",
        "real_engine_gbps": real_gbps,
        "real_chip_verified_gbps": [r["chip_verified_gbps"]
                                    for r in warm_real],
        "real_resyncs": [r["resyncs"] for r in warm_real],
        "real_fault_p50_us": [r["fault_p50_us"] for r in warm_real],
        "alone_engine_gbps": warm_alone,
        "real_over_alone": float(np.mean(real_gbps) / np.mean(warm_alone)),
    }
    rec["phase_s"] = time.perf_counter() - t0
    check((paged_attention.launches, flash_attention.launches,
           flash_attention.rows_launches) == launches0,
          "real arena: a kernel of the main path launched")
    rec["card"] = smi
    log(json.dumps({"hbm_real": rec}))
    return rec


# ----------------------------------------------------------------- phase 11

# Training at full width: B=1 x S=1024 of Llama-3-8B at 32 layers, bf16.
TRAIN = dict(batch=1, seq=1024, steps=3, lr=1e-3)
# The card against the CPU at fp32 (no TF32, device.py): 2 layers, B=1 x
# S=128; only the order of sums differs.
TRAIN_CPU = dict(layers=2, seq=128, rtol=1e-3, atol=1e-5)


def phase_train(cfg, params, gen, smi):
    """Three SGD steps (``entry.sgd_step``) on one seeded batch, then one
    profiled (untimed) step; then the card against the CPU at fp32.  Each
    step's parameters replace those in ``params``, so the caller's are
    freed as the steps go."""
    import dataclasses
    from open_gpu_kernel_modules_tpu_torch import entry
    from open_gpu_kernel_modules_tpu_torch.models import llama
    from open_gpu_kernel_modules_tpu_torch.ops import (flash_attention,
                                                       paged_attention)
    t = TRAIN
    tokens = torch.randint(0, cfg.vocab_size, (t["batch"], t["seq"]),
                           generator=gen, device="cuda")
    targets = tokens.roll(-1, 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        plain = llama.loss_fn(cfg, params, tokens, targets).item()
    reset_counts()
    losses, step_ms = [], []
    for i in range(t["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, new, grads = entry.sgd_step(cfg, params, tokens, targets,
                                          lr=t["lr"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        params.update(new)
        del new
        losses.append(loss)
        if i == 0:
            for g in llama.tree_leaves(grads):
                check(bool(torch.isfinite(g).all()), "train: a gradient "
                      "leaf is not finite")
                check(bool((g != 0).any()), "train: a gradient leaf is 0")
            check(abs(loss - plain) <= 1e-6 * abs(plain),
                  f"train: autograd loss {loss} != no_grad loss {plain}")
        del grads
    launched = (paged_attention.launches, flash_attention.launches,
                flash_attention.rows_launches)
    check(launched == (0, 0, 0), f"train: kernels launched {launched}")
    check(all(np.isfinite(losses)), f"train: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tok_s = t["batch"] * t["seq"] * 1e3 / float(np.mean(step_ms[1:]))
    host, kern, rows = profiled(
        lambda: entry.sgd_step(cfg, params, tokens, targets, lr=t["lr"]))
    busy = "not measured" if kern is None else f"{kern / host:.3f}"
    log(f"train: Llama-3-8B {cfg.num_layers} layers bf16 B={t['batch']} "
        f"S={t['seq']}: losses {[round(x, 4) for x in losses]} (no_grad "
        f"{plain:.4f}); step ms {[round(x, 1) for x in step_ms]} (host "
        f"clock, synced); {tok_s:.1f} training tok/s (steps 2-3); peak "
        f"{peak:.1f} GiB; profiled step {host:.1f} ms host, kernels "
        f"{kern if kern is None else round(kern, 1)} ms, busy share {busy}")
    for name, ms in rows[:5]:
        log(f"  {ms:8.3f} ms  {name[:90]}")

    # The card against the CPU: the same fp32 parameters, tokens, loss and
    # the gradients of wq[0] and lm_head.
    c = TRAIN_CPU
    ccfg = dataclasses.replace(cfg, num_layers=c["layers"],
                               dtype=torch.float32)
    cgen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    card = llama.init_params(ccfg, cgen, device="cuda")
    ctoks = torch.randint(0, cfg.vocab_size, (1, c["seq"]), generator=cgen,
                          device="cuda")
    host_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                       if isinstance(v, dict) else v.cpu())
                   for k, v in card.items()}
    got = {}
    t0 = time.perf_counter()
    for where, p, toks in (("card", card, ctoks),
                           ("cpu", host_params, ctoks.cpu())):
        loss, _, grads = entry.sgd_step(ccfg, p, toks, toks.roll(-1, 1),
                                        lr=t["lr"])
        got[where] = (loss, grads["layers"]["wq"][0].cpu(),
                      grads["lm_head"].cpu())
    del card, host_params, grads, _
    torch.cuda.empty_cache()
    errs = {}
    for i, name in enumerate(("loss", "wq[0] grad", "lm_head grad")):
        a = torch.as_tensor(got["card"][i])
        b = torch.as_tensor(got["cpu"][i])
        errs[name] = max_err(a, b)
        check(bool(torch.isclose(a, b, rtol=c["rtol"], atol=c["atol"]).all()),
              f"train: card and CPU {name} differ by {errs[name]} beyond "
              f"rtol {c['rtol']}, atol {c['atol']}")
    log(f"train: card vs CPU at fp32, {c['layers']} layers, S={c['seq']}: "
        f"max |diff| {errs} (rtol {c['rtol']}, atol {c['atol']}); "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(losses=losses, step_ms=step_ms, tok_s=tok_s,
                peak_gib=peak, busy=busy, card=smi)


# ----------------------------------------------------------------- phase 12

# (b): the parallel API at Llama-3-8B widths with the depth cut to 2 layers,
# dp2 x tp2 x sp2 in 8 rank processes on the one card.
PAR = dict(mesh=(2, 2, 2), layers=2, tokens=(4, 256), attn=(2, 2048, 32, 128))
# bf16 limits of one sharded step against the unsharded one (PERF.md
# section 2): the loss within 1e-2 relative; gradients within 5% of their
# largest magnitude (bf16 activations summed over tp in another order);
# updated weights within one bf16 ulp (2^-7 relative).  lr * g is mostly
# below the weights' bf16 resolution, so a step moves few weights: those
# that moved in exactly one of the two steps must be at most a quarter of
# those the unsharded step moved, which fails a step that moved none or
# moved others.
PAR_TOL = dict(loss_rtol=1e-2, grad_frac=0.05, param_rtol=2 ** -7,
               param_atol=1e-6, moved_frac=0.25)


def _par_rank(cfg, tokens, targets, ref_path):
    """One rank of phase 12(b): the sharded train step against the
    unsharded reference the parent saved, then ring and Ulysses attention
    at S=2048 in fp32 and bf16."""
    from open_gpu_kernel_modules_tpu_torch import entry
    from open_gpu_kernel_modules_tpu_torch.models import llama
    from open_gpu_kernel_modules_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from open_gpu_kernel_modules_tpu_torch.parallel import (
        make_mesh, ring_attention_sharded, shard_params,
        ulysses_attention_sharded)
    torch.cuda.reset_peak_memory_stats()
    rec, ms = {}, {}
    t0 = time.perf_counter()
    mesh = make_mesh(*PAR["mesh"], device="cuda")
    d, t, s = mesh.get_coordinate()
    full = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 12), "cuda")
    local = shard_params(full, mesh, cfg)
    del full
    torch.cuda.synchronize()
    ms["init"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    loss, new, grads = entry.sgd_step(
        cfg, local, torch.from_numpy(tokens).cuda(),
        torch.from_numpy(targets).cuda(), mesh)
    torch.cuda.synchronize()
    ms["train_step"] = (time.perf_counter() - t0) * 1e3
    # Keep only the compared leaves: eight ranks share the card.
    picked = [("wq[0]", local["layers"]["wq"][0], new["layers"]["wq"][0],
               grads["layers"]["wq"][0], 1),
              ("wo[0]", local["layers"]["wo"][0], new["layers"]["wo"][0],
               grads["layers"]["wo"][0], 0),
              ("lm_head", local["lm_head"], new["lm_head"], grads["lm_head"],
               0)]
    del local, new, grads
    torch.cuda.empty_cache()
    ref = torch.load(ref_path, mmap=True)
    tp = PAR["mesh"][1]
    rec["loss"], rec["ref_loss"] = loss, ref["loss"]
    check(abs(loss - ref["loss"]) <= PAR_TOL["loss_rtol"] * abs(ref["loss"]),
          f"parallel: sharded loss {loss} vs unsharded {ref['loss']}")
    # (name, before, after, gradient, the dim split over tp), compared 512
    # rows at a time so no whole fp32 copy of lm_head's shard is made.
    for name, before, after, grad, dim in picked:
        want = ref[name].chunk(tp, dim)[t]
        want_g = ref[name + " grad"].chunk(tp, dim)[t]
        err = gerr = gmax = moved = ref_moved = odd = 0.0
        ok = True
        for i in range(0, after.shape[0], 512):
            rows = slice(i, i + 512)
            w_rows = want[rows].cuda()
            a, w = after[rows].float(), w_rows.float()
            g, wg = grad[rows].float(), want_g[rows].cuda().float()
            err = max(err, max_err(a, w))
            gerr = max(gerr, max_err(g, wg))
            gmax = max(gmax, float(wg.abs().max()))
            mine, theirs = after[rows] != before[rows], w_rows != before[rows]
            moved += float(mine.sum())
            ref_moved += float(theirs.sum())
            odd += float((mine != theirs).sum())
            ok &= bool(((a - w).abs() <= PAR_TOL["param_atol"] +
                        PAR_TOL["param_rtol"] * w.abs()).all())
        gtol = PAR_TOL["grad_frac"] * gmax
        rec[name] = dict(max_abs_err=err, grad_err=gerr, grad_tol=gtol,
                         moved=moved / after.numel(),
                         ref_moved=ref_moved / after.numel(),
                         moved_apart=odd / after.numel())
        check(ok, f"parallel: updated {name} differs by {err}")
        check(gerr <= gtol, f"parallel: {name} gradient differs by {gerr} "
              f"(limit {gtol})")
        check(0 < ref_moved and odd <= PAR_TOL["moved_frac"] * ref_moved,
              f"parallel: {name}: {odd:.0f} weights moved in one of the "
              f"sharded and unsharded steps only, of {ref_moved:.0f} the "
              f"unsharded step moved (limit {PAR_TOL['moved_frac']})")
    del picked, ref
    torch.cuda.empty_cache()

    # Ring and Ulysses at S=2048: equal at fp32, each within the flash
    # kernel's bf16 limits of the plain fp32 attention in bf16.
    b, sl, h, hd = PAR["attn"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    q, k, v = (torch.randn((b, sl, h, hd), generator=g, device="cuda")
               for _ in range(3))
    launches = flash_attention.launches
    for dtype in (torch.float32, torch.bfloat16):
        x = [a.to(dtype) for a in (q, k, v)]
        t0 = time.perf_counter()
        ring = ring_attention_sharded(*x, mesh)
        torch.cuda.synchronize()
        ms[f"ring_{str(dtype)[6:]}"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        uly = ulysses_attention_sharded(*x, mesh)
        torch.cuda.synchronize()
        ms[f"ulysses_{str(dtype)[6:]}"] = (time.perf_counter() - t0) * 1e3
        if dtype == torch.float32:
            err = max_err(ring, uly)
            rec["ring_vs_ulysses_fp32"] = err
            check(err <= 2e-4, f"parallel: ring and Ulysses differ by {err}")
            continue
        row = slice(d, d + 1)
        plain = flash_attention_reference(*(a[row].float() for a in x))
        for name, out in (("ring", ring), ("ulysses", uly)):
            rec[f"{name}_bf16_err"] = max_err(out[row], plain)
            check(within_tol(out[row], plain), f"parallel: {name} bf16 "
                  f"beyond {TOL[torch.bfloat16]} of the plain fp32 version")
        del plain
    rec["flash_launches"] = flash_attention.launches - launches
    rec["ms"] = ms
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return rec


def phase_parallel(smi):
    """(a) ``entry.dryrun_multichip(8)`` as a user calls it; (b) the same
    API at Llama-3-8B widths (2 layers) on dp2 x tp2 x sp2, held against one
    unsharded step computed here first.  Runs before the 8B parameters
    exist: eight ranks on one card, each with its own CUDA context.  Returns
    the flash kernel's launches inside the ranks' Ulysses calls."""
    import dataclasses
    import tempfile
    from open_gpu_kernel_modules_tpu_torch import entry
    from open_gpu_kernel_modules_tpu_torch.models import llama
    from open_gpu_kernel_modules_tpu_torch.parallel import mesh as pmesh
    log(f"parallel: backend {pmesh.BACKEND!r} (NCCL refuses two ranks of "
        f"one communicator on one card; gloo stages CUDA tensors through "
        f"the host); {torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(8)
    dry_s = time.perf_counter() - t0
    launches = dry["flash_launches"]
    check(launches == 8, f"dryrun: B2 launched {launches} times in the "
          f"ranks' Ulysses calls, expected 8")
    for r, rk in enumerate(dry["ranks"]):
        log(f"  dryrun rank {r}: train {rk['train_ms']:.1f} ms, ring "
            f"{rk['ring_ms']:.1f} ms, Ulysses {rk['ulysses_ms']:.1f} ms, "
            f"ring-Ulysses {rk['ring_ulysses_err']:.3g}, peak "
            f"{rk['peak_mib']:.1f} MiB")
    log(f"parallel (a): dryrun_multichip(8) {dry_s:.1f} s (ranks "
        f"{dry['ranks_s']:.1f} s, native ICI {dry['native_ici_s']:.1f} s)")

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_layers=PAR["layers"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    tokens = torch.randint(0, cfg.vocab_size, PAR["tokens"], generator=gen,
                           device="cuda")
    targets = tokens.roll(-1, 1)
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 12), "cuda")
    loss, new, grads = entry.sgd_step(cfg, params, tokens, targets)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save({"loss": loss,
                    "wq[0]": new["layers"]["wq"][0].cpu(),
                    "wq[0] grad": grads["layers"]["wq"][0].cpu(),
                    "wo[0]": new["layers"]["wo"][0].cpu(),
                    "wo[0] grad": grads["layers"]["wo"][0].cpu(),
                    "lm_head": new["lm_head"].cpu(),
                    "lm_head grad": grads["lm_head"].cpu()}, ref_path)
        del params, new, grads
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = pmesh.run_ranks(_par_rank, 8, (cfg, tokens.cpu().numpy(),
                                               targets.cpu().numpy(),
                                               ref_path),
                                device="cuda", timeout_s=600)
        par_s = time.perf_counter() - t0
    log("  parallel rank 0: " + json.dumps(ranks[0]))
    for r, rk in enumerate(ranks[1:], 1):
        log(f"  parallel rank {r}: loss {rk['loss']:.6f}, ms "
            f"{json.dumps({k: round(v, 1) for k, v in rk['ms'].items()})},"
            f" peak {rk['peak_gib']:.2f} GiB")
    b_launches = sum(rk["flash_launches"] for rk in ranks)
    check(b_launches == 16, f"parallel (b): B2 launched {b_launches} times "
          f"in the ranks, expected 16 (fp32 and bf16 Ulysses, 8 ranks)")
    log(f"parallel (b): dp2xtp2xsp2 Llama-3-8B widths, {cfg.num_layers} "
        f"layers, tokens {PAR['tokens']}: loss {ranks[0]['loss']:.4f} "
        f"sharded vs {loss:.4f} unsharded; unsharded step {ref_s:.1f} s; "
        f"8 ranks {par_s:.1f} s; B2 launches {b_launches}; {smi}")
    return launches + b_launches


# ----------------------------------------------------------------- phase 13

# Serving under injected faults, and poison containment: the JAX package's
# tests/test_stress.py::test_sched_soak_injection and
# ::test_corruption_sched_containment at Llama-3-8B width on phase 8's
# prompts and pages.  Four slots at oversub 4: the slot pool holds 10 pages
# of 64 tokens, a stream needs 9 (504 + 32), so streams decode one at a time
# and the resets' parks and restores move 72 MiB each.  32 new tokens, not
# phase 8's 64: at one stream a round, each run is 8 streams x 8 rounds, and
# the phase runs four of them beside the evacuation.
CHAOS = dict(max_seqs=4, oversub=4, new=32, tokens_per_round=4,
             cancel_after=3, cancel=(5, 6), resets=3)
# Every site at 1% (the JAX engine soak's rate for large workloads: here
# evaluations scale with the bytes), dump.write at 12.5% (the JAX soak's).
CHAOS_PPM = 10000
DUMP_PPM = 125000
CHAOS_SEED = 42
# mem.corrupt is evaluated once per sealed 4 KiB page: at this width at 1%
# every admission poisons the KV it just parked, in its own slot (run (a1);
# 47 flips in 5088 evaluations on the H100, PERF.md section 6).  The soak
# (a2) keeps the JAX soak's expected flips a run instead: its 37
# evaluations at 50000 PPM (tests/test_torch_stress.py) make 1.85, and the
# soak here makes about 25400 evaluations, so 73 PPM.
SOAK_CORRUPT_PPM = 73
# Containment: at most three scoped one-shot flips, each re-armed only when
# the previous ones have resolved and no stream has errored; the seal scope
# is the 4 KiB page's address (the shield seals engine pages of 4 KiB).
CONTAIN_SHOTS = 3
CONTAIN_SEED = 5
SEAL_PAGE = 4096


def chaos_scheduler(cfg, params, prompts):
    """A Scheduler at phase 13's shape with every prompt submitted (stream
    i of tenant i % 2)."""
    from open_gpu_kernel_modules_tpu_torch.runtime import sched
    c = CHAOS
    s = sched.Scheduler(cfg, params, max_seqs=c["max_seqs"],
                        max_len=SCHED["max_len"], page_size=SCHED["page"],
                        oversub=c["oversub"],
                        tokens_per_round=c["tokens_per_round"])
    reqs = [s.submit(p, c["new"], tenant=i % 2)
            for i, p in enumerate(prompts)]
    return s, reqs


def chaos_finish(s, reqs, before=None, resets=0):
    """The JAX soak's choreography: step; after round ``cancel_after``
    cancel the streams of ``cancel``; force a device reset after each of the
    next ``resets`` rounds; step until idle.  ``before()`` runs ahead of
    every round.  Returns the run's record: tokens and state by rid, the
    decode batch of every round that decoded, each stream's decoded count
    after it, the report, and the MTTR of each forced reset."""
    from open_gpu_kernel_modules_tpu_torch.runtime import sched
    from open_gpu_kernel_modules_tpu_torch.uvm import reset
    c = CHAOS
    batches, progress, mttr = [], [], []
    rounds = 0
    t0 = time.perf_counter()
    while not s.idle and rounds < 5000:
        if before:
            before()
        d0 = s.stats["decoded_tokens"]
        s.step()
        rounds += 1
        n = (s.stats["decoded_tokens"] - d0) // s.tokens_per_round
        if n:
            batches.append(n)
            progress.append({r.rid: r.decoded for r in reqs})
        if rounds == c["cancel_after"]:
            for r in reqs:
                if r.rid in c["cancel"]:
                    s.cancel(r.rid)
        elif rounds > c["cancel_after"] and len(mttr) < resets and \
                not s.idle:
            reset.device_reset()
            mttr.append(reset.stats().last_mttr_ms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = sched.RequestState.FINISHED
    return dict(
        tokens={r.rid: np.asarray(r.tokens) for r in reqs
                if r.state is done},
        states={r.rid: r.state.value for r in reqs},
        batches=batches, progress=progress, rounds=rounds, wall=wall,
        rep=s.report(wall), mttr_ms=mttr)


def chaos_compare(name, run, ref):
    """``run``'s tokens against ``ref``'s (PERF.md section 2): equal for
    every stream both finished when every round's decode batch matched;
    otherwise equal in the rounds before the first that differs (bf16 cuBLAS
    and B1's split plan round alike within a batch bucket, apart across
    buckets); the agreement is printed either way."""
    b, rb = run["batches"], ref["batches"]
    first = next((i for i, (x, y) in enumerate(zip(b, rb)) if x != y),
                 None if len(b) == len(rb) else min(len(b), len(rb)))
    both = sorted(set(run["tokens"]) & set(ref["tokens"]))
    if first is None:
        for rid in both:
            check(np.array_equal(run["tokens"][rid], ref["tokens"][rid]),
                  f"{name}: every round's batch matched the reference's "
                  f"but stream {rid}'s tokens differ")
    elif first > 0:
        for rid, n in run["progress"][first - 1].items():
            n = min(n, ref["progress"][first - 1].get(rid, 0))
            if rid in both and n:
                check(np.array_equal(run["tokens"][rid][:n],
                                     ref["tokens"][rid][:n]),
                      f"{name}: stream {rid}'s first {n} tokens, decoded "
                      f"before round {first + 1}, differ from the "
                      f"reference's")
    same = [bool(np.array_equal(run["tokens"][r], ref["tokens"][r]))
            for r in both]
    log(f"chaos {name}: decode batches {b} (reference {rb}); first round "
        f"that differs {None if first is None else first + 1}; "
        f"{sum(same)} of {len(both)} streams finished in both equal the "
        f"reference's")


def containment_stats(rep) -> str:
    """The Scheduler's preemption, round-error and containment counts."""
    return ", ".join(f"{k} {rep.get(k, 0)}" for k in (
        "preempted", "restored", "round_errors", "poisoned",
        "free_slots_retired", "unservable"))


def chaos_counters():
    from open_gpu_kernel_modules_tpu_torch import utils
    names = ("journal_dump_errors", "journal_dumps", "hot_inject_skips",
             "tpusched_poisoned_retired", "tpusched_seq_slots_retired",
             "shield_retired_realloc", "vac_crc_verifies",
             "vac_crc_mismatches", "vac_crc_reships", "vac_aborts")
    return {n: utils.counter(n) for n in names}


def spine_counts():
    """The memring spine's SQE counters, per subsystem and per shard; the
    shard count is the registry's, defaulting as the engine does to the
    online CPUs, at most 8."""
    from open_gpu_kernel_modules_tpu_torch import utils
    shards = utils.registry_get("memring_internal_shards",
                                min(os.cpu_count() or 1, 8))
    c = utils.counter
    return {"shards": shards,
            "internal_sqes": c("memring_internal_sqes"),
            "by_subsystem": [c(f"memring_internal_sqes[{k}]")
                             for k in ("fault", "tier", "ici", "migrate")],
            "inline": c("memring_internal_inline"),
            "shard": c("memring_shard_sqes"),
            "per_shard": [c(f"memring_shard_sqes[s{i}]")
                          for i in range(shards)]}


def chaos_soak(cfg, params, prompts, name, corrupt_ppm):
    """(a): every site armed at CHAOS_PPM, mem.corrupt at ``corrupt_ppm``,
    dump.write at DUMP_PPM, the forced resets, the cancels; then a crash
    dump with the sites still armed.  Every arm is taken back in
    ``finally``.  Returns the run's record with its deltas."""
    from open_gpu_kernel_modules_tpu_torch.uvm import (inject, journal,
                                                       reset, shield)
    c = CHAOS
    r0, sh0, ctr0 = reset.stats(), shield.stats(), chaos_counters()
    hits0 = inject.stats()
    inject.set_seed(CHAOS_SEED)
    try:
        for site in inject.Site:
            inject.enable(site, inject.Mode.PPM, CHAOS_PPM)
        inject.enable(inject.Site.MEM_CORRUPT, inject.Mode.PPM, corrupt_ppm)
        inject.enable(inject.Site.DUMP_WRITE, inject.Mode.PPM, DUMP_PPM)
        s, reqs = chaos_scheduler(cfg, params, prompts)
        try:
            run = chaos_finish(s, reqs, resets=c["resets"])
        finally:
            s.close()
        # With the sites still armed: dump.write's invariant is never
        # vacuous.
        journal.crash_dump("chip_smoke.chaos")
    finally:
        inject.disable_all()
    r1, sh1, ctr1 = reset.stats(), shield.stats(), chaos_counters()
    run["hits"] = {k: v[1] - hits0[k][1] for k, v in inject.stats().items()}
    run["evals"] = {k: v[0] - hits0[k][0] for k, v in inject.stats().items()}
    run["resets"] = r1.resets - r0.resets
    run["injected_resets"] = r1.injected_resets - r0.injected_resets
    run["shield"] = {k: getattr(sh1, k) - getattr(sh0, k)
                     for k in vars(sh1)}
    run["ctr"] = {k: ctr1[k] - ctr0[k] for k in ctr0}
    run["journal"] = journal.stats()
    run["name"] = name
    log(f"chaos {name}: mem.corrupt at {corrupt_ppm} PPM; rounds "
        f"{run['rounds']}, wall {run['wall']:.2f} s, agg_toks_per_s "
        f"{run['rep']['agg_toks_per_s']}, states {run['states']}, resets "
        f"{run['resets']} (forced {len(run['mttr_ms'])}, injected "
        f"{run['injected_resets']}), " + containment_stats(run['rep']))
    log(f"chaos {name} hits per site: {json.dumps(run['hits'])}")
    log(f"chaos {name} evaluations per site: {json.dumps(run['evals'])}")
    log(f"chaos {name} shield: {json.dumps(run['shield'])}; counters "
        f"{json.dumps(run['ctr'])}; recovery "
        f"{json.dumps(inject.recovery_counters())}")
    return run


def check_soak(run, ref, streams, forced, exact=True):
    """test_sched_soak_injection's invariants, on deltas over the run;
    ``forced`` forced resets must have run.  A stream is ERROR when a
    poison retired it, or when every slot was retired before it was served
    (``unservable``).  ``exact=False``: a flip sealed in a 2 MiB block that
    another flip already poisoned is never verified, so mem.corrupt's
    corrupts may exceed detected + misses (the engine's gap, ROADMAP.md
    section C); the unverified flips are printed."""
    c, name = CHAOS, run["name"]
    rep, sh, ctr = run["rep"], run["shield"], run["ctr"]
    err = sorted(r for r, st in run["states"].items() if st == "error")
    err_noncancel = [r for r in err if r not in c["cancel"]]
    check(sorted(list(run["tokens"]) + err_noncancel) ==
          sorted(ref["tokens"]),
          f"chaos {name}: finished {sorted(run['tokens'])} + ERROR "
          f"{err_noncancel} != the reference's {sorted(ref['tokens'])}")
    po, un = rep.get("poisoned", 0), rep.get("unservable", 0)
    check(set(run["states"].values()) <= {"finished", "cancelled", "error"},
          f"chaos {name}: states {run['states']}")
    check(len(err) == po + un, f"chaos {name}: {len(err)} ERROR streams, "
          f"{po} poisoned, {un} unservable")
    check(rep["retired"] + rep["cancelled"] + po + un == streams,
          f"chaos {name}: retired {rep['retired']} + cancelled "
          f"{rep['cancelled']} + poisoned {po} + unservable {un} != "
          f"{streams}")
    check(rep["finished"] == rep["retired"] ==
          streams - rep["cancelled"] - len(err),
          f"chaos {name}: finished {rep['finished']}, retired "
          f"{rep['retired']}")
    check(rep["restored"] <= rep["preempted"],
          f"chaos {name}: restored {rep['restored']} > preempted "
          f"{rep['preempted']}")
    check(len(run["mttr_ms"]) >= forced and
          rep["device_resets_observed"] >= len(run["mttr_ms"]) and
          all(m > 0 for m in run["mttr_ms"]),
          f"chaos {name}: forced {len(run['mttr_ms'])} resets (at least "
          f"{forced}), observed {rep['device_resets_observed']}, MTTR "
          f"{run['mttr_ms']}")
    check(run["resets"] == len(run["mttr_ms"]) + run["injected_resets"],
          f"chaos {name}: {run['resets']} resets != forced "
          f"{len(run['mttr_ms'])} + injected {run['injected_resets']}")
    hits = run["hits"]
    unverified = sh["inject_corrupts"] - sh["inject_detected"] - \
        sh["inject_misses"]
    check(hits["mem.corrupt"] == sh["inject_corrupts"] and
          sh["inject_misses"] == 0 and
          (unverified == 0 if exact else unverified >= 0),
          f"chaos {name}: mem.corrupt hits {hits['mem.corrupt']}, shield "
          f"{sh}")
    if unverified:
        log(f"chaos {name}: {unverified} of {sh['inject_corrupts']} flips "
            f"never verified (sealed in a block already poisoned)")
    check(ctr["shield_retired_realloc"] == 0,
          f"chaos {name}: a retired span was handed out again")
    check(ctr["tpusched_poisoned_retired"] ==
          ctr["tpusched_seq_slots_retired"] == po,
          f"chaos {name}: poisoned_retired "
          f"{ctr['tpusched_poisoned_retired']}, slots_retired "
          f"{ctr['tpusched_seq_slots_retired']}, poisoned {po}")
    if po or rep.get("free_slots_retired", 0):
        check(sh["pages_poisoned"] > 0 and sh["pages_retired"] > 0,
              f"chaos {name}: {po} poisoned streams, "
              f"{rep.get('free_slots_retired', 0)} slots retired, shield "
              f"{sh}")
    check(run["evals"]["sched.admit"] > 0, f"chaos {name}: admission gate "
          f"never evaluated")
    check(sum(1 for h in hits.values() if h > 0) >= 2,
          f"chaos {name}: fewer than two sites fired: {hits}")
    check(run["evals"]["vac.migrate"] == 0 and hits["vac.migrate"] == 0,
          f"chaos {name}: the single-chip backing ran a chip migration")
    check(hits["hot.decide"] == ctr["hot_inject_skips"],
          f"chaos {name}: hot.decide hits {hits['hot.decide']} != skips "
          f"{ctr['hot_inject_skips']}")
    check(run["evals"]["dump.write"] > 0 and ctr["journal_dumps"] >= 1 and
          hits["dump.write"] == ctr["journal_dump_errors"],
          f"chaos {name}: dump.write hits {hits['dump.write']}, evaluations "
          f"{run['evals']['dump.write']}, counters {ctr}")
    emitted, dropped, cap = run["journal"]
    check(cap == 16384 and dropped == 0 and emitted > 0,
          f"chaos {name}: journal emitted {emitted}, dropped {dropped}, cap "
          f"{cap}")


def contain_run(cfg, params, prompts):
    """(b): exclusive parks (read duplication off), then before each round a
    running stream is parked (its backing becomes the only copy), a scoped
    one-shot mem.corrupt is armed on its first K page and a pressure park
    seals the pool and fires it; its restore must read the flip back."""
    from open_gpu_kernel_modules_tpu_torch.runtime import sched
    from open_gpu_kernel_modules_tpu_torch.uvm import inject, shield
    from open_gpu_kernel_modules_tpu_torch.uvm.managed import Tier
    def unresolved():
        st = shield.stats()
        return st.inject_corrupts - st.inject_detected - st.inject_misses

    s, reqs = chaos_scheduler(cfg, params, prompts)
    backing = s.cache.backing
    shots = [0]
    # Flips an earlier run left unverified (ROADMAP.md section C) stay so:
    # a shot is re-armed once its predecessors resolved, against them.
    unresolved0 = unresolved()

    def errored():
        return [r.rid for r in reqs if r.state is sched.RequestState.ERROR]

    def hook():
        if errored() or shots[0] >= CONTAIN_SHOTS or \
                unresolved() != unresolved0:
            return
        targets = [r for r in s._running.values()
                   if r.seq is not None and int(s.cache.seq_lens[r.seq]) > 0]
        if not targets:
            return
        t = targets[0]
        off = (t.seq * s.cache.pages_per_seq * backing.rec_bytes) & \
            ~(SEAL_PAGE - 1)
        s._preempt(t)
        inject.arm_oneshot(inject.Site.MEM_CORRUPT,
                           scope=backing.k_buf.address + off)
        backing.k_buf.migrate(Tier.CXL)
        shots[0] += 1

    inject.set_seed(CONTAIN_SEED)
    try:
        for buf in (backing.k_buf, backing.v_buf):
            buf.set_read_duplication(False)
            buf.migrate(Tier.CXL)
        run = chaos_finish(s, reqs, before=hook)
    finally:
        inject.disable_all()
        s.close()
    run["shots"] = shots[0]
    run["errored"] = errored()
    return run


def contain_evacuation(cfg, params, mc):
    """(b) on phase 9's pool: M2_0's prompts and shape, with chip 1's
    records moved to chip 2 after round 3 under mem.corrupt every second
    evaluation; the per-record wire CRC must catch every flip and re-ship."""
    from open_gpu_kernel_modules_tpu_torch.uvm import inject
    prompts, ref_tokens, ref_batches = mc
    moved = []

    def corrupt_evacuation(s):
        inject.enable(inject.Site.MEM_CORRUPT, inject.Mode.NTH, 2)
        try:
            moved.append(s.evacuate_device(1, 2))
        finally:
            inject.disable(inject.Site.MEM_CORRUPT)
        check(moved[-1] is not None and moved[-1].pages > 0,
              "chaos (b): the evacuation 1 -> 2 under mem.corrupt aborted")
    tokens, rep, batches, before, moves, (blackouts, _) = \
        multichip_sched_run(cfg, params, prompts,
                            after={3: corrupt_evacuation})
    compare_tokens("C_evac", tokens, batches, before,
                   (ref_tokens, ref_batches))
    return rep, moves, blackouts


def phase_chaos(cfg, params, prompts, mc, smi):
    """Serving under injected faults, and poison containment, at full width
    (the JAX package's chaos soak and containment tests): (a) a reference
    run and a chaos run of the soak's choreography; (b) scoped one-shot
    flips poisoning a parked stream's K page, a fresh scheduler on the
    quarantined arena, and an evacuation on phase 9's pool under
    mem.corrupt.  Returns B1's launches."""
    from open_gpu_kernel_modules_tpu_torch.ops import (flash_attention,
                                                       paged_attention)
    from open_gpu_kernel_modules_tpu_torch.uvm import (inject, reset,
                                                       shield, vac)
    c = CHAOS
    streams = len(prompts)
    t_phase = time.perf_counter()
    log(f"chaos: {CHAOS}, prompts {prompts.shape}, pages of "
        f"{SCHED['page']}, max_len {SCHED['max_len']}; every site at "
        f"{CHAOS_PPM} PPM, dump.write at {DUMP_PPM} PPM, seed {CHAOS_SEED}")
    # Earlier phases' resets, link failures and evacuations left health
    # evidence; the watchdog must not escalate on it here.
    for d in range(ARENAS):
        vac.clear(d)
    reset.watchdog_start()
    torch.cuda.synchronize()
    reset_counts()
    launches_floor = 0

    # (a) The soak: its uninjected reference, then the chaos run.
    s, reqs = chaos_scheduler(cfg, params, prompts)
    try:
        ref = chaos_finish(s, reqs)
    finally:
        s.close()
    check(sorted(ref["tokens"]) == [r for r in range(1, streams + 1)
                                    if r not in c["cancel"]],
          f"chaos reference: states {ref['states']}")
    log(f"chaos reference: rounds {ref['rounds']}, wall {ref['wall']:.2f} "
        f"s, agg_toks_per_s {ref['rep']['agg_toks_per_s']}, batches "
        f"{ref['batches']}")
    # (a1) every site at 1%, mem.corrupt too; (a2) the soak, mem.corrupt
    # at SOAK_CORRUPT_PPM.
    every = chaos_soak(cfg, params, prompts, "(a1) all at 1%", CHAOS_PPM)
    check_soak(every, ref, streams, forced=0, exact=False)
    chaos_compare("(a1) all at 1%", every, ref)
    soak = chaos_soak(cfg, params, prompts, "(a2) soak", SOAK_CORRUPT_PPM)
    check_soak(soak, ref, streams, forced=c["resets"])
    chaos_compare("(a2) soak", soak, ref)
    launches_floor += len(ref["batches"]) + len(every["batches"]) + \
        len(soak["batches"])

    # (b) Containment on the managed arena, then a fresh scheduler on it.
    r0, ctr0 = reset.stats().resets, chaos_counters()
    hits0 = inject.counts(inject.Site.MEM_CORRUPT)[1]
    sh0 = shield.stats()
    contain = contain_run(cfg, params, prompts)
    ctr = {k: v - ctr0[k] for k, v in chaos_counters().items()}
    rep = contain["rep"]
    nerr = len(contain["errored"])
    log(f"chaos (b) containment: shots {contain['shots']}, ERROR streams "
        f"{contain['errored']}, rounds {contain['rounds']}, wall "
        f"{contain['wall']:.2f} s, states {contain['states']}, " +
        containment_stats(rep))
    check(1 <= nerr < streams, f"chaos (b): {nerr} ERROR streams")
    check(set(contain["states"].values()) <= {"finished", "cancelled",
                                              "error"},
          f"chaos (b): states {contain['states']}")
    err_noncancel = [r for r in contain["errored"] if r not in c["cancel"]]
    check(sorted(list(contain["tokens"]) + err_noncancel) ==
          sorted(ref["tokens"]),
          "chaos (b): finished + poisoned != the reference's finished")
    check(reset.stats().resets == r0, "chaos (b): a poison reset the device")
    check(ctr["tpusched_poisoned_retired"] ==
          ctr["tpusched_seq_slots_retired"] == rep.get("poisoned", 0) ==
          nerr,
          f"chaos (b): poisoned_retired {ctr['tpusched_poisoned_retired']}, "
          f"slots_retired {ctr['tpusched_seq_slots_retired']}, poisoned "
          f"{rep.get('poisoned')}, ERROR {nerr}")
    check(rep["retired"] + rep["cancelled"] + nerr == streams,
          f"chaos (b): retired {rep['retired']} + cancelled "
          f"{rep['cancelled']} + poisoned {nerr} != {streams}")
    chaos_compare("(b) containment", contain, ref)
    disarmed = {k: v[1] for k, v in inject.stats().items()}
    s, reqs = chaos_scheduler(cfg, params, prompts)
    try:
        clean = chaos_finish(s, reqs)
    finally:
        s.close()
    check({k: v[1] for k, v in inject.stats().items()} == disarmed,
          "chaos (b): a site hit after every arm was taken back")
    check(clean["batches"] == ref["batches"] and
          sorted(clean["tokens"]) == sorted(ref["tokens"]) and
          all(np.array_equal(clean["tokens"][r], ref["tokens"][r])
              for r in ref["tokens"]),
          "chaos (b): the fresh scheduler on the quarantined arena did not "
          "decode the reference's tokens")
    check(chaos_counters()["shield_retired_realloc"] ==
          ctr0["shield_retired_realloc"],
          "chaos (b): a retired span was handed out again")
    launches_floor += len(contain["batches"]) + len(clean["batches"])
    launches = paged_attention.launches
    expect = cfg.num_layers * c["tokens_per_round"] * launches_floor
    check(launches >= expect, f"chaos: paged decode launched {launches} "
          f"times, fewer than one per layer per decode step ({expect})")
    check(flash_attention.launches == 0 and flash_attention.rows_launches == 0,
          "chaos launched a flash kernel")

    # (b) on phase 9's pool: the vac window's wire CRC under mem.corrupt.
    # Its decode rounds are the multichip path's (B1 launches counted with
    # the phase's, not required per round).
    v0 = chaos_counters()
    evac_rep, moves, blackouts = contain_evacuation(cfg, params, mc)
    vc = {k: v - v0[k] for k, v in chaos_counters().items()}
    log(f"chaos (b) evacuation: moves {moves}, blackouts ms "
        f"{[round(b * 1e3, 3) for b in blackouts]}, vac "
        f"{ {k: vc[k] for k in vc if k.startswith('vac_')} }, "
        f"agg_toks_per_s {evac_rep['agg_toks_per_s']}")
    check(vc["vac_crc_mismatches"] > 0 and
          vc["vac_crc_reships"] == vc["vac_crc_mismatches"] and
          vc["vac_aborts"] == 0,
          f"chaos (b) evacuation: vac counters {vc}")
    check(vac.txns_active() == 0, "chaos: a vac manifest is still open")
    launches = paged_attention.launches

    # Exact over (b): every flip detected, none missed.
    sh = shield.stats()
    hits = inject.counts(inject.Site.MEM_CORRUPT)[1] - hits0
    corrupts = sh.inject_corrupts - sh0.inject_corrupts
    detected = sh.inject_detected - sh0.inject_detected
    misses = sh.inject_misses - sh0.inject_misses
    check(hits == corrupts == detected + misses and misses == 0,
          f"chaos (b): mem.corrupt hits {hits}, corrupts {corrupts}, "
          f"detected {detected}, misses {misses}")
    check(sh.pages_poisoned - sh0.pages_poisoned >= nerr,
          "chaos (b): fewer pages poisoned than streams errored")
    sp = spine_counts()
    check(sp["internal_sqes"] > 0 and
          sp["internal_sqes"] == sum(sp["by_subsystem"]) and
          sp["by_subsystem"][0] > 0 and
          sp["internal_sqes"] == sp["shard"] + sp["inline"] and
          sum(sp["per_shard"]) == sp["shard"],
          f"chaos: spine accounting {sp}")
    hits_after = {k: v[1] for k, v in inject.stats().items()}
    scrubbed = shield.scrub_now()
    mttr = np.array(soak["mttr_ms"])
    check({k: v[1] for k, v in inject.stats().items()} == hits_after,
          "chaos: a site hit after every arm was taken back")
    log(f"chaos: spine {json.dumps(sp)}; retired pages "
        f"{shield.retired_pages()}; scrub pass {scrubbed} pages; forced "
        f"reset MTTR p50 {np.percentile(mttr, 50):.3f} ms, max "
        f"{mttr.max():.3f} ms; recovery "
        f"{json.dumps(inject.recovery_counters(detail=True))}")
    log(f"chaos: agg_toks_per_s reference {ref['rep']['agg_toks_per_s']}, "
        f"all at 1% {every['rep']['agg_toks_per_s']}, soak "
        f"{soak['rep']['agg_toks_per_s']}, containment "
        f"{contain['rep']['agg_toks_per_s']}, clean "
        f"{clean['rep']['agg_toks_per_s']}; rounds {ref['rounds']}, "
        f"{every['rounds']}, {soak['rounds']}, {contain['rounds']}, "
        f"{clean['rounds']}; B1 "
        f"launches {launches}; phase {time.perf_counter() - t_phase:.1f} s; "
        f"{smi}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # Read by the native engine when it loads (it has not yet).
    os.environ["TPUMEM_FAKE_HBM_MB"] = str(ARENA_MB)
    os.environ["TPUMEM_FAKE_TPU_COUNT"] = str(ARENAS)
    # Crash bundles (phase 13's dump.write site, vac aborts) and phase 8's
    # trace export go to a directory of the run's own.
    dumps = tempfile.mkdtemp(prefix="chip_smoke_dumps.")
    os.environ["TPUMEM_DUMP_DIR"] = dumps
    try:
        return run()
    finally:
        shutil.rmtree(dumps, ignore_errors=True)


def run() -> int:
    from open_gpu_kernel_modules_tpu_torch.models import llama

    smi = phase_build()
    b1 = phase_paged()
    b2 = phase_flash()
    b3, b3_launches = phase_flash_rows()
    # Eight rank processes, each with its own CUDA context, before the 8B
    # parameters take their 16 GB.
    reset_counts()
    b2_launches = phase_parallel(smi)

    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"params: Llama-3-8B widths, {cfg.num_layers} layers, bf16, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, "
        f"{time.perf_counter() - t0:.1f} s")
    # B1's main-path launches: dense `generate`, tiered `decode_rounds`
    # and the Scheduler's rounds, each path's count read from zero.
    b1_launches = phase_serving(cfg, params, gen)
    b2_launches += phase_flash_forward(cfg, params, gen)
    tiered_launches, *tiered = phase_tiered(cfg, params, gen)
    b1_launches += tiered_launches
    launches, sched_prompts = phase_sched(cfg, params, gen,
                                          os.environ["TPUMEM_DUMP_DIR"])
    b1_launches += launches
    launches, m2_0 = phase_multichip(cfg, params, gen, tiered, smi)
    b1_launches += launches
    phase_hbm_real(smi)
    # After the real arena, whose size its quarantined pages would cut, and
    # before training, which replaces the parameters.
    b1_launches += phase_chaos(cfg, params, sched_prompts, m2_0, smi)
    # Last: its SGD steps replace the parameters.
    phase_train(cfg, params, gen, smi)

    # Which body each kernel runs per dtype at the main shapes: all three
    # take the tensor cores in bf16 and keep FMAs in fp32.
    from open_gpu_kernel_modules_tpu_torch.ops.flash_attention import BODY
    from open_gpu_kernel_modules_tpu_torch.ops.paged_attention import body
    flash_path = {str(dt)[6:]: b for dt, b in BODY.items()}
    paged_path = {str(dt)[6:]: body(dt, cfg.num_heads // cfg.num_kv_heads,
                                    cfg.head_dim) for dt in BODY}
    kernels = [
        dict(name="paged_decode", route="cuda",
             source="open_gpu_kernel_modules_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="open_gpu_kernel_modules_tpu/ops/paged_attention.py:35",
             launches=b1_launches, path=paged_path,
             **b1),
        dict(name="flash_attn", route="cuda",
             source="open_gpu_kernel_modules_tpu_torch/ops/csrc/flash_attn.cu",
             replaces="open_gpu_kernel_modules_tpu/ops/flash_attention.py:103",
             launches=b2_launches, path=flash_path, **b2),
        dict(name="flash_rows", route="cuda",
             source="open_gpu_kernel_modules_tpu_torch/ops/csrc/flash_rows.cu",
             replaces="open_gpu_kernel_modules_tpu/ops/flash_attention.py:37",
             launches=b3_launches, path=flash_path, **b3),
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
