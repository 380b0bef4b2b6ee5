"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerances (atol, rtol): fp32 (1e-4, 0), the order of sums; bf16 (2e-2,
1.6e-2), two bf16 ulps on top, since the kernels round the pre-scaled Q and
P to bf16 where the plain versions keep fp32.  chip_smoke.py uses the same.
"""

import dataclasses

import pytest
import torch

from open_gpu_kernel_modules_tpu_torch.models import llama, serving
from open_gpu_kernel_modules_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference, rows_segment_tokens)
from open_gpu_kernel_modules_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_reference, split_plan)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,d,p", [(8, 4, 32, 16), (32, 8, 128, 64),
                                      (4, 4, 16, 8), (16, 2, 256, 16)])
def test_paged_decode_matches_reference(gen, dtype, h, kv, d, p):
    b, m = 4, 5
    n = b * m
    q = _randn(gen, (b, h, d), dtype)
    kp, vp = (_randn(gen, (n, p, kv, d), dtype) for _ in range(2))
    table = torch.randperm(n, generator=gen, device="cuda").to(
        torch.int32).reshape(b, m)
    lens = torch.tensor([0, 1, p + 3, m * p], dtype=torch.int32,
                        device="cuda")
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, table, lens, h)
    ref = paged_attention_reference(q, kp, vp, table, lens, h)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert (out[0] == 0).all()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def _paged_check(gen, b, h, kv, d, p, m, lens, dtype):
    """The kernel against the plain version on a permuted table whose
    lens = 0 rows hold page ids outside the pool; those rows must be exactly
    zero and the call must count one launch."""
    n = b * m
    q = _randn(gen, (b, h, d), dtype)
    kp, vp = (_randn(gen, (n, p, kv, d), dtype) for _ in range(2))
    table = torch.randperm(n, generator=gen, device="cuda").to(
        torch.int32).reshape(b, m)
    for i, s in enumerate(lens):
        if s == 0:
            table[i] = torch.tensor([n + 99, -7] * m, dtype=torch.int32)[:m]
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, table, seq_lens, h)
    ref = paged_attention_reference(q, kp, vp, table, seq_lens, h)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert out.dtype == dtype and torch.isfinite(out).all()
    for i, s in enumerate(lens):
        if s == 0:
            assert (out[i] == 0).all()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_paged_decode_heads_and_dims(gen, rep, d, dtype):
    """Every tensor-core tile width and rep of the main models, and their
    FMA twins: 12 splits of one page each, the second row's later splits
    all empty, a lens = 0 row with garbage page ids."""
    b, kv, p, m = 3, 2, 16, 12
    assert split_plan(b * kv, m) == (1, 12)
    _paged_check(gen, b, rep * kv, kv, d, p, m, [0, 13, 150], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["long", "one_split", "one_page",
                                  "past_table", "wide_rep", "odd_dim",
                                  "tiered_group", "page_5", "page_12",
                                  "page_48", "page_128"])
def test_paged_decode_splits(gen, case, dtype):
    """B=1 at 8192 tokens (32 splits of 4 pages, all in flight), the
    one-split path (B*KV >= 264, and M = 1), lens past M*P, the bf16 shapes
    the tensor-core tile does not take (rep 32; D = 72), and page sizes whose
    TMA boxes hold 1, 4, 16 or 64 rows (a stage spanning pages, or a page
    spanning stages)."""
    b, h, kv, d, p, m, lens, splits = {
        "long": (1, 32, 8, 128, 64, 128, [8192], 32),
        "one_split": (40, 8, 8, 64, 16, 4, [(7 * i) % 65 for i in range(40)],
                      1),
        "one_page": (2, 8, 2, 128, 64, 1, [0, 50], 1),
        "past_table": (2, 8, 2, 64, 16, 3, [1000, 48], 3),
        "wide_rep": (2, 32, 1, 128, 64, 9, [544, 0], 9),
        "odd_dim": (3, 8, 2, 72, 16, 8, [0, 100, 128], 8),
        "tiered_group": (4, 32, 8, 128, 64, 9, [513, 518, 523, 528], 9),
        "page_5": (2, 8, 4, 128, 5, 7, [33, 0], 7),
        "page_12": (3, 8, 2, 64, 12, 6, [0, 70, 40], 6),
        "page_48": (2, 16, 4, 128, 48, 5, [200, 97], 5),
        "page_128": (2, 32, 8, 128, 128, 3, [300, 129], 3),
    }[case]
    assert split_plan(b * kv, m)[1] == splits
    _paged_check(gen, b, h, kv, d, p, m, lens, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d,causal,layout,prescale", [
    (200, 64, True, "bshd", True), (200, 64, False, "bshd", True),
    (128, 128, True, "bhsd", True), (77, 128, False, "bhsd", False),
    (1, 64, True, "bshd", True)])
def test_flash_matches_reference(gen, dtype, s, d, causal, layout, prescale):
    shape = (2, 3, s, d) if layout == "bhsd" else (2, s, 3, d)
    q, k, v = (_randn(gen, shape, dtype) for _ in range(3))
    kw = dict(causal=causal, prescale_q=prescale, layout=layout)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    ref = flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d,causal,layout,prescale", [
    (200, 64, True, "bshd", True),        # fits shared memory whole
    (256, 128, True, "bshd", True),       # fits whole in bf16, not in fp32
    (1000, 128, True, "bhsd", True),      # needs segments
    (777, 64, False, "bshd", False),      # segments, full, no prescale
    (130, 128, False, "bhsd", True),      # ragged tail block
    (1, 64, True, "bshd", True)])
def test_flash_rows_matches_reference(gen, dtype, s, d, causal, layout,
                                      prescale):
    shape = (2, 3, s, d) if layout == "bhsd" else (2, s, 3, d)
    q, k, v = (_randn(gen, shape, dtype) for _ in range(3))
    kw = dict(causal=causal, prescale_q=prescale, layout=layout)
    grid, rows = flash_attention.launches, flash_attention.rows_launches
    out = flash_attention(q, k, v, impl="rows", **kw)
    ref = flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.rows_launches == rows + 1
    assert flash_attention.launches == grid
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("impl", ["grid", "rows"])
@pytest.mark.parametrize("prescale", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 1000])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_tensor_cores_match_reference(gen, d, s, layout, causal,
                                            prescale, impl):
    """bf16 runs the wgmma/TMA core: one 64-column swizzled box per row at
    D=64, two at D=128; lengths around one block and a ragged tail that
    TMA zero-fills; the transposed V descriptor is checked by the values."""
    shape = (2, 3, s, d) if layout == "bhsd" else (2, s, 3, d)
    q, k, v = (_randn(gen, shape, torch.bfloat16) for _ in range(3))
    kw = dict(causal=causal, prescale_q=prescale, layout=layout)
    counts = (flash_attention.launches, flash_attention.rows_launches)
    out = flash_attention(q, k, v, impl=impl, **kw)
    ref = flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    rose = (flash_attention.launches - counts[0],
            flash_attention.rows_launches - counts[1])
    assert rose == ((0, 1) if impl == "rows" else (1, 0))
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("impl", ["grid", "rows"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 96])
def test_flash_padded_head_dims_match_reference(gen, d, dtype, layout,
                                                causal, impl):
    """head_dims the kernels take by zero-padding to 64 (16, 32) or 128
    (96): the output keeps the true head_dim and the softmax its scale,
    one launch a call."""
    s = 130
    shape = (2, 3, s, d) if layout == "bhsd" else (2, s, 3, d)
    q, k, v = (_randn(gen, shape, dtype) for _ in range(3))
    kw = dict(causal=causal, layout=layout)
    counts = (flash_attention.launches, flash_attention.rows_launches)
    out = flash_attention(q, k, v, impl=impl, **kw)
    ref = flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    rose = (flash_attention.launches - counts[0],
            flash_attention.rows_launches - counts[1])
    assert rose == ((0, 1) if impl == "rows" else (1, 0))
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def test_flash_rejects_head_dims_it_cannot_pad(gen):
    for d in (12, 136):
        x = _randn(gen, (1, 8, 2, d), torch.bfloat16)
        with pytest.raises(ValueError, match="the kernels take 64 and 128"):
            flash_attention(x, x, x)


def test_tiny_forward_use_flash_on_card(gen):
    """tiny (head_dim 16) runs its prefill attention through the flash
    kernel, padded to 64, and agrees with the plain attention."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=128),
                              dtype=torch.float32)
    params = llama.init_params(cfg, gen, device="cuda")
    tokens = torch.randint(0, 128, (2, 40), generator=gen, device="cuda")
    before = flash_attention.launches
    flash = llama.forward(cfg, params, tokens, use_flash=True)
    plain = llama.forward(cfg, params, tokens, use_flash=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.num_layers
    torch.testing.assert_close(flash, plain, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_a_ulysses_local_shape(gen, dtype):
    """B2 at the shape Ulysses hands it in chip_smoke's parallel phase:
    Llama-3-8B's 32 heads over sp=2 (16 local heads), the full S=2048,
    D=128, made contiguous by the head/sequence reshard."""
    q, k, v = (_randn(gen, (1, 2, 2048, 16, 128), dtype)
               .permute(1, 0, 2, 3, 4)[1] for _ in range(3))
    q, k, v = (x.reshape(1, 2048, 16, 128) for x in (q, k, v))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def _sp_attention_rank(dtype):
    """One rank of test_sequence_parallel_attention_on_card."""
    from open_gpu_kernel_modules_tpu_torch.parallel import (
        make_mesh, ring_attention_sharded, ulysses_attention_sharded)

    mesh = make_mesh(1, 1, 2, "cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((2, 256, 8, 128), generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    before = flash_attention.launches
    ring = ring_attention_sharded(q, k, v, mesh)
    uly = ulysses_attention_sharded(q, k, v, mesh)
    ref = flash_attention_reference(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    return (flash_attention.launches - before,
            float((ring.float() - ref).abs().max()),
            float((uly.float() - ref).abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sequence_parallel_attention_on_card(gen, dtype):
    """Ring and Ulysses attention in two gloo ranks on the card: Ulysses
    launches B2 once a rank, and both agree with the plain fp32 attention
    (fp32: the order of sums; bf16: inputs rounded to bf16 the same way,
    outputs within the kernels' bf16 tolerance)."""
    from open_gpu_kernel_modules_tpu_torch.parallel import mesh as pmesh

    atol = TOL[dtype]["atol"] + (0.0 if dtype == torch.float32 else 2e-2)
    for launches, ring_err, uly_err in pmesh.run_ranks(
            _sp_attention_rank, 2, (dtype,), device="cuda", timeout_s=240):
        assert launches == 1
        assert ring_err <= atol and uly_err <= atol, (ring_err, uly_err)


@pytest.mark.parametrize("impl", ["grid", "rows"])
def test_flash_tensor_cores_many_ctas(gen, impl):
    """The main shape: 32 heads x 32 q blocks of CTAs run the causal ring
    (grid) or the resident segments (rows) at once."""
    q, k, v = (_randn(gen, (1, 2048, 32, 128), torch.bfloat16)
               for _ in range(3))
    out = flash_attention(q, k, v, causal=True, impl=impl)
    ref = flash_attention_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])


def test_flash_rows_segments():
    """The short main case stages its row whole; S=2048 needs segments."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seg = rows_segment_tokens(256, 256, 128, torch.bfloat16, True)
    assert seg >= 256
    assert rows_segment_tokens(2048, 2048, 128, torch.bfloat16, True) < 2048
    assert rows_segment_tokens(2048, 2048, 128, torch.bfloat16, True) % 64 == 0


def test_tiny_serving_on_card_matches_cpu(gen):
    """fp32 tiny model: the card's logits (paged kernel in every layer)
    agree with the CPU's plain path."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=128),
                              dtype=torch.float32, head_dim=32,
                              num_heads=4, num_kv_heads=2, hidden_size=128)
    params = llama.init_params(cfg, gen, device="cuda")
    cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    prompt = torch.randint(0, 128, (2, 9), generator=gen, device="cuda")
    outs = []
    for dev, prm in (("cuda", params), ("cpu", cpu_params)):
        cache = serving.PagedKVCache.create(cfg, 2, 16, page_size=8,
                                            device=dev)
        first, cache = serving.prefill(cfg, prm, prompt.to(dev), cache)
        nxt = prompt[:, -1].to(device=dev, dtype=torch.int32)
        logits, _ = serving.decode_step(cfg, prm, nxt, cache)
        outs.append((first.cpu(), logits.cpu()))
    for on_card, on_cpu in zip(*outs):
        torch.testing.assert_close(on_card, on_cpu, atol=1e-4, rtol=1e-4)


def test_paged_impl_selects_the_path(gen):
    """On the card "auto" and "kernel" launch the kernel; "jnp" is the
    caller's request for the plain version and launches nothing."""
    h, kv, d, p, b, m = 8, 4, 64, 16, 2, 3
    q = _randn(gen, (b, h, d), torch.float32)
    kp, vp = (_randn(gen, (b * m, p, kv, d), torch.float32) for _ in range(2))
    table = torch.arange(b * m, dtype=torch.int32, device="cuda").reshape(b, m)
    lens = torch.tensor([5, 40], dtype=torch.int32, device="cuda")
    ref = paged_attention_reference(q, kp, vp, table, lens, h)
    for impl, launched in (("auto", 1), ("kernel", 1), ("jnp", 0)):
        before = paged_attention.launches
        out = paged_attention(q, kp, vp, table, lens, h, impl=impl)
        torch.cuda.synchronize()
        assert paged_attention.launches == before + launched
        torch.testing.assert_close(out, ref, **TOL[torch.float32])
    with pytest.raises(ValueError, match="impl"):
        paged_attention(q, kp, vp, table, lens, h, impl="pallas")


@pytest.mark.parametrize("kernel", ["paged", "flash_grid", "flash_rows"])
def test_kernels_on_a_second_device(gen, kernel):
    """Each kernel's opt-in to more than 48 KB of shared memory holds for
    one device only: a launch on cuda:1 after one on cuda:0 must still get
    it.  B1 at the main shape needs 64 KB."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    if kernel == "paged":
        h, kv, d, p, b, m = 32, 8, 128, 64, 8, 9
        args = [_randn(gen, (b, h, d), torch.bfloat16)]
        args += [_randn(gen, (b * m, p, kv, d), torch.bfloat16)
                 for _ in range(2)]
        args += [torch.randperm(b * m, generator=gen, device="cuda").to(
                     torch.int32).reshape(b, m),
                 torch.full((b,), 544, dtype=torch.int32, device="cuda")]
        run = lambda *x: paged_attention(*x, h)
        ref = paged_attention_reference(*args, h)
    else:
        impl = kernel.split("_")[1]
        args = [_randn(gen, (1, 1000, 4, 128), torch.bfloat16)
                for _ in range(3)]
        run = lambda *x: flash_attention(*x, causal=True, impl=impl)
        ref = flash_attention_reference(*args, causal=True)
    for dev in ("cuda:0", "cuda:1"):
        out = run(*(x.to(dev) for x in args))
        torch.cuda.synchronize(dev)
        assert out.device == torch.device(dev)
        torch.testing.assert_close(out.float().cpu(), ref.float().cpu(),
                                   **TOL[torch.bfloat16])


def test_tiny_tiered_decode_on_card_matches_cpu(gen):
    """fp32 tiny model through the 4x-oversubscribed tiered cache: the
    card (slot pool on the card, paged kernel in every layer, prefetch on
    a side stream) gives the CPU's greedy tokens and the same stats."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=128),
                              dtype=torch.float32, head_dim=32,
                              num_heads=4, num_kv_heads=2, hidden_size=128)
    params = llama.init_params(cfg, gen, device="cuda")
    cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    prompts = torch.randint(0, 128, (4, 9), generator=gen, device="cuda")
    outs = []
    for dev, prm in (("cuda", params), ("cpu", cpu_params)):
        cache = serving.TieredKVCache(cfg, batch=4, max_len=64, page_size=8,
                                      oversub=4, device=dev)
        try:
            for g in ([0, 1], [2, 3]):
                serving.prefill_group(cfg, prm, cache, g,
                                      prompts[g].to(dev))
            launches = paged_attention.launches
            serving.decode_rounds(cfg, prm, cache, [[0, 1], [2, 3]],
                                  tokens_per_turn=3, turns=3)
            if dev == "cuda":
                assert paged_attention.launches == launches + 2 * 3 * 2 * 3
                assert cache.stats["prefetched_uploads"] > 0
            outs.append((cache.last_token.copy(), dict(cache.stats)))
        finally:
            cache.close()
    assert (outs[0][0] == outs[1][0]).all()
    assert outs[0][1] == outs[1][1]


def test_hbm_runtime_on_card(gen):
    """The real-arena runtime on the card: the shadow is page-locked, a
    fault into the engine's HBM tier lands in the card's arena (read there
    page by page, equal to the pattern), a card computation written back
    through ``write_arena`` is what the CPU then reads, and close() unpins
    the shadow so a second runtime pins it again."""
    import numpy as np

    from open_gpu_kernel_modules_tpu_torch import uvm
    from open_gpu_kernel_modules_tpu_torch.runtime import hbm

    page = 64 * 1024
    with hbm.HbmRuntime(device="cuda") as rt:
        assert rt.is_real and rt.shadow_pinned
        with uvm.VaSpace() as vs:
            buf = vs.alloc(1 << 20)
            pattern = np.random.default_rng(0).integers(
                0, 256, buf.nbytes, dtype=np.uint8)
            buf.view()[:] = pattern
            buf.device_access(dev=0)
            rt.fence()
            want = torch.from_numpy(pattern).cuda()
            for off in range(0, buf.nbytes, page):
                pres = buf.residency(offset=off)
                assert pres.hbm
                got = rt.read_arena(pres.hbm_offset, page)
                assert got.is_cuda and torch.equal(got, want[off:off + page])
            off = buf.residency().hbm_offset
            rt.write_arena(off, rt.read_arena(off, page) * 2 + 1)
            assert (buf.view()[:page] == pattern[:page] * 2 + 1).all()
            assert (buf.view()[page:] == pattern[page:]).all()
            buf.free()
    with hbm.HbmRuntime(device="cuda") as rt2:
        assert rt2.shadow_pinned
        rt2.fence()


@pytest.mark.parametrize("waiter", ["stream", "event"])
def test_copy_stream_waits_release_the_gil(gen, waiter):
    """The drain thread of ``runtime.hbm`` waits for its copy stream; the
    wait must release the GIL, or the thread the engine's CPU fault
    service needs would starve every other Python thread meanwhile."""
    import threading

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(200_000_000)          # about 0.1 s of the card
        event = torch.cuda.Event()
        event.record()
    started, done = threading.Event(), threading.Event()

    def wait():
        started.set()
        (stream if waiter == "stream" else event).synchronize()
        done.set()

    t = threading.Thread(target=wait)
    t.start()
    started.wait()
    ticks = 0
    while not done.is_set():
        ticks += 1
    t.join()
    assert ticks > 10_000
