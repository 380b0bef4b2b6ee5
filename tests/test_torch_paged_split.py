"""The paged decode kernel's split-KV algorithm on the CPU.

``split_model`` is a plain torch model of what ``csrc/paged_decode.cu``
computes on the card: each split of ``pages_per_split`` table entries gives a
base-2 partial (m, l, acc) over its live tokens, an empty split the partial
(-1e30, 0, 0), and the partials combine as m = max m_i, l = sum l_i 2^(m_i -
m), acc = sum acc_i 2^(m_i - m), out = acc / (l or 1).  It lives here, in the
tests only.  It is held against the JAX package's ``paged_attention`` (its
jnp path and its Pallas kernel in interpret mode) at fp32, atol 2e-5, as the
JAX package's own kernel test.  The host's rule for the number of splits
(``split_plan``) and the body a shape runs (``body``) are tested as plain
functions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_gpu_kernel_modules_tpu.ops import paged_attention as jpaged
from open_gpu_kernel_modules_tpu_torch.ops.flash_attention import LOG2_E
from open_gpu_kernel_modules_tpu_torch.ops.paged_attention import (
    SMS, body, split_plan)

from torch_port_util import normal, to_np

EMPTY_M = -1e30


def split_model(q, k_pages, v_pages, table, lens, num_heads, pps):
    """[B, H, D] from per-split partials combined, in the kernel's order of
    operations: Q scaled by log2(e)/sqrt(D) and rounded to its type, P
    rounded to V's type before PV, l over the unrounded p."""
    b, h, d = q.shape
    n, p, kv, _ = k_pages.shape
    m = table.shape[1]
    rep = h // kv
    splits = -(-m // pps)
    qs = (q.float() * (LOG2_E / d ** 0.5)).to(q.dtype).float()
    out = torch.empty(b, h, d)
    for bi in range(b):
        live = min(max(int(lens[bi]), 0), m * p)
        ms, ls, accs = [], [], []
        for s in range(splits):
            first = s * pps * p
            tok = torch.arange(first, max(first, min(live, first + pps * p)))
            if len(tok) == 0:
                ms.append(torch.full((h,), EMPTY_M))
                ls.append(torch.zeros(h))
                accs.append(torch.zeros(h, d))
                continue
            pages = table[bi, tok // p].long().clamp(0, n - 1)
            k = k_pages[pages, tok % p].float().repeat_interleave(rep, dim=1)
            v = v_pages[pages, tok % p].repeat_interleave(rep, dim=1)
            scores = torch.einsum("hd,thd->ht", qs[bi], k)
            mi = scores.amax(dim=1)
            pr = torch.exp2(scores - mi[:, None])
            ms.append(mi)
            ls.append(pr.sum(dim=1))
            accs.append(torch.einsum("ht,thd->hd", pr.to(v.dtype).float(),
                                     v.float()))
        mi, li, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
        mx = mi.amax(dim=0)
        w = torch.exp2(mi - mx)                                   # [splits, H]
        den = (li * w).sum(dim=0)
        num = (acc * w[:, :, None]).sum(dim=0)
        out[bi] = num / torch.where(den == 0, torch.ones_like(den), den)[:, None]
    return out.to(q.dtype)


CASES = {
    # b, h, kv, d, page, m, seq_lens
    "ragged": (2, 8, 4, 32, 16, 4, [37, 61]),
    # Short rows: with one entry per split, more splits than live pages.
    "short": (3, 8, 2, 32, 8, 6, [3, 9, 0]),
}


def _inputs(b, h, kv, d, page, m, seq_lens, seed=0):
    pool = b * m
    q = normal(seed, (b, h, d))
    k = normal(seed + 1, (pool, page, kv, d))
    v = normal(seed + 2, (pool, page, kv, d))
    table = np.random.default_rng(seed).permutation(pool).reshape(
        b, m).astype(np.int32)
    return q, k, v, table, np.asarray(seq_lens, np.int32)


@pytest.mark.parametrize("impl", ["jnp", "kernel"])
@pytest.mark.parametrize("pps", ["one_split", "two_splits", "each_entry"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_model_matches_jax(case, pps, impl):
    b, h, kv, d, page, m, seq_lens = CASES[case]
    pages = {"one_split": m, "two_splits": -(-m // 2), "each_entry": 1}[pps]
    arrays = _inputs(b, h, kv, d, page, m, seq_lens)
    ref = jpaged(*map(jnp.asarray, arrays), h, impl=impl)
    out = split_model(*map(torch.from_numpy, arrays), h, pages)
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=2e-5)
    for i, s in enumerate(seq_lens):
        if s == 0:
            np.testing.assert_array_equal(to_np(out)[i], 0.0)


@pytest.mark.parametrize("impl", ["jnp", "kernel"])
def test_split_model_empty_row_and_lens_past_table(impl):
    """lens = 0 with page ids outside the pool gives an exact zero row
    (every split's partial is empty: m stays -1e30, so no NaN); lens past
    M*P sees the M*P tokens the table covers, as JAX does."""
    q, k, v, table, _ = _inputs(2, 4, 2, 16, 8, 3, [0, 0], seed=3)
    table[0] = [99, -7, 6]
    lens = np.asarray([0, 1000], np.int32)
    ref = jpaged(*map(jnp.asarray, (q, k, v, table, lens)), 4, impl=impl)
    for pages in (1, 2, 3):
        out = split_model(*map(torch.from_numpy, (q, k, v, table, lens)), 4,
                          pages)
        assert torch.isfinite(out).all()
        np.testing.assert_array_equal(to_np(out)[0], 0.0)
        np.testing.assert_allclose(to_np(out), to_np(ref), atol=2e-5)


@pytest.mark.parametrize("batch_kv,m,pps,splits", [
    (64, 9, 2, 5),       # dense serving: B=8, KV=8, 544 tokens
    (32, 9, 1, 9),       # a tiered decode group: B=4
    (8, 128, 4, 32),     # one 8192-token context
    (256, 32, 16, 2),    # large batch: B=32, 2048 tokens
])
def test_split_plan_main_shapes(batch_kv, m, pps, splits):
    """The four shapes chip_smoke.py times: their splits, and a grid within
    10% of two waves on the H100's SMs or more."""
    assert split_plan(batch_kv, m) == (pps, splits)
    assert batch_kv * splits >= 0.9 * 2 * SMS


def test_split_plan_covers_the_table():
    """Every split takes whole table entries, together all M and none
    empty; the grid has more CTAs than B*KV whenever B*KV < 2*SMS and
    M > 1, and one split otherwise."""
    for batch_kv in list(range(1, 70)) + [128, 255, 263, 264, 265, 1024]:
        for m in list(range(0, 40)) + [64, 100, 128, 257, 1000]:
            pps, splits = split_plan(batch_kv, m)
            assert pps >= 1 and splits >= 1
            assert pps * splits >= m
            assert (splits - 1) * pps < max(m, 1)
            if batch_kv < 2 * SMS and m > 1:
                assert splits > 1
            else:
                assert splits == 1


def test_body_by_shape():
    """bf16 takes the tensor cores at the head dims of its tile and at most
    16 query heads per kv head; fp32 and every other bf16 shape the FMA
    body."""
    assert body(torch.bfloat16, 4, 128) == "tensor_cores"
    assert body(torch.bfloat16, 16, 16) == "tensor_cores"
    assert body(torch.bfloat16, 1, 256) == "tensor_cores"
    assert body(torch.float32, 4, 128) == "fma"
    assert body(torch.bfloat16, 32, 128) == "fma"
    assert body(torch.bfloat16, 4, 72) == "fma"
