"""The port's paged decode attention (its plain version, which a CPU tensor
runs) against the JAX package's jnp path and its Pallas kernel in interpret
mode.  fp32 tolerance 2e-5, as the JAX package's own kernel test uses."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_gpu_kernel_modules_tpu.ops import paged_attention as jpaged
from open_gpu_kernel_modules_tpu_torch.ops import paged_attention as tpaged
from open_gpu_kernel_modules_tpu_torch.ops.paged_attention import (
    paged_attention_reference)

from torch_port_util import normal, to_np

CASES = {
    # b, h, kv, d, page, m, seq_lens
    "ragged": (2, 8, 4, 32, 16, 4, [37, 61]),
    "zero_and_full": (3, 8, 4, 32, 8, 4, [0, 32, 9]),
    "mha": (2, 4, 4, 32, 8, 2, [5, 16]),
}


def _inputs(b, h, kv, d, page, m, seq_lens, seed=0):
    pool = b * m
    q = normal(seed, (b, h, d))
    k = normal(seed + 1, (pool, page, kv, d))
    v = normal(seed + 2, (pool, page, kv, d))
    table = np.random.default_rng(seed).permutation(pool).reshape(
        b, m).astype(np.int32)
    return q, k, v, table, np.asarray(seq_lens, np.int32)


@pytest.mark.parametrize("impl", ["auto", "jnp", "kernel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case, impl):
    """Each ``impl`` of JAX against the port called with the same one (on
    a CPU tensor every ``impl`` of the port runs its plain version)."""
    b, h, kv, d, page, m, seq_lens = CASES[case]
    arrays = _inputs(b, h, kv, d, page, m, seq_lens)
    ref = jpaged(*map(jnp.asarray, arrays), h, impl=impl)
    out = tpaged(*map(torch.from_numpy, arrays), h, impl=impl)
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=2e-5)
    for i, s in enumerate(seq_lens):
        if s == 0:
            np.testing.assert_array_equal(to_np(out)[i], 0.0)


def test_zero_length_row_with_garbage_table_is_zero():
    """An inactive slot may carry an out-of-range page id: it is clamped,
    never read past the pool, and the row comes out zero, not NaN."""
    q, k, v, table, _ = _inputs(2, 4, 2, 16, 8, 2, [0, 5], seed=3)
    table[0] = [99, -7]
    lens = np.asarray([0, 5], np.int32)
    ref = jpaged(*map(jnp.asarray, (q, k, v, table, lens)), 4, impl="jnp")
    out = tpaged(*map(torch.from_numpy, (q, k, v, table, lens)), 4)
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(to_np(out)[0], 0.0)
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=2e-5)


def test_bf16_matches_jax():
    b, h, kv, d, page, m, seq_lens = CASES["ragged"]
    arrays = _inputs(b, h, kv, d, page, m, seq_lens, seed=5)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in arrays[:3]] + \
        [jnp.asarray(a) for a in arrays[3:]]
    targs = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:3]] + \
        [torch.from_numpy(a) for a in arrays[3:]]
    ref = jpaged(*jargs, h, impl="jnp")
    out = paged_attention_reference(*targs, h)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=2e-2)


def test_unknown_impl_rejected():
    arrays = _inputs(*CASES["mha"])
    with pytest.raises(ValueError, match="impl"):
        tpaged(*map(torch.from_numpy, arrays), 4, impl="pallas")
