"""The port's flash attention (its plain version, which a CPU tensor runs)
against the JAX package's Pallas kernels in interpret mode with 32-wide
blocks, so the JAX side crosses several blocks, a diagonal and a padded
tail: the grid kernel (``impl="grid"``) and the row-resident one
(``impl="rows"``), each against the port called with the same ``impl``.
fp32 tolerance 2e-5, as the JAX package's own flash tests use."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_gpu_kernel_modules_tpu.ops import flash_attention as jflash
from open_gpu_kernel_modules_tpu_torch.ops import flash_attention as tflash
from open_gpu_kernel_modules_tpu_torch.ops.flash_attention import _padded_dim

from torch_port_util import normal, to_np

CASES = {
    # b, s, h, d, causal, layout, prescale_q
    "causal": (2, 96, 2, 32, True, "bshd", True),
    "full": (2, 96, 2, 32, False, "bshd", True),
    "odd_length": (1, 45, 2, 16, True, "bshd", True),
    "odd_length_full": (1, 45, 2, 16, False, "bshd", True),
    "bhsd": (2, 96, 2, 32, True, "bhsd", True),
    "no_prescale": (2, 64, 2, 32, True, "bshd", False),
}


def _qkv(b, s, h, d, layout, seed=0, dtype=np.float32):
    shape = (b, h, s, d) if layout == "bhsd" else (b, s, h, d)
    return [normal(seed + i, shape, dtype) for i in range(3)]


@pytest.mark.parametrize("impl", ["grid", "rows"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case, impl):
    b, s, h, d, causal, layout, prescale = CASES[case]
    q, k, v = _qkv(b, s, h, d, layout)
    ref = jflash(*map(jnp.asarray, (q, k, v)), causal=causal, blk_q=32,
                 blk_k=32, prescale_q=prescale, impl=impl, layout=layout)
    out = tflash(*map(torch.from_numpy, (q, k, v)), causal=causal,
                 prescale_q=prescale, impl=impl, layout=layout)
    assert out.shape == q.shape
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=2e-5)


@pytest.mark.parametrize("impl", ["grid", "rows"])
def test_bf16_matches_jax(impl):
    """bf16: both round the pre-scaled Q and P to bf16; the tolerance is
    the JAX package's own for its bf16 flash test."""
    q, k, v = _qkv(1, 64, 2, 32, "bshd", seed=4)
    ref = jflash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                 causal=True, blk_q=32, blk_k=32, impl=impl)
    out = tflash(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                 causal=True, impl=impl)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=3e-2)


def test_unknown_impl_rejected():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 1, 16, "bshd"))
    with pytest.raises(ValueError, match="impl"):
        tflash(q, k, v, impl="pallas")
    for impl in ("grid", "rows"):
        torch.testing.assert_close(tflash(q, k, v, impl=impl),
                                   tflash(q, k, v, impl="auto"))


@pytest.mark.parametrize("d,width", [(8, 64), (16, 64), (32, 64), (64, 64),
                                     (72, 128), (96, 128), (128, 128),
                                     (12, None), (100, None), (136, None),
                                     (256, None)])
def test_cuda_head_dim_padding(d, width):
    """The kernels run at head_dim 64 or 128: a multiple of 8 below 128 is
    zero-padded up to the next of them; any other head_dim raises, naming
    the widths taken."""
    if width is None:
        with pytest.raises(ValueError, match="the kernels take 64 and 128"):
            _padded_dim(d)
    else:
        assert _padded_dim(d) == width
