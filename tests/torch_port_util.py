"""Shared set-up for the port's tests (tests/test_torch_*.py).

The JAX package is the reference: parameters come from its ``init_params``
on ``LlamaConfig.tiny`` at float32, and reach the port through numpy and
``params_from_jax``.  Inputs come from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from open_gpu_kernel_modules_tpu.models import llama as jllama
from open_gpu_kernel_modules_tpu_torch.models import llama as tllama
from open_gpu_kernel_modules_tpu_torch.models.convert import params_from_jax


def tiny_pair(vocab_size=256, max_seq_len=128, seed=0, **overrides):
    """(jax cfg, jax params, torch cfg, torch params) for tiny at fp32;
    ``overrides`` replace fields of both configs."""
    jcfg = jllama.LlamaConfig.tiny(vocab_size=vocab_size,
                                   max_seq_len=max_seq_len)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32, **overrides)
    jparams = jllama.init_params(jcfg, jax.random.key(seed))
    tcfg = dataclasses.replace(
        tllama.LlamaConfig.tiny(vocab_size=vocab_size,
                                max_seq_len=max_seq_len),
        dtype=torch.float32, **overrides)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def normal(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def to_np(x):
    """A torch tensor or JAX array as an fp32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))
