"""Training on the port against the JAX package, on the CPU at fp32: the
next-token loss and its gradient (plain autograd through ``forward``, JAX's
``value_and_grad``), and one SGD step as the dryrun takes it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_gpu_kernel_modules_tpu.models import llama as jllama
from open_gpu_kernel_modules_tpu_torch import entry
from open_gpu_kernel_modules_tpu_torch.models import llama as tllama

from torch_port_util import tiny_pair, to_np, tokens

# Loss: fp32 sums of 97-way softmaxes in another order (rtol); gradients:
# fp32 through two layers, entries of order 1e-2..1 (atol).
LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    jcfg, jparams, tcfg, tparams = tiny_pair(vocab_size=97, max_seq_len=32)
    toks = tokens(4, (2, 8), jcfg.vocab_size)
    targets = np.roll(toks, -1, axis=1)
    return jcfg, jparams, tcfg, tparams, toks, targets


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _with_grad(tparams):
    return {k: _with_grad(v) if isinstance(v, dict)
            else v.clone().requires_grad_(True) for k, v in tparams.items()}


def _jax_loss_and_grads(pair):
    jcfg, jparams, _, _, toks, targets = pair
    return jax.value_and_grad(lambda p: jllama.loss_fn(
        jcfg, p, jnp.asarray(toks), jnp.asarray(targets)))(jparams)


def test_loss_and_grads_match_jax(pair):
    _, _, tcfg, tparams, toks, targets = pair
    jloss, jgrads = _jax_loss_and_grads(pair)
    params = _with_grad(tparams)
    loss = tllama.loss_fn(tcfg, params, torch.from_numpy(toks),
                          torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    names = [name for name, _ in _leaves(params)]
    assert len(names) == 12
    for name in names:
        g = _get(params, name).grad
        assert g is not None, f"{name}: no gradient reached the leaf"
        assert float(g.abs().sum()) > 0, f"{name}: zero gradient"
        np.testing.assert_allclose(to_np(g), to_np(_get(jgrads, name)),
                                   atol=GRAD_ATOL, err_msg=name)


def test_sgd_step_matches_jax(pair):
    """One SGD step, (p.float() - lr*g).to(p.dtype) as the dryrun's
    train_step, on one rank of a 1x1x1 mesh (no collective runs)."""
    jcfg, jparams, tcfg, tparams, toks, targets = pair
    jloss, jgrads = _jax_loss_and_grads(pair)
    jnew = jax.tree_util.tree_map(
        lambda p, g: (p.astype(jnp.float32) - 1e-3 * g).astype(p.dtype),
        jparams, jgrads)
    loss, new, _ = entry.sgd_step(tcfg, tparams, torch.from_numpy(toks),
                                  torch.from_numpy(targets), mesh=None)
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    for name, p in _leaves(new):
        assert not p.requires_grad
        np.testing.assert_allclose(to_np(p), to_np(_get(jnew, name)),
                                   atol=1e-7, err_msg=name)
    # The step leaves its input parameters as they were.
    for name, p in _leaves(tparams):
        np.testing.assert_array_equal(to_np(p), to_np(_get(jparams, name)))


def test_autograd_loss_equals_no_grad_loss(pair):
    _, _, tcfg, tparams, toks, targets = pair
    t, tt = torch.from_numpy(toks), torch.from_numpy(targets)
    with torch.no_grad():
        plain = tllama.loss_fn(tcfg, tparams, t, tt)
    params = _with_grad(tparams)
    graded = tllama.loss_fn(tcfg, params, t, tt)
    assert graded.requires_grad and not plain.requires_grad
    assert graded.item() == plain.item()
