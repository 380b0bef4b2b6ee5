"""The port's entry points (``open_gpu_kernel_modules_tpu_torch.entry``)
against the JAX package's root ``__graft_entry__.py``, on the CPU.

The dryruns run in child processes side by side, each with four native
device arenas (``TPUMEM_FAKE_TPU_COUNT=4``; the native device table is read
once per process, so never in the pytest process itself): the JAX child
runs ``__graft_entry__.dryrun_multichip(8)`` on an 8-device CPU mesh, the
port child ``entry.dryrun_multichip(8, device="cpu")``, which spawns eight
gloo ranks.  The counts of the native ICI segment that do not depend on
token values must be equal.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import torch

from open_gpu_kernel_modules_tpu_torch import entry
from open_gpu_kernel_modules_tpu_torch.models.convert import params_from_jax

from torch_port_util import to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 300
# bf16 through two layers, rounded at other places by XLA and PyTorch: a
# few bf16 ulps of the largest logit.
LOGITS_ATOL_FRAC = 0.02

_JAX_CHILD = r"""
import sys
sys.path.insert(0, %(repo)r)
import jax
jax.config.update("jax_platforms", "cpu")
import __graft_entry__
__graft_entry__.dryrun_multichip(8)
"""

_PORT_CHILD = r"""
import sys
sys.path.insert(0, %(repo)r)
from open_gpu_kernel_modules_tpu_torch import entry
out = entry.dryrun_multichip(8, device="cpu")
assert out["mesh"] == (2, 2, 2)
assert out["flash_launches"] == 0            # the CPU runs the plain version
assert all(r["ring_ulysses_err"] <= entry.RING_ULYSSES_ATOL
           for r in out["ranks"])
"""

_ICI_KEYS = ("fetches", "flushes", "bytes", "link_fail_detour_hops",
             "detour_bytes", "mb_scale_bytes", "mb_link_bytes")


def _ok_line(stdout):
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith("dryrun_multichip(n=8) ok: ")]
    assert len(lines) == 1, stdout
    return lines[0]


def _ici_counts(line):
    return {k: int(re.search(rf" {k}=(\d+)", line).group(1))
            for k in _ICI_KEYS}


def test_entry_matches_jax_entry():
    """Shapes and dtype of JAX ``entry()``'s forward, and its logits when
    the port's ``fn`` runs on JAX's parameters."""
    import __graft_entry__

    jfn, (jparams, jtokens) = __graft_entry__.entry()
    jout = jax.jit(jfn)(jparams, jtokens)
    fn, (params, tokens) = entry.entry(device="cpu")
    assert tuple(tokens.shape) == jtokens.shape
    out = fn(params, tokens)
    assert tuple(out.shape) == jout.shape == (2, 64, 512)
    assert out.dtype == torch.float32 and str(jout.dtype) == "float32"
    assert bool(torch.isfinite(out).all())
    for key in ("embed", "lm_head"):
        assert params[key].shape == jparams[key].shape
        assert params[key].dtype == torch.bfloat16
    carried = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    ours = to_np(fn(carried, torch.from_numpy(np.array(jtokens))))
    ref = to_np(jout)
    np.testing.assert_allclose(
        ours, ref, atol=LOGITS_ATOL_FRAC * float(np.abs(ref).max()))


def test_dryrun_multichip_matches_jax():
    env = dict(os.environ, TPUMEM_FAKE_TPU_COUNT="4", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    children = [subprocess.Popen(
        [sys.executable, "-c", code % {"repo": REPO}], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for code in (_JAX_CHILD, _PORT_CHILD)]
    outs = []
    try:
        for child in children:
            out, err = child.communicate(timeout=CHILD_TIMEOUT_S)
            assert child.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.communicate()
    jline, tline = (_ok_line(o) for o in outs)
    assert re.search(r"mesh=dp2xtp2xsp2 ring_attn=\(4, 32, 4, 16\) ", tline)
    assert re.search(r" loss=\d+\.\d{4} ", tline)
    assert _ici_counts(tline) == _ici_counts(jline)
    assert tline.endswith(jline[jline.index(" (= "):])
