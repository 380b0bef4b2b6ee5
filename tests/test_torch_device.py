"""The port's device rules and package boundary, checked on the CPU:
``device=None`` means the CUDA card and raises without one; the port
imports no JAX; the kernels' wrappers validate before anything is built."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from open_gpu_kernel_modules_tpu_torch import device as tdevice
from open_gpu_kernel_modules_tpu_torch import entry
from open_gpu_kernel_modules_tpu_torch.models import llama, serving
from open_gpu_kernel_modules_tpu_torch.models.convert import params_from_jax
from open_gpu_kernel_modules_tpu_torch.ops import _build
from open_gpu_kernel_modules_tpu_torch.ops.flash_attention import _flash_cuda
from open_gpu_kernel_modules_tpu_torch.ops.paged_attention import _paged_cuda
from open_gpu_kernel_modules_tpu_torch.parallel import mesh as pmesh
from open_gpu_kernel_modules_tpu_torch.runtime import hbm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = llama.LlamaConfig.tiny()

ENTRY_POINTS = {
    "resolve": lambda: tdevice.resolve(None),
    "init_params": lambda: llama.init_params(TINY, torch.Generator()),
    "init_kv_cache": lambda: llama.init_kv_cache(TINY, 1),
    "causal_mask": lambda: llama.causal_mask(4, 4),
    "PagedKVCache.create": lambda: serving.PagedKVCache.create(TINY, 1, 16),
    "TieredKVCache": lambda: serving.TieredKVCache(TINY, 1, 16),
    "params_from_jax": lambda: params_from_jax({"w": np.zeros(2)}),
    "HbmRuntime": lambda: hbm.HbmRuntime(),
    "entry": lambda: entry.entry(),
    "dryrun_multichip": lambda: entry.dryrun_multichip(2),
    "run_ranks": lambda: pmesh.run_ranks(print, 2),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_without_cuda_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()


def test_explicit_cpu_device_works():
    gen = torch.Generator().manual_seed(0)
    params = llama.init_params(TINY, gen, device="cpu")
    assert params["layers"]["wq"].shape == (2, 64, 64)
    assert params["embed"].dtype == torch.bfloat16
    assert tdevice.resolve("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_port_imports_no_jax():
    """Neither JAX, nor the JAX package, nor ml_dtypes (JAX's bfloat16
    for numpy, absent where the card is) is imported by any port module,
    the native bindings included."""
    code = ("import sys\n"
            "import open_gpu_kernel_modules_tpu_torch.models.serving\n"
            "import open_gpu_kernel_modules_tpu_torch.models.convert\n"
            "import open_gpu_kernel_modules_tpu_torch.ops\n"
            "import open_gpu_kernel_modules_tpu_torch.runtime.native\n"
            "import open_gpu_kernel_modules_tpu_torch.uvm\n"
            "import open_gpu_kernel_modules_tpu_torch.uvm.managed\n"
            "import open_gpu_kernel_modules_tpu_torch.uvm.memring\n"
            "import open_gpu_kernel_modules_tpu_torch.uvm.reset\n"
            "import open_gpu_kernel_modules_tpu_torch.uvm.inject\n"
            "import open_gpu_kernel_modules_tpu_torch.uvm.journal\n"
            "import open_gpu_kernel_modules_tpu_torch.uvm.hot\n"
            "import open_gpu_kernel_modules_tpu_torch.uvm.shield\n"
            "import open_gpu_kernel_modules_tpu_torch.utils\n"
            "import open_gpu_kernel_modules_tpu_torch.runtime.sched\n"
            "import open_gpu_kernel_modules_tpu_torch.models.multichip\n"
            "import open_gpu_kernel_modules_tpu_torch.runtime.ici\n"
            "import open_gpu_kernel_modules_tpu_torch.runtime.tpusplit\n"
            "import open_gpu_kernel_modules_tpu_torch.uvm.vac\n"
            "import open_gpu_kernel_modules_tpu_torch.uvm.ce\n"
            "import open_gpu_kernel_modules_tpu_torch.runtime.hbm\n"
            "import open_gpu_kernel_modules_tpu_torch.parallel\n"
            "import open_gpu_kernel_modules_tpu_torch.parallel.mesh\n"
            "import open_gpu_kernel_modules_tpu_torch.parallel.ring_attention\n"
            "import open_gpu_kernel_modules_tpu_torch.parallel.ulysses\n"
            "import open_gpu_kernel_modules_tpu_torch.entry\n"
            "from open_gpu_kernel_modules_tpu_torch import uvm, utils\n"
            "from open_gpu_kernel_modules_tpu_torch.runtime import native\n"
            "uvm.fault_stats_reset_windows(); uvm.ce.channels()\n"
            "utils.trace_quantile_ns('fault.latency', 0.99)\n"
            "native.RmClient().close()\n"
            "bad = [m for m in sys.modules if m in ('jax', 'ml_dtypes') or "
            "m.startswith(('jax.', 'ml_dtypes.', "
            "'open_gpu_kernel_modules_tpu.')) or "
            "m == 'open_gpu_kernel_modules_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_library_name_follows_source_hash():
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert (_build.CSRC / f"{name}.cu").exists()


def test_cuda_wrappers_reject_cpu_tensors_before_building():
    q = torch.zeros((1, 4, 16))
    pages = torch.zeros((2, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        _paged_cuda(q, pages, pages, torch.zeros((1, 2), dtype=torch.int32),
                    torch.ones((1,), dtype=torch.int32), 4)
    x = torch.zeros((1, 8, 2, 64))
    for impl in ("grid", "rows"):
        with pytest.raises(ValueError, match="CUDA"):
            _flash_cuda(x, x, x, True, True, "bshd", impl)
