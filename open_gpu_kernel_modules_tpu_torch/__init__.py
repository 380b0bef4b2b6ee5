"""open_gpu_kernel_modules_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX one (``open_gpu_kernel_modules_tpu``),
which stays the reference every module here is tested against.  It imports
nothing from that package.  Layout mirrors it so each counterpart is easy
to find:

- ``models.llama``   — the Llama decoder (plain PyTorch, stacked [L, ...]
  layer tensors, a Python loop over layers);
- ``models.serving`` — the paged KV cache, prefill, greedy decode, and the
  oversubscribed tiered KV cache over the native UVM engine;
- ``models.convert`` — JAX parameter trees (as numpy) -> torch tensors;
- ``ops``            — hand-written CUDA kernels for Hopper (``ops/csrc``),
  each beside its plain PyTorch version;
- ``runtime.sched``  — the continuous-batching serving ``Scheduler`` over
  the tiered cache (admission, preemption and restore, device-reset
  recovery, tenant QoS, per-request flow and SLO accounting);
- ``models.multichip`` — the KV pool striped over several device arenas
  and moved over the engine's ICI model;
- ``runtime.hbm``    — ``HbmRuntime``, which mirrors the UVM engine's HBM
  tier onto the card (a drain thread, a copy stream, a page-locked shadow);
- ``uvm``, ``runtime``, ``utils`` — the port's own ctypes bindings to the
  native engine (``native/``, ``libtpurm.so``);
- ``parallel``       — the dp/tp/sp device mesh, Megatron shards with the
  tensor-parallel forward, ring and Ulysses attention, on
  ``torch.distributed``;
- ``entry``          — the single-card forward check, the SGD train step
  and the multichip dryrun (``python -m open_gpu_kernel_modules_tpu_torch.
  entry``).

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see ``device.resolve``).
"""

from . import device  # noqa: F401  (pins fp32 matmuls to full precision)

__version__ = "0.1.0"
