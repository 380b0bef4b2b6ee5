"""CUDA kernels for Hopper, each beside its plain PyTorch version.

- flash_attention — blockwise online-softmax attention (the prefill forward):
  the grid kernel and the row-resident one (``impl="rows"``)
- paged_attention — block-paged decode attention (every decode step)
"""

from .flash_attention import flash_attention  # noqa: F401
from .paged_attention import paged_attention  # noqa: F401
