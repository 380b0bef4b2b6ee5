"""Model families served by the port (Llama; dense and tiered serving)."""

from .llama import (
    LlamaConfig,
    init_params,
    forward,
    forward_with_cache,
    init_kv_cache,
    loss_fn,
)

__all__ = [
    "LlamaConfig",
    "init_params",
    "forward",
    "forward_with_cache",
    "init_kv_cache",
    "loss_fn",
]
