"""Parallelism on ``torch.distributed``: the dp/tp/sp device mesh, Megatron
parameter shards with the tensor-parallel forward written out, ring
attention and Ulysses attention (port of the JAX ``parallel/``).

Each rank is a process of one process group (``mesh.run_ranks`` starts
them); every function here runs in a rank.
"""

from .mesh import (  # noqa: F401
    make_mesh,
    llama_param_specs,
    shard_params,
    data_sharding,
)
from .ring_attention import ring_attention, ring_attention_sharded  # noqa: F401
from .ulysses import ulysses_attention, ulysses_attention_sharded  # noqa: F401
