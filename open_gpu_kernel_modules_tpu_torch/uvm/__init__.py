"""UVM — the port's own bindings to the native tiered managed-memory engine.

Copies of the parts of the JAX package's ``uvm/`` that the tiered KV cache
and the scheduler reach, with the same names: ``managed`` (VA spaces,
managed buffers, residency, fault statistics, tenant quotas), ``memring``
(async prefetch and evict rings with dependencies), ``reset`` (device
reset and generation), ``inject`` (fault-injection sites), ``journal``
(record emit), ``hot`` (span coldness) and ``shield`` (poison probe).  The
engine itself is native C (``native/``, ``libtpurm.so``), shared by both
packages.
"""

from . import memring  # noqa: F401
from . import reset  # noqa: F401
from .managed import (  # noqa: F401
    Tier,
    VaSpace,
    ManagedBuffer,
    ResidencyInfo,
    FaultStats,
    fault_stats,
)
