"""UVM — the port's own bindings to the native tiered managed-memory engine.

Copies of the JAX package's ``uvm/`` modules, with the same names:
``managed`` (VA spaces, managed buffers, residency, policies, fault
statistics, PM suspend/resume, tenant quotas, tools event sessions),
``ce`` (the copy-engine pool), ``memring`` (async prefetch and evict rings
with dependencies), ``reset`` (device reset and generation), ``inject``
(fault-injection sites), ``journal`` (the black-box journal), ``hot``
(hotness stats and span coldness), ``shield`` (poison probe) and ``vac``
(chip evacuation).  The engine itself is native C (``native/``,
``libtpurm.so``), shared by both packages.
"""

from . import ce  # noqa: F401  (tpuce copy-engine stats surface)
from . import inject  # noqa: F401  (fault-injection sites)
from . import journal  # noqa: F401  (tpubox black-box journal + crash dumps)
from . import memring  # noqa: F401  (async memory-op rings, tpumemring)
from . import reset  # noqa: F401  (full-device reset + hung-op watchdog)
from .managed import (  # noqa: F401
    Compress,
    Tier,
    VaSpace,
    ManagedBuffer,
    ResidencyInfo,
    FaultStats,
    ToolsSession,
    Event,
    EventType,
    fault_stats,
    fault_stats_reset_windows,
    suspend,
    resume,
)
