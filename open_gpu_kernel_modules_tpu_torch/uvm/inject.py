"""Fault injection sites and recovery counters of the native engine
(native/src/inject.c).

The port's copy of the JAX package's ``uvm/inject.py``: seed the sites'
PRNG, arm a named site (one-shot, every Nth, or parts-per-million, each hit
failing ``burst`` evaluations in a row, optionally only on evaluations that
carry one object key, its ``scope``), queue scoped one-shots beside a site's
mode, evaluate a site the way an engine check does (the scheduler's
``sched.admit`` gate, vac's ``vac.migrate``), disarm, re-read the
``TPUMEM_INJECT_*`` environment, and read back (evaluations, hits) per site
and the recovery counters the hardened engine paths bump while they absorb
the faults.  Site state is process-wide in the native library.
"""

from __future__ import annotations

import ctypes
import enum
from typing import Dict, Tuple

from ..runtime import native


class Site(enum.IntEnum):
    """Injection sites (inject.h TpuInjectSite)."""

    PMM_ALLOC = 0        # PMM chunk allocation (HBM/CXL backing)
    MIGRATE_COPY = 1     # block migration copy pass
    MSGQ_PUBLISH = 2     # msgq submit (mirror / RC shadow / GPFIFO)
    ICI_LINK = 3         # ICI link flap / retrain failure
    RDMA_COMPLETION = 4  # MR pin/map completion error
    CHANNEL_CE = 5       # channel CE push fault
    FENCE_TIMEOUT = 6    # fault-service / fence timeout
    MEMRING_SUBMIT = 7   # memring op execution (per coalesced run)
    CE_COPY = 8          # tpuce stripe submission (per attempt)
    SCHED_ADMIT = 9      # scheduler admission decision (per pass)
    RESET_DEVICE = 10    # forced full-device reset (per watchdog tick)
    VAC_MIGRATE = 11     # record shipping (per copy attempt)
    HOT_DECIDE = 12      # hotness policy decision (degrade-to-no-op)
    MEM_CORRUPT = 13     # bit flip in a sealed page / wire buffer
    DUMP_WRITE = 14      # crash-bundle serialization (per section; exact
                         # invariant: hits == journal_dump_errors)


class Mode(enum.IntEnum):
    OFF = 0
    ONESHOT = 1
    NTH = 2              # arg = N: every Nth evaluation
    PPM = 3              # arg = parts-per-million probability


#: Every hardened recovery action the engine can take, each counted where it
#: happens.
RECOVERY_COUNTERS = (
    "recover_retries",           # bounded retries (copy/fault/msgq/...)
    "recover_tier_fallbacks",    # HBM/CXL -> HOST placement fallback
    "recover_page_quarantines",  # fatally-faulting page retired
    "recover_rc_resets",         # channel RC reset-and-replay
    "recover_link_retrains",     # ICI link retrained after a flap
)

#: The per-subsystem breakdown of recovery and diagnostics.
DETAIL_COUNTERS = (
    "recover_copy_retries",
    "recover_fault_retries",
    "recover_msgq_retries",
    "recover_rdma_retries",
    "ici_link_flaps",
    "ici_degraded_routes",
    "ici_retrain_failures",
    "uvm_fault_cancels",
    "rc_nonreplayable_faults",
    "memring_retries",
    "memring_inject_retries",
    "memring_inject_error_runs",
    "memring_inject_error_cqes",
    "memring_error_cqes",
    "tpuce_retries",
    "tpuce_stripe_errors",
    "tpuce_inject_retries",
    "tpuce_inject_errors",
    "tpuce_lossless_fallbacks",
    "tpusched_admit_retries",
    "tpusched_admit_sheds",
    "tpurm_reset_total",
    "tpurm_reset_injected",
    "tpurm_watchdog_nudges",
    "tpurm_watchdog_rc_resets",
    "tpurm_watchdog_device_resets",
    "tpurm_watchdog_evacuations",
    "vac_inject_retries",
    "vac_inject_aborts",
    "vac_commits",
    "vac_aborts",
    "memring_stale_completions",
    "memring_deadline_expired",
    "tpuce_stale_completions",
    "tpuce_deadline_expired",
    "broker_client_deaths",
    "broker_reclaimed_pins",
    "hot_inject_skips",
    "tpurm_hot_pins",
    "tpurm_hot_throttles",
    "journal_dumps",
    "journal_dump_errors",
    "journal_dump_io_errors",
    "journal_log_mirrors",
)

_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is not None:
        return _bound
    lib = native.load()
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    lib.tpurmInjectSetSeed.argtypes = [u64]
    lib.tpurmInjectSetSeed.restype = None
    lib.tpurmInjectConfigure.argtypes = [u32, u32, u64, u32, u64]
    lib.tpurmInjectConfigure.restype = u32
    lib.tpurmInjectArmOneShot.argtypes = [u32, u64]
    lib.tpurmInjectArmOneShot.restype = u32
    lib.tpurmInjectDisable.argtypes = [u32]
    lib.tpurmInjectDisable.restype = None
    lib.tpurmInjectDisableAll.argtypes = []
    lib.tpurmInjectDisableAll.restype = None
    lib.tpurmInjectReloadEnv.argtypes = []
    lib.tpurmInjectReloadEnv.restype = None
    lib.tpurmInjectCounts.argtypes = [u32, ctypes.POINTER(u64),
                                      ctypes.POINTER(u64)]
    lib.tpurmInjectCounts.restype = None
    lib.tpurmInjectSiteName.argtypes = [u32]
    lib.tpurmInjectSiteName.restype = ctypes.c_char_p
    lib.tpurmInjectShouldFail.argtypes = [u32]
    lib.tpurmInjectShouldFail.restype = ctypes.c_bool
    lib.tpurmInjectShouldFailScoped.argtypes = [u32, u64]
    lib.tpurmInjectShouldFailScoped.restype = ctypes.c_bool
    _bound = lib
    return lib


def _check(status: int, what: str) -> None:
    if status != 0:
        raise native.RmError(status, what)


def should_fail(site: Site, scope: int = 0) -> bool:
    """Evaluate a site the way an engine check does (one native call; the
    disarmed fast path stays intact).  A nonzero ``scope`` is the object key
    the evaluation carries."""
    lib = _lib()
    if scope:
        return bool(lib.tpurmInjectShouldFailScoped(int(site), scope))
    return bool(lib.tpurmInjectShouldFail(int(site)))


def set_seed(seed: int) -> None:
    """Reseed every site's PRNG (same seed, same hit sequence)."""
    _lib().tpurmInjectSetSeed(seed)


def enable(site: Site, mode: Mode, arg: int = 0, burst: int = 1,
           scope: int = 0) -> None:
    """Arm a site.  ``burst`` makes each hit fail that many consecutive
    evaluations; a nonzero ``scope`` restricts hits to evaluations that
    carry that object key."""
    _check(_lib().tpurmInjectConfigure(int(site), int(mode), arg, burst,
                                       scope), "tpurmInjectConfigure")


def arm_oneshot(site: Site, scope: int = 0) -> None:
    """Queue one (scoped) one-shot without disturbing the site's mode;
    RmError when the site's one-shot slots are full."""
    _check(_lib().tpurmInjectArmOneShot(int(site), scope),
           "tpurmInjectArmOneShot")


def disable(site: Site) -> None:
    _lib().tpurmInjectDisable(int(site))


def disable_all() -> None:
    _lib().tpurmInjectDisableAll()


def reload_env() -> None:
    """Re-parse TPUMEM_INJECT_SEED and TPUMEM_INJECT_<SITE> from the
    environment."""
    _lib().tpurmInjectReloadEnv()


def site_name(site: Site) -> str:
    """The site's canonical name (``mem.corrupt``, ``dump.write``, ...)."""
    return _lib().tpurmInjectSiteName(int(site)).decode()


def counts(site: Site) -> Tuple[int, int]:
    """(evaluations, hits) for a site since process start."""
    evals, hits = ctypes.c_uint64(), ctypes.c_uint64()
    _lib().tpurmInjectCounts(int(site), ctypes.byref(evals),
                             ctypes.byref(hits))
    return evals.value, hits.value


def stats() -> Dict[str, Tuple[int, int]]:
    """(evaluations, hits) of every site, keyed by its canonical name."""
    return {site_name(s): counts(s) for s in Site}


def recovery_counters(detail: bool = False) -> Dict[str, int]:
    """The RECOVERY_COUNTERS (0 for one never bumped); ``detail=True`` adds
    the DETAIL_COUNTERS."""
    lib = _lib()
    names = RECOVERY_COUNTERS + (DETAIL_COUNTERS if detail else ())
    return {n: lib.tpurmCounterGet(n.encode()) for n in names}
