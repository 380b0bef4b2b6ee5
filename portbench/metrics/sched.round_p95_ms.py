"""p95 of the host clock around each ``Scheduler.step()`` ending in the
window (layer: the Scheduler, ``runtime/sched.py``)."""
from portbench.harness import p95


def read(run):
    v = p95(run.round_s())
    return None if v is None else 1e3 * v
