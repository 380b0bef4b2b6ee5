"""p95 over every emission gap in the window of every request: the time
since the request's previous emission over the tokens emitted.  A
per-layer metric: over a 51-s window its spread from run to run is too
wide for an end-to-end bound."""
from portbench.harness import p95


def read(run):
    v = p95(run.itl_s())
    return None if v is None else 1e3 * v
