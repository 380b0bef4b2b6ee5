"""p95 over every request whose first tokens came in the window, from its
client's submit to the end of the round that emitted them.  A per-layer
metric: over a 51-s window its spread from run to run is too wide for an
end-to-end bound."""
from portbench.harness import p95


def read(run):
    v = p95(run.ttft_s())
    return None if v is None else 1e3 * v
