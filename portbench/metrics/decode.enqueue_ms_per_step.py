"""Host ms of the wrapped ``serving.decode_scan`` per decode step, over the
window: the eager dispatch of a step (nothing synchronises inside it)."""


def read(run):
    p = run.probes
    if p is None or not p.decode_steps:
        return None
    return 1e3 * p.decode_s / p.decode_steps
