"""Host ms of the wrapped ``serving.prefill_group`` (synchronised before and
after in the traced run) per 1000 prompt tokens, over the window."""


def read(run):
    p = run.probes
    if p is None or not p.prefill_tokens:
        return None
    return 1e3 * p.prefill_s / (p.prefill_tokens / 1e3)
