"""Share of the window the host spent in the tiered cache and its backing:
the wrapped ``TieredKVCache.activate``, ``sync_from``, ``flush_group``,
``release_sequence`` and ``ManagedKVBacking.read_pages`` (outermost calls
only, so nested ones count once), in percent."""


def read(run):
    p = run.probes
    if p is None:
        return None
    return 100.0 * p.tier_s / run.window_s
