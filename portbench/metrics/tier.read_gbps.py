"""GB/s of the tier's reads over the run: the bytes every
``ManagedKVBacking.read_pages`` handed up over the host ns spent in it, the
port's ``tputier_read_bytes`` and ``tputier_read_ns`` counters, which
count every call of the process (set-up, window and traced stretch).
Nothing where the port keeps no such counters."""


def read(run):
    from open_gpu_kernel_modules_tpu_torch import utils
    nbytes = utils.counter("tputier_read_bytes")
    ns = utils.counter("tputier_read_ns")
    return nbytes / ns if nbytes and ns else None
