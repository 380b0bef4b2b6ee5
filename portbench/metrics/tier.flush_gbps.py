"""GB/s of the tier's flushes over the run: the bytes every
``TieredKVCache.flush_group`` wrote back into managed memory over the host
ns its write-back took, the port's ``tputier_flush_bytes`` and
``tputier_flush_ns`` counters, which count every call of the process
(set-up, window and traced stretch).  Nothing where the port keeps no such
counters."""


def read(run):
    from open_gpu_kernel_modules_tpu_torch import utils
    nbytes = utils.counter("tputier_flush_bytes")
    ns = utils.counter("tputier_flush_ns")
    return nbytes / ns if nbytes and ns else None
