"""B1 (``ops/csrc/paged_decode.cu``): the least time its calls in the traced
stretch could take at 3.35 TB/s, counting the live K and V of every
sequence and q and the output once (``portbench.flops.b1_bytes``), over the
device time of its kernels in the trace, in percent."""
from portbench import flops


def read(run):
    tr = run.trace
    if tr is None or not run.b1_trace_bytes:
        return None
    t = tr.kernel_s("paged_decode")
    if t <= 0:
        return None
    return 100.0 * run.b1_trace_bytes / flops.HBM_BYTES_PER_S / t
