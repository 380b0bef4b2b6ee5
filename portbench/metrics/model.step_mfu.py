"""Model operations of the prompts and output tokens done in the window,
from the configuration's shapes (``portbench.flops``), over the window's
seconds times the card's bf16 peak, in percent."""
from portbench import flops


def read(run):
    f = run.window_flops()
    if not f:
        return None
    return 100.0 * f / (run.window_s * flops.PEAK_BF16_FLOPS)
