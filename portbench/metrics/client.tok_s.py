"""Output tokens emitted in the window over the window's seconds, read in
the traced run, whose wrappers it carries.  The cell is paced by the host,
so this rate follows the speed of the host's cores from run to run."""


def read(run):
    return run.emitted() / run.window_s
