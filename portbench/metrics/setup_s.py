"""Process start to the window's start: build, weights, the Scheduler's
slot pool and backing, warm-up."""


def read(run):
    return run.setup_s
