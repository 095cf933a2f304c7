"""The device: the share of the traced window with no kernel, copy or
memset running, in %."""

from portbench import readers


def read(run):
    if not readers.steps(run):
        return None
    t0, t1 = readers.window(run)
    return 100.0 * (1.0 - readers.busy(run) / (t1 - t0))
