"""Chain runner (`PocketSampler.sample_stacked`, `ChainGraphs`): the host
wall of a traced call beyond the device time inside it, in ms, the mean
over the traced calls."""

from portbench import readers


def read(run):
    got = [(b - a) - run.trace.busy(a, b) for a, b in readers.calls(run)]
    return 1e3 * sum(got) / len(got) if got else None
