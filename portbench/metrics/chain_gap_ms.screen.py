"""Denoiser (the replayed graphs of `ChainGraphs`, the chain's result and
its copy to the host): the device-idle time inside the program's span
`pf.chain.run`, which lies between the kernels of the replayed graphs,
in ms, the mean over the traced calls.

Most of it exists only under the profiler: there the device waits
inside `pf.chain.replay` while the host enqueues the 1,000 replays, and
a traced call runs longer than its device time by about this idle, where
an untraced call takes less than that device time. So a change that
alters only how the replays meet the profiler can lower it with no gain
untraced."""

from portbench import program_spans as ps


def read(run):
    return ps.mean_idle_ms(run, (ps.CHAIN_RUN,))
