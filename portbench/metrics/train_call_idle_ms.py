"""Train runner and step (`Trainer.train_call`, `multi_train_step`,
`TrainGraphs`): the device-idle time inside the program's span
`pf.trainer.call` outside its `pf.train.replay` and `pf.train.fetch`,
in ms, the mean over the traced calls: the call boundary's host phases
(stack, the graphs' lookup, load) and what lies between them. The
replay's and fetch's idle is left out, since the device waits there
under the profiler and hardly at all untraced; the phase table on stderr
still shows it.

Prints on stderr the call's phases (stack, graphs, load, replay, fetch)
with their host and idle time, and the window's longest idle gaps named
by the innermost span, the program's included."""

from portbench import program_spans as ps


def read(run):
    value = ps.mean_idle_ms(run, ("trainer.call",), ps.TRAIN_TRACED_ONLY)
    if value is None:
        return None
    ps.say("traced train call by phase:")
    for line in ps.phase_table(run, ("trainer.call", *ps.TRAIN_PHASES,
                                     "loader.wait")):
        ps.say(line)
    ps.report_gaps(run)
    return value
