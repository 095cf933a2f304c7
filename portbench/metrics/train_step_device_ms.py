"""Train step (`train_state.multi_train_step`, `TrainGraphs`, `loss`,
Adam): the device time of the traced calls over their optimizer steps,
in ms."""

from portbench import readers


def read(run):
    t = readers.step_device_s(run)
    return None if t is None else 1e3 * t
