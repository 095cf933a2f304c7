"""The whole step: the program's FLOPs a step (`costs/flops.py`, each
dtype at its published peak) over the traced device time a step, in %."""

from portbench import readers


def read(run):
    t = readers.step_device_s(run)
    peak_s = run.work.get("peak_s_per_step")
    return None if not t or not peak_s else 100.0 * peak_s / t
