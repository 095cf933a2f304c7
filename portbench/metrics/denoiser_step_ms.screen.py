"""Denoiser (`models/dynamics.py`, `conv.py`, `gvp.py`, `edges.py`): the
device time of the traced calls over their reverse steps, in ms."""

from portbench import readers


def read(run):
    t = readers.step_device_s(run)
    return None if t is None else 1e3 * t
