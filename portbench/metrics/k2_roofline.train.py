"""K2 (`csrc/pp_message.cu`) in training: its least time over its traced
time, in %, at each traced batch's pp edges (`costs/k2.py`, fp32)."""

from portbench import readers


def read(run):
    return readers.roofline(run, "k2", readers.K2)
