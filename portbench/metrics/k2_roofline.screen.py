"""K2 (`csrc/pp_message.cu`) in sampling: its least time over its traced
time, in %, across its three layouts a step (`costs/k2.py` at each
layout's shapes and valid slots, at the compute dtype's peak)."""

from portbench import readers


def read(run):
    return readers.roofline(run, "k2", readers.K2)
