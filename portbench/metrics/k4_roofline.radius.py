"""K4 (`csrc/gvp_chain.cu`) on the radius graph: its least time over its
traced time, in %. The least time of a launch is the larger of its bytes
at 3.35 TB/s and its operations at the dtype's peak (`costs/k4.py` at
each launch's chain and rows in the eager work step, whose count the
program's `gvp_chain.launches` confirms); the traced window's launches
are whole steps of the same chains."""

import re

from portbench import readers

K4 = re.compile(r"gvp_chain_kernel")


def read(run):
    return readers.roofline(run, "k4", K4)
