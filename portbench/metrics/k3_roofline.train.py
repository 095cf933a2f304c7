"""K3 (`csrc/pp_message_bwd.cu`: the backward, its valid-slot count and
its weight-gradient sum): its least time (`costs/k3.py`, fp32) over the
traced time of its three kernels, in %, per backward call."""

from portbench import readers


def read(run):
    return readers.roofline(run, "k3", readers.K3, readers.K3_MAIN)
