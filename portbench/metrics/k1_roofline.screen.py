"""K1 (`csrc/knn_select.cu`): its least time (`costs/k1.py` at the
call's shapes, bytes at 3.35 TB/s or operations at the fp32 peak) over
its traced time, in %."""

from portbench import readers


def read(run):
    return readers.roofline(run, "k1", readers.K1)
