"""The whole step on the radius graph: a step's FLOPs at each dtype's
published peak over the traced device time a step, in %. The FLOPs are
`costs/flops.py`'s count of the eager work step (matrix products by
operand dtype, K2 by its count function) plus K4's chains (`costs/k4.py`),
which run outside PyTorch's dispatch. A traced call is one chain of
`n_timesteps` steps (no K1 launch marks them on the radius graph)."""

from portbench import readers


def read(run):
    steps = len(run.traced) * run.cell.config["model"]["n_timesteps"]
    peak_s = run.work.get("peak_s_per_step")
    k4_s = run.work.get("k4_peak_s_per_step")
    t = readers.busy(run) / steps if steps else 0.0
    if not t or not peak_s or not k4_s:
        return None
    return 100.0 * (peak_s + k4_s) / t
