"""What the per-layer metric readers (`metrics/<name>.py`) share: the
traced calls on the profiler's clock, device-busy time, kernel launches
and times by name, and the denoiser or optimizer steps the trace holds
(one K1 launch each). A reader returns None where its trace holds
nothing to read."""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

K1 = re.compile(r"knn_select_kernel")
K2 = re.compile(r"pp_message_kernel")
K3 = re.compile(r"pp_message_bwd_kernel|(^|[\s:])count_kernel\b"
                r"|sum_slices_kernel")
K3_MAIN = re.compile(r"pp_message_bwd_kernel")


def calls(run) -> List[Tuple[float, float]]:
    """The traced calls' spans on the profiler's clock."""
    return run.trace.spans("call")[:len(run.traced)]


def window(run) -> Tuple[float, float]:
    spans = calls(run)
    return spans[0][0], spans[-1][1]


def busy(run) -> float:
    return run.trace.busy(*window(run))


def kernels(run, pattern) -> Tuple[int, float]:
    """(launches, seconds) of the device operations matching `pattern`
    in the traced window (counted once a pattern and trace)."""
    tr = run.trace
    hits = tr.__dict__.setdefault("_hits", {})
    if pattern not in hits:
        t0, t1 = window(run)
        hit = np.fromiter((bool(pattern.search(n)) for n in tr.names),
                          bool, len(tr.names))
        hit &= (tr.start >= t0) & (tr.end <= t1)
        hits[pattern] = (int(hit.sum()), float(tr.dur[hit].sum()))
    return hits[pattern]


def steps(run) -> int:
    """Denoiser calls (sampling) or optimizer steps (training) in the
    traced window: one K1 launch each."""
    return kernels(run, K1)[0]


def step_device_s(run) -> Optional[float]:
    n = steps(run)
    return busy(run) / n if n else None


def roofline(run, work_key: str, pattern, count_pattern=None
             ) -> Optional[float]:
    """The kernel's least time over its traced time, in %: the bound a
    launch (`run.work[work_key]`) times the launches, over their time."""
    bound = run.work.get(work_key)
    n, _ = kernels(run, count_pattern or pattern)
    _, t = kernels(run, pattern)
    if not bound or not n or t <= 0:
        return None
    return 100.0 * bound * n / t
