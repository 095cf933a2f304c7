"""Spans on the host clock and the device trace of a bounded window.

The benchmark records its own spans around its calls into the program
(`Spans.span`): each is kept in memory with its host times and, inside a
profiled window, also appears in the profiler's timeline as a
`bench.<name>` annotation, on the clock of the device events.
`profiler` traces a window with `torch.profiler`; `Trace` holds its device
operations (kernels, copies, memsets) and the annotations as arrays, read
from the profiler's raw events without building its Python event tree.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

class Spans:
    """Host spans (name, start s, end s, meta) on `time.perf_counter`."""

    def __init__(self):
        self.items: List[Tuple[str, float, float, dict]] = []

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield meta
        self.items.append((name, t0, time.perf_counter(), meta))

    def of(self, name: str) -> List[Tuple[float, float, dict]]:
        return [(a, b, m) for n, a, b, m in self.items if n == name]


def profiler(device):
    """A profiler of host ops and, on the card, device activity."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


class Trace:
    """Device operations and bench annotations of one profiled window,
    times in seconds on the profiler's clock."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        names, starts, durs = [], [], []
        self.annotations: List[Tuple[str, float, float]] = []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if name.startswith("bench."):
                # the host span (its copy on the device's timeline is not
                # device work)
                if e.device_type() != DeviceType.CUDA:
                    self.annotations.append((name[6:], e.start_ns() * 1e-9,
                                             e.end_ns() * 1e-9))
            elif e.device_type() == DeviceType.CUDA:
                names.append(name)
                starts.append(e.start_ns())
                durs.append(e.duration_ns())
        self.names = np.asarray(names, dtype=object)
        self.start = np.asarray(starts, dtype=np.float64) * 1e-9
        self.dur = np.asarray(durs, dtype=np.float64) * 1e-9
        self.end = self.start + self.dur

    @property
    def n_events(self) -> int:
        return len(self.names)

    def spans(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for n, a, b in self.annotations if n == name]

    def merged(self, t0: float = -np.inf, t1: float = np.inf
               ) -> Tuple[np.ndarray, np.ndarray]:
        """The union of device-busy intervals, clipped to [t0, t1]."""
        keep = (self.end > t0) & (self.start < t1)
        s = np.clip(self.start[keep], t0, t1)
        e = np.clip(self.end[keep], t0, t1)
        if not len(s):
            return s, e
        order = np.argsort(s, kind="stable")
        s, e = s[order], np.maximum.accumulate(e[order])
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > e[:-1]
        starts = s[new]
        ends = np.append(e[np.flatnonzero(new)[1:] - 1], e[-1])
        return starts, ends

    def busy(self, t0: float = -np.inf, t1: float = np.inf) -> float:
        s, e = self.merged(t0, t1)
        return float(np.sum(e - s))

    def top_ops(self, t0: float, t1: float, n: int = 10
                ) -> List[List[object]]:
        """The `n` device operations that took the most time in [t0, t1],
        summed by name."""
        keep = (self.start >= t0) & (self.end <= t1)
        totals: Dict[str, float] = {}
        for name, d in zip(self.names[keep], self.dur[keep]):
            totals[name] = totals.get(name, 0.0) + float(d)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[short(k), v] for k, v in top]

    def idle_gaps(self, t0: float, t1: float, n: int = 10
                  ) -> List[List[object]]:
        """The `n` longest stretches of [t0, t1] with no device operation,
        each named by the innermost bench span around its middle
        ("host" where none is)."""
        s, e = self.merged(t0, t1)
        edges_s = np.concatenate([[t0], e])
        edges_e = np.concatenate([s, [t1]])
        gaps = [(b - a, a, b) for a, b in zip(edges_s, edges_e) if b > a]
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            around = [(y - x, name) for name, x, y in self.annotations
                      if x <= mid <= y]
            out.append([min(around)[1] if around else "host", float(length)])
        return out


def short(name: str, n: int = 160) -> str:
    """A device operation's name, cut to `n` characters."""
    return name if len(name) <= n else name[:n - 3] + "..."

