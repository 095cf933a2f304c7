"""The program's own spans and its loader ring
(`pharmaforge_tpu_torch/utils/trace.py`), for the per-layer readers.

While the profiler records, each span of the program enters a `pf.<name>`
annotation and also keeps its host times (`time.perf_counter_ns`) in the
program's ring. `trace.Trace` keeps only the benchmark's `bench.`
annotations, so these readers take the spans from the ring and place them
on the profiler's clock by the benchmark's `call` spans, which both
clocks hold: a traced call's start and end on `time.perf_counter`
(`run.spans`) and on the profiler's clock (`run.trace`) fix a linear map
for the spans inside it.

Against a program without the ring (an earlier commit) `ring()` is None
and every reader returns None.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

Interval = Tuple[float, float]

# the phases of a sampler call outside the chain's replays and fetch: their
# idle is the sampler's host work (`sampler_idle_ms.screen`)
SAMPLER_PHASES = ("sampler.tile", "sampler.probe", "chain.setup",
                  "chain.graphs", "sampler.split")
# the phase whose idle lies between the replayed graphs' kernels
# (`chain_gap_ms.screen`)
CHAIN_RUN = "chain.run"
TRAIN_PHASES = ("trainer.stack", "train.graphs", "train.capture",
                "train.load", "train.replay", "train.eager", "train.fetch")
# the phases of a train call left out of `train_call_idle_ms`: under the
# profiler the device waits inside them, untraced it hardly does
TRAIN_TRACED_ONLY = ("train.replay", "train.fetch")


def ring():
    """The program's ring, or None where the program has none."""
    try:
        from pharmaforge_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.records()


def traced_calls(run) -> List[Tuple[Interval, Interval]]:
    """Each traced call's (host span on perf_counter s, span on the
    profiler's clock s)."""
    host = [(a, b) for a, b, _ in run.spans.of("call")]
    prof = run.trace.spans("call")
    n = len(run.traced)
    return list(zip(host[:n], prof[:n]))


def call_spans(run) -> Optional[List[Dict[str, List[Interval]]]]:
    """For each traced call, the program's spans inside it, by name, on
    the profiler's clock (clipped to the call); None without the ring or
    where no traced call holds a span."""
    records = ring()
    if records is None or run.trace is None:
        return None
    out, found = [], False
    for (h0, h1), (p0, p1) in traced_calls(run):
        scale = (p1 - p0) / (h1 - h0) if h1 > h0 else 1.0
        got: Dict[str, List[Interval]] = {}
        for r in records:
            if r.seq is not None:
                continue
            a, b = r.start_ns * 1e-9, r.end_ns * 1e-9
            if a < h0 or b > h1:
                continue
            a = min(max(p0 + (a - h0) * scale, p0), p1)
            b = min(max(p0 + (b - h0) * scale, p0), p1)
            got.setdefault(r.name, []).append((a, b))
            found = True
        out.append(got)
    return out if found else None


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering `intervals`."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def complement(intervals: Sequence[Interval], t0: float,
               t1: float) -> List[Interval]:
    """[t0, t1] less the union of `intervals`."""
    out, at = [], t0
    for a, b in union(intervals):
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


def idle(trace, intervals: Iterable[Interval]) -> float:
    """Device-idle seconds inside the union of `intervals`."""
    return sum((b - a) - trace.busy(a, b) for a, b in union(intervals))


def mean_idle_ms(run, names: Sequence[str],
                 less: Sequence[str] = ()) -> Optional[float]:
    """Device-idle ms inside the union of the spans `names` less that of
    the spans `less`, the mean over the traced calls; None where no traced
    call holds one of `names`."""
    calls = call_spans(run)
    if calls is None:
        return None
    got = []
    for spans in calls:
        if not any(n in spans for n in names):
            continue
        cut = [iv for n in less for iv in spans.get(n, [])]
        got.append(idle(run.trace, [
            part for a, b in union(iv for n in names
                                   for iv in spans.get(n, []))
            for part in complement(cut, a, b)]))
    return 1e3 * sum(got) / len(got) if got else None


def ops_inside(trace, intervals: Sequence[Interval]) -> int:
    """Device operations that start inside the union of `intervals`."""
    return int(sum(np.count_nonzero((trace.start >= a) & (trace.start < b))
                   for a, b in union(intervals)))


def phase_table(run, names: Sequence[str]) -> List[str]:
    """Lines: for each span name, its host ms, device-idle ms and device
    operations, the mean over the traced calls that hold it."""
    calls = call_spans(run) or []
    lines = []
    for name in names:
        rows = [spans[name] for spans in calls if name in spans]
        if not rows:
            continue
        host = np.mean([sum(b - a for a, b in r) for r in rows])
        gap = np.mean([idle(run.trace, r) for r in rows])
        ops = np.mean([ops_inside(run.trace, r) for r in rows])
        lines.append(f"  pf.{name}: host {1e3 * host:.3f} ms, device idle "
                     f"{1e3 * gap:.3f} ms, {ops:.0f} device operations "
                     f"(mean of {len(rows)} calls)")
    return lines


def remainder_ms(run) -> Optional[Tuple[float, float, float]]:
    """The device-idle ms of the traced calls that falls outside every
    span of `SAMPLER_PHASES` and `CHAIN_RUN`, the mean over the calls:
    (all of it, the part outside the program's root spans, the part
    inside them); None without spans."""
    calls = call_spans(run)
    if calls is None:
        return None
    total, outside, inside = [], [], []
    for (_, (p0, p1)), spans in zip(traced_calls(run), calls):
        named = [iv for n in (*SAMPLER_PHASES, CHAIN_RUN)
                 for iv in spans.get(n, [])]
        rest = complement(named, p0, p1)
        roots = spans.get("sampler.call", [])
        total.append(idle(run.trace, rest))
        outside.append(idle(run.trace, complement(roots, p0, p1)))
        inside.append(total[-1] - outside[-1])
    return tuple(1e3 * float(np.mean(v)) for v in (total, outside, inside))


def named_gaps(run, n: int = 10) -> List[Tuple[str, float]]:
    """The `n` longest device-idle gaps of the traced window, each named
    by the innermost span around its middle: the program's `pf.` spans
    and the benchmark's own, as `trace.Trace.idle_gaps` names them by the
    benchmark's alone."""
    calls = call_spans(run) or []
    pf = [(f"pf.{name}", a, b) for spans in calls
          for name, ivs in spans.items() for a, b in ivs]
    spans = pf + list(run.trace.annotations)
    t0, t1 = traced_calls(run)[0][1][0], traced_calls(run)[-1][1][1]
    s, e = run.trace.merged(t0, t1)
    gaps = [(b - a, a, b) for a, b in zip(np.concatenate([[t0], e]),
                                          np.concatenate([s, [t1]])) if b > a]
    gaps.sort(key=lambda g: -g[0])
    out = []
    for length, a, b in gaps[:n]:
        mid = 0.5 * (a + b)
        around = [(y - x, name) for name, x, y in spans if x <= mid <= y]
        out.append((min(around)[1] if around else "host", float(length)))
    return out


def say(line: str) -> None:
    print(line, file=sys.stderr)


def report_gaps(run) -> None:
    say("idle gaps by the innermost span, program spans included: "
        + ", ".join(f"{name} {1e3 * t:.3f} ms"
                    for name, t in named_gaps(run)))


def loader_batches(run, traced_only: bool = True) -> list:
    """The ring's `loader.pack` records of the batches the window's calls
    took (with `traced_only`, the traced calls'), selected on the host
    clock by when the consumer took them; None without the ring."""
    records = ring()
    if records is None:
        return None
    spans = ([(a, b) for _, a, b in run.traced] if traced_only
             else [(a, b) for _, a, b, _ in run.calls])
    return [r for r in records
            if r.seq is not None and r.taken_ns is not None
            and any(a <= r.taken_ns * 1e-9 <= b for a, b in spans)]
