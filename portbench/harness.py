"""One run of one cell: set-up, the measured window, the traced readings,
the comparison that decides `correct`, and the result line.

The window: calls of the cell's workload back to back (a closed loop)
from its start for `--seconds`; it ends where the last call that ended
inside it ends, so no call counts in part. With `--trace 1` the first
`trace_calls` calls of the window run under the profiler, and the line
carries the cell's per-layer metrics instead of its end-to-end ones.
"""

from __future__ import annotations

import gc
import importlib
import json
import re
import statistics
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import manifest, trace

# modules the process that prints the result may not hold, compared by
# their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "pharmaforge_tpu")


def forbidden_loaded() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card(device) -> Dict[str, object]:
    """The card's name and power limit (nvidia-smi)."""
    if torch.device(device).type != "cuda":
        return {"name": str(device), "power_limit": "none"}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=60).stdout.strip()
        name, limit = [s.strip() for s in out.split(",")[:2]]
        return {"name": name, "power_limit": limit}
    except (OSError, ValueError, subprocess.SubprocessError):
        return {"name": torch.cuda.get_device_name(0),
                "power_limit": "not read"}


class Run:
    """What one run knows: its arguments, cell, device, spans, calls, and
    after a traced window its trace and the work of the traced calls."""

    def __init__(self, args, cell: manifest.Cell, device, t_start: float):
        self.args = args
        self.cell = cell
        self.device = device
        self.seed = int(args.seed)
        self.t_start = t_start
        self.spans = trace.Spans()
        self.calls: List[tuple] = []      # (i, start, end, items)
        self.traced: List[tuple] = []     # (i, start, end) under the profiler
        self.trace = None
        self.work: Dict[str, object] = {}
        self.peaks = manifest.read_json(manifest.ROOT / "costs"
                                        / "peaks.json")


def workload_for(run: Run):
    kind = run.cell.traffic["kind"]
    return importlib.import_module(f"portbench.workloads.{kind}").Workload(run)


def window(run: Run, wl) -> float:
    """The measured window; returns its length in seconds."""
    n_trace = run.cell.traffic.get("trace_calls", 0) if run.args.trace else 0
    prof = trace.profiler(run.device) if n_trace else None
    t0 = time.perf_counter()
    last = t0
    i = 0
    running = False
    try:
        while True:
            traced = i < n_trace
            if traced and i == 0:
                prof.start()
                running = True
            with run.spans.span("call"):
                start = time.perf_counter()
                items = wl.step(i)
                end = time.perf_counter()
            if traced:
                run.traced.append((i, start, end))
            if running and i == n_trace - 1:
                prof.stop()
                running = False
            if end - t0 > run.args.seconds:
                break
            run.calls.append((i, start, end, items))
            last = end
            i += 1
    finally:
        if running:
            prof.stop()
    if not run.calls:
        raise RuntimeError(f"no call ended inside the {run.args.seconds} s "
                           f"window")
    if prof is not None:
        t = time.perf_counter()
        run.trace = trace.Trace(prof)
        del prof
        print(f"trace read: {run.trace.n_events} device operations in "
              f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    return last - t0


def end_to_end(run: Run, window_s: float, setup_s: float) -> dict:
    """The cell's end-to-end metrics, each by its entry in BENCHMARK.json:
    `setup_s`; a rate (a unit in "/s") is the items of every call in the
    window over the window; `<name>_p<q>_ms` is the q-th percentile of the
    window's call latencies."""
    metrics = {}
    for m in run.cell.end_to_end:
        name, unit = m["name"], m["unit"]
        tail = re.search(r"_p(\d+)_ms$", name)
        if name == "setup_s":
            value = setup_s
        elif unit.endswith("/s"):
            value = sum(c[3] for c in run.calls) / window_s
        elif tail and unit == "ms":
            lat = [(c[2] - c[1]) * 1e3 for c in run.calls]
            value = float(np.percentile(lat, int(tail.group(1))))
            print(f"calls: {len(lat)}, latency median "
                  f"{statistics.median(lat):.3f} ms, {name} {value:.3f} ms",
                  file=sys.stderr)
        else:
            raise ValueError(f"no statistic for the end-to-end metric "
                             f"{name!r} ({unit})")
        metrics[name] = {"value": float(value), "unit": unit}
    return metrics


def per_layer(run: Run) -> dict:
    out = {}
    for m in run.cell.per_layer:
        value = manifest.metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def traced_window(run: Run):
    """[start, end] of the traced calls on the profiler's clock."""
    spans = run.trace.spans("call")[:len(run.traced)]
    return spans[0][0], spans[-1][1]


def compared(numbers: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """The numbers the cell's limits name, each beside its limit."""
    return {k: {"value": numbers[k], "limit": limits[k]["limit"]}
            for k in limits}


def run_cell(args, cell: manifest.Cell, device, t_start: float) -> int:
    run = Run(args, cell, device, t_start)
    wl = workload_for(run)
    try:
        return _run(run, wl)
    finally:
        close = getattr(wl, "close", None)
        if close is not None:
            close()


def _run(run: Run, wl) -> int:
    args, cell, device = run.args, run.cell, run.device
    wl.setup()
    sync(device)
    setup_s = time.perf_counter() - run.t_start
    window_s = window(run, wl)
    sync(device)
    found = forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    on_card = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    info = card(device)
    dev = {"platform": "gpu" if on_card else "cpu", "kind": info["name"],
           "count": cell.chips, "memory_peak_bytes": peak}
    breakdown = None
    if args.trace:
        wl.work(run)
    wl.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if args.trace:
        t0, t1 = traced_window(run)
        metrics = per_layer(run)
        dev["busy_s"] = run.trace.busy(t0, t1)
        dev["window_s"] = t1 - t0
        breakdown = {"device_ops": run.trace.top_ops(t0, t1),
                     "idle_gaps": run.trace.idle_gaps(t0, t1)}
        print(f"traced: {len(run.traced)} calls, "
              f"{run.trace.n_events} device operations, busy "
              f"{dev['busy_s']:.6f} s of {dev['window_s']:.6f} s; "
              f"{info['name']}, power limit {info['power_limit']}",
              file=sys.stderr)
        for line in run.work.get("notes", []):
            print(line, file=sys.stderr)
    else:
        metrics = end_to_end(run, window_s, setup_s)
    with run.spans.span("reference"):
        numbers = wl.compare()
    phases = [(n, b - a) for n, a, b, _ in run.spans.items
              if n.startswith("setup.") or n == "reference"]
    print("set-up phases and the reference: " + ", ".join(
        f"{n} {t:.3f} s" for n, t in phases), file=sys.stderr)
    check = compared(numbers, cell.limits)
    correct = all(c["value"] <= c["limit"] for c in check.values())
    print(f"{cell.name}: seed {run.seed}, {len(run.calls)} calls in "
          f"{window_s:.3f} s, set-up {setup_s:.3f} s; {info['name']}, "
          f"power limit {info['power_limit']}", file=sys.stderr)
    print("window calls (s): " + " ".join(
        f"{c[2] - c[1]:.4f}" for c in run.calls), file=sys.stderr)
    for k, v in numbers.items():
        if k not in check:
            print(f"read, not compared, {k}: {v!r}", file=sys.stderr)
    for k, c in check.items():
        print(f"compared {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result = {"correct": correct, "attempted": len(run.calls), "failed": 0,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = check
    found = forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
