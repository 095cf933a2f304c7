"""The readings that a cell's limits are set from (not run by the
benchmark's own runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--calls N]

For each seed: the cell's own set-up and `--calls` calls of its timed path
at its own load, then the comparison the benchmark makes (the program's
readings, which set a limit's lower end). For each control seed the same,
and beside it the reference in the precision below the configuration's
put in the program's place (bf16 -> fp8 rounding, fp32 -> TF32), compared
with the fp32 reference alike. For each fault seed (training) the
reference with each planted fault (`train_call.FAULTS`: half of each
batch left out; every step of the call on its first batch) in the
program's place; a state left unchanged reads 1 by the change's measure
and needs no run. One JSON line a reading, then a summary line with each
number's lower reading (the largest over the program's seeds) and upper
reading (the least of the control's smallest, where that is three times
the lower or more, and each fault's smallest, where that is ten times the
lower or more).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def readings(cell, seed: int, calls: int, device, control: bool,
             fault: bool):
    from portbench import harness
    from portbench.workloads import common
    args = argparse.Namespace(workload=cell.name, seed=seed, seconds=0.0,
                              trace=0)
    run = harness.Run(args, cell, device, time.perf_counter())
    wl = harness.workload_for(run)
    out = []
    try:
        wl.setup()
        kind = cell.traffic["kind"]
        for i in range(calls if kind != "train_call" else 0):
            wl.step(i)
        wl.free()
        if kind == "train_call":
            from portbench.workloads.train_call import FAULTS, training_gaps
            ref = wl.reference_steps("float32")
            out.append(("program", training_gaps(wl.program_steps(), ref,
                                                 wl.weights)))
            if control:
                ctl = wl.reference_steps(cell.config["training"]["control"])
                out.append(("control", training_gaps(ctl, ref, wl.weights)))
            for name in FAULTS if fault else ():
                got = wl.reference_steps("float32", fault=name)
                out.append((name, training_gaps(got, ref, wl.weights)))
        else:
            answers = wl.answers()
            ref = common.reference_answers(wl.config, wl.weights, answers,
                                           device)
            out.append(("program", common.answer_gaps(answers, ref)))
            if control:
                ctl = common.reference_answers(
                    wl.config, wl.weights, answers, device,
                    cell.config["sampling"]["control"])
                as_program = [common.Answer(a.pocket, a.size, a.call_seed,
                                            a.batch, a.row, a.f,
                                            ctl["pharm_x"][i],
                                            ctl["pharm_h"][i])
                              for i, a in enumerate(answers)]
                out.append(("control", common.answer_gaps(as_program, ref)))
    finally:
        close = getattr(wl, "close", None)
        if close is not None:
            close()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--calls", type=int, default=None)
    args = p.parse_args(argv)
    import torch

    from portbench import manifest
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.Cell.find(manifest.load_manifest(), args.workload)
    calls = args.calls or max(cell.traffic.get("check_calls", 1), 1) + (
        2 if cell.traffic["kind"] == "sample_pocket" else 0)
    device = torch.device("cuda", 0)
    seen = {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)
                       | set(args.fault_seeds)):
        t0 = time.perf_counter()
        got = readings(cell, seed, calls, device,
                       seed in args.control_seeds, seed in args.fault_seeds)
        for kind, numbers in got:
            if kind == "program" and seed not in args.seeds:
                continue
            seen.setdefault(kind, []).append(numbers)
            print(json.dumps({"cell": cell.name, "seed": seed, "kind": kind,
                              "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    summary = {}
    for name in seen["program"][0]:
        lower = max(r[name] for r in seen["program"])
        entry = {"lower": lower, "program_seeds": len(seen["program"])}
        uppers = []
        for kind in seen:
            if kind != "program":
                least = min(r[name] for r in seen[kind])
                entry[f"{kind}_min"] = least
                if least >= (3 if kind == "control" else 10) * lower:
                    uppers.append(least)
        entry["upper"] = min(uppers) if uppers else None
        summary[name] = entry
    print(json.dumps({"cell": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
