"""The port's benchmark: one cell of `BENCHMARK.json` a process.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device` and, traced, `breakdown`; the
numbers that decided `correct` come last, under `compared`, and also as
the last lines of standard error. Exits non-zero with no result where
CUDA or the cell's cards are missing, where a file the cell names is
missing, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# the program's kernels and Triton's cache build inside the checkout, at
# fixed paths, so a second run of a cell finds them built
os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(REPO / "build" / "torch_extensions"))
# keep `transformers`-style optional imports from loading JAX
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one process with few threads: the host's share of a step steadier
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    torch.set_num_threads(1)

    from portbench import harness, manifest
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    try:
        cell = manifest.Cell.find(manifest.load_manifest(), args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"cannot read the cell {args.workload!r}: {e!r}",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    return harness.run_cell(args, cell, torch.device("cuda", 0), T_START)


if __name__ == "__main__":
    sys.exit(main())
