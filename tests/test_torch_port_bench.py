"""The port's benchmark (`python -m pharmaforge_tpu_torch.bench`) on the
CPU: its flags and defaults are the JAX `bench.py`'s, its JSON line has
`bench.py`'s keys less the three with no counterpart plus the five it
adds, the CPU run says so (`platform` "cpu", no MFU), and without a card
and without `--device cpu` it fails instead of running on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pharmaforge_tpu_torch import bench

ROOT = Path(__file__).resolve().parents[1]

# bench.py's line under --quick (bench.py:662-727: the dev keys, the
# baseline flag of a non-dev workload, the train keys; no fullscale_* under
# --quick)
JAX_QUICK_KEYS = {
    "metric", "platform", "workload", "value", "unit", "vs_baseline",
    "baseline_samples_per_sec", "baseline_extrapolated", "spread_min",
    "spread_max", "repeats", "rates_per_repeat", "pipeline_depth",
    "pockets_per_call", "chain_latency_ms", "mfu_vs_bf16_peak",
    "chain_gflops", "step_cost_model_gbytes_unfused",
    "train_steps_per_sec", "train_step_device_ms", "train_batch_size"}
# no counterpart in the port (XLA's cost model; --measure_torch_baseline)
LEFT_OUT = {"step_cost_model_gbytes_unfused",
            "torch_executor_samples_per_sec_host_cpu"}
ADDED = {"device", "power_limit_w", "host_cpu", "torch_version",
         "cuda_version"}
QUICK = ["--quick", "--device", "cpu", "--repeats", "1",
         "--pipeline_depth", "2"]


def test_quick_cpu_line_has_bench_keys(capsys):
    res = bench.main(QUICK)
    assert set(res) == (JAX_QUICK_KEYS - LEFT_OUT) | ADDED
    assert res["platform"] == "cpu" and res["device"] == "cpu"
    assert res["mfu_vs_bf16_peak"] is None and "timing_suspect" not in res
    assert res["power_limit_w"] is None and res["workload"] == "quick"
    assert res["value"] > 0 and res["train_steps_per_sec"] > 0
    assert res["chain_gflops"] > 0 and len(res["rates_per_repeat"]) == 1
    assert res["pipeline_depth"] == 2 and res["pockets_per_call"] == 2
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == res


def test_flags_default_as_jax_bench():
    args = bench.parse_args([])
    assert (args.samples_per_pocket, args.max_batch_size, args.pocket_atoms,
            args.n_timesteps, args.n_convs, args.repeats,
            args.pipeline_depth, args.pockets_per_call,
            args.matmul_precision) == (30, 32, 230, 100, 2, 5, 16, 8,
                                       "bfloat16")
    assert not (args.quick or args.endpoint_param or args.skip_train_bench
                or args.skip_fullscale_bench) and args.device is None
    assert bench.parse_args(["--n_convs", "4"]).pockets_per_call == 4
    assert bench.baseline_for_workload(100, 2) == 125.0
    assert bench.baseline_for_workload(1000, 4) == 6.25


def test_without_cuda_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--quick"])


def test_without_cuda_the_module_exits_nonzero():
    res = subprocess.run(
        [sys.executable, "-m", "pharmaforge_tpu_torch.bench", "--quick"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert "CUDA" in res.stderr and "{" not in res.stdout
