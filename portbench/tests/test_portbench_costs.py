"""The copied count functions reproduce the figures PERF.md's kernel
table gives, and a program step's work is counted."""

from __future__ import annotations

import pytest

from portbench.costs import flops, k1, k2, k3

WIDTHS = dict(s=128, v=16, r=16, n_gvps=3)


def test_k1_at_the_sampling_shape():
    # B=240 F=8 P=230 K=5: 0.74 MB in, 0.93 MB out
    assert k1.bytes_in(240, 8, 230) == 742560
    assert k1.bytes_out(240, 8, 5) == 931200
    assert k1.cost(240, 8, 230, 5) == (742560 + 931200,
                                       240 * 8 * 230 * 13
                                       + 240 * 8 * 5 * 97)


def test_k2_bf16_at_the_sampling_shape():
    # 4 pockets x 30 copies, 230 atoms, 2,504 valid group-level slots:
    # 29.8 MB and 7.38 GFLOP
    n_bytes, ops, rows = k2.cost(b=120, p=230, g=4, nd=230, k=16,
                                 valid=2504, copies=30, table_bytes=2,
                                 **WIDTHS)
    assert round(n_bytes / 1e6, 1) == 29.8
    assert round(ops / 1e9, 2) == 7.38
    assert rows == 2504 * 30


def test_k3_at_the_training_shape():
    # B=32 P=Nd=256 K=16, 20,032 valid edge rows: 5.98 GFLOP, 20.8 MB
    n_bytes, ops, rows = k3.cost(b=32, p=256, g=32, nd=256, k=16,
                                 valid=20032, copies=1, elem=4, **WIDTHS)
    assert round(ops / 1e9, 2) == 5.98
    assert round(n_bytes / 1e6, 1) == 20.8
    assert rows == 20032


def test_a_program_step_is_counted():
    """One eager step of the tiny full-scale cell on the CPU: K1 once, K2
    in its three sampling layouts, matrix products in bf16 and fp32."""
    import argparse

    import torch

    from portbench import harness
    from portbench.tests import tiny
    cell = tiny.cell("full-screen")
    run = harness.Run(argparse.Namespace(workload=cell.name, seed=7,
                                         seconds=0.0, trace=1),
                      cell, torch.device("cpu"), 0.0)
    wl = harness.workload_for(run)
    wl.setup()
    wl.step(0)
    run.traced = [(0, 0.0, 0.0)]
    wl.work(run)
    assert run.work["k1"] > 0 and run.work["k2"] > 0
    assert "k3" not in run.work
    assert set(run.work["flops"]) == {"float32", "bfloat16"}
    assert sum(1 for n in run.work["notes"] if n.startswith("k2:")) == 3
    assert run.work["peak_s_per_step"] > 0


@pytest.mark.parametrize("kernel", sorted(flops.HOOKS))
def test_the_hooked_functions_are_the_ports(kernel):
    import importlib
    module, name = flops.HOOKS[kernel]
    assert callable(getattr(importlib.import_module(module), name))


def test_a_program_train_step_is_counted():
    """One eager train step of the tiny full-scale cell on the CPU: K1
    once, K2 in the forward and K3 for each K2 call under the gradient."""
    import argparse

    import torch

    from portbench import harness
    from portbench.tests import tiny
    cell = tiny.cell("full-train")
    run = harness.Run(argparse.Namespace(workload=cell.name, seed=7,
                                         seconds=0.0, trace=1),
                      cell, torch.device("cpu"), 0.0)
    wl = harness.workload_for(run)
    try:
        wl.setup()
        wl.step(0)
        wl.work(run)
    finally:
        wl.close()
    assert run.work["k1"] > 0 and run.work["k2"] > 0 and run.work["k3"] > 0
    assert run.work["peak_s_per_step"] > 0


@pytest.mark.parametrize("dtype,peak", [("bfloat16", 989e12),
                                        ("float32", 67e12)])
def test_bounds_take_the_dtypes_peak(dtype, peak):
    from portbench import manifest
    from portbench.workloads import common
    peaks = manifest.read_json(manifest.ROOT / "costs" / "peaks.json")
    t, by = common.bound(1, 10 ** 12, dtype, peaks)
    assert by == "operations" and t == pytest.approx(1e12 / peak)
    assert flops.DTYPES
