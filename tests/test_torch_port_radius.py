"""The port with radius pocket-pharmacophore edges (`pf_k` 0) against the
benchmark's plain radius reference (`portbench/reference/radius.py`), on
the CPU at a small size, in fp32.

* One denoiser call, eval and train mode (dropout drawn alike on both
  sides), one row a pocket and pocket groups of 3 copies;
* a T=4 `sample_stacked` chain through the benchmark's `radius-screen`
  workload, shrunk, with its comparison;
* planted faults that must fail the same checks: kNN pf edges in place of
  radius ones, r_pf of 6 A, and the reference's edge chains rounded to
  fp8;
* the radius edge's span and counters (`utils/trace.py`): rows B*F*P a
  build, the reference's count of valid pairs only while profiled, nothing
  inside a CUDA graph capture (a `cuda` test);
* K4's cost (`portbench/costs/k4.py`) against `chip_smoke`'s at the
  full-screen step's chains and the radius cell's message chains (122,880
  dense rows, 61,440 on its slots).
"""

import argparse
import contextlib
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from pharmaforge_tpu_torch.models import dynamics as dynamics_mod
from pharmaforge_tpu_torch.models.conv import message_specs
from pharmaforge_tpu_torch.models.dynamics import NoisePredictionBlock
from pharmaforge_tpu_torch.models.edges import (
    GroupedEdgeData,
    build_edge_bundle,
    build_pp_edge,
    radius_slot_count,
)
from pharmaforge_tpu_torch.models.gvp import GVPChain, gvp_specs
from pharmaforge_tpu_torch.utils import trace
from portbench import calibrate, harness, manifest
from portbench.costs import k4
from portbench.reference import chain as rc
from portbench.reference import model as rm
from portbench.reference import radius
from portbench.tests import tiny
from portbench.workloads import common, sample_radius

SEED = 2 ** 31 + 20
CPU = torch.device("cpu")
# one fp32 denoiser call, port against reference: the same sums in another
# order (the port's node tables, K2's plain version, the dense
# aggregation) through 4 convs, 1.5e-8 apart at these widths; each planted
# fault moves an output by 1e-3 or more
CALL_TOL = 1e-5
# a T=4 chain in fp32 (the benchmark's numbers): 1.3e-7 / 3e-8 sound, the
# faults and the fp8 control 9e-4 or more
CHAIN_LIMITS = {"x_gap_median": 1e-5, "h_gap": 1e-5}


def small_config(dtype: str = "float32") -> dict:
    """`pforge-radius` at S=16, V=4, 4 convs, T=4, edge chains in
    `dtype`."""
    config = copy.deepcopy(manifest.read_json(
        manifest.ROOT / "configs" / "pforge-radius.json"))
    config["model"].update(tiny.TINY_MODEL)
    config["sampling"]["compute_dtype"] = dtype
    return config


def with_model(config: dict, **model) -> dict:
    config = copy.deepcopy(config)
    config["model"].update(model)
    return config


def inputs(config: dict, copies: int, seed: int = 3, slots: int = 48):
    """Two pockets of 40 and 36 atoms in `slots` slots, `copies` rows each,
    8 centre slots (8, 5, 3, ... valid) near the cavity, one t a pocket."""
    gen = np.random.default_rng(seed)
    pockets = common.make_pockets(config, gen, [40, 36])
    prot_x, prot_h, prot_mask = common.pocket_tensors(pockets, slots, CPU)
    rep = lambda a: torch.repeat_interleave(a, copies, dim=0)  # noqa: E731
    prot_x, prot_h, prot_mask = rep(prot_x), rep(prot_h), rep(prot_mask)
    b, f, nf = prot_x.shape[0], 8, common.n_ph_types(config)
    pharm_mask = torch.zeros(b, f, dtype=torch.bool)
    for i, n in enumerate([8, 5, 3, 6, 4, 7][:b] + [5] * max(0, b - 6)):
        pharm_mask[i, :n] = True
    fm = pharm_mask.float()[..., None]
    pharm_x = torch.from_numpy(gen.normal(scale=3.0, size=(b, f, 3))
                               .astype(np.float32)) * fm
    pharm_h = torch.from_numpy(gen.normal(size=(b, f, nf))
                               .astype(np.float32)) * fm
    t = rep(torch.tensor([0.3, 0.8]))
    return pharm_h, pharm_x, pharm_mask, prot_h, prot_x, prot_mask, t


def port_call(config, weights, args, copies: int, train: bool):
    """The port's denoiser on `args` (eval, or train with dropout drawn
    from seed 7)."""
    model = common.program_model(config, weights, CPU, "sampling")
    dyn = model.dynamics.train(train)
    prot_x, prot_mask = args[4], args[5]
    _, pp = build_pp_edge(prot_x[::copies], prot_mask[::copies],
                          float(config["model"]["graph_cutoffs"]["pp"]),
                          config["model"]["pp_k_max"])
    if copies > 1:
        pp = GroupedEdgeData(*pp, copies=copies)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        return dyn(*args, pp_edge=pp, pocket_group_size=copies,
                   generator=gen)


def reference_call(config, weights, args, train: bool,
                   precision: str = "float32"):
    """The radius reference on `args`, dropout drawn as the port draws it."""
    model = sample_radius.reference_model(config, weights, CPU, precision)
    cfg = common.reference_config(config)
    pp = rm.edge_state(cfg, args[4], args[5])
    drop = rc.Dropout(cfg["dropout"], torch.Generator().manual_seed(7)) \
        if train else None
    model.train(train)
    with torch.no_grad():
        return model(*args, pp, drop=drop)


def call_gap(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def weights():
    return common.make_weights(small_config(), SEED, CPU)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("copies", [1, 3])
def test_a_denoiser_call_matches_the_reference(weights, train, copies):
    config = small_config()
    args = inputs(config, copies)
    got = port_call(config, weights, args, copies, train)
    want = reference_call(config, weights, args, train)
    assert call_gap(got, want) <= CALL_TOL
    # the pocket context reaches the output: the faults below can show
    assert float(want[0].abs().max()) > 0.1


@pytest.mark.parametrize("fault", ["knn", "r_pf_6", "fp8"])
def test_a_planted_fault_fails_the_call(weights, fault):
    config = small_config()
    args = inputs(config, 3)
    want = reference_call(config, weights, args, train=False)
    if fault == "fp8":
        got = reference_call(config, weights, args, False, "float8")
    else:
        bad = with_model(config, **(
            {"pf_k": 5} if fault == "knn" else
            {"graph_cutoffs": dict(config["model"]["graph_cutoffs"],
                                   pf=6.0)}))
        got = port_call(bad, weights, args, 3, train=False)
    assert call_gap(got, want) > 10 * CALL_TOL


def tiny_radius_cell(config: dict) -> manifest.Cell:
    """`radius-screen` with `config`, the shrunk stacked mix (2 pockets x
    3 of 40 atoms in 64 slots), and CHAIN_LIMITS."""
    m = manifest.load_manifest()
    full = manifest.Cell.find(m, "radius-screen")
    mix = dict(full.traffic, **tiny.TINY_TRAFFIC["sample_stacked"])
    limits = {k: {"limit": v} for k, v in CHAIN_LIMITS.items()}
    return manifest.Cell(full.name, full.entry, config, mix, limits,
                         m["end_to_end"], m["per_layer"])


def chain_gaps(cell: manifest.Cell, control: bool = False) -> dict:
    """The cell's set-up, two calls and its comparison (`calibrate.py`'s
    readings): {"program": gaps[, "control": the fp8 reference's gaps]}."""
    torch.set_num_threads(1)
    return dict(calibrate.readings(cell, SEED, 2, CPU, control=control,
                                   fault=False))


def within(gaps: dict) -> bool:
    return all(gaps[k] <= v for k, v in CHAIN_LIMITS.items())


@contextlib.contextmanager
def edges_with(**forced):
    """The port's denoiser builds its edges with `forced` settings:
    pf_k, or cutoffs updated."""
    real = dynamics_mod.build_edge_bundle

    def bundle(px, pm, rx, rm_, cutoffs, ff_k, pf_k, pp_edge,
               pf_slots=None):
        cutoffs = dict(cutoffs, **forced.get("cutoffs", {}))
        return real(px, pm, rx, rm_, cutoffs, ff_k=ff_k,
                    pf_k=forced.get("pf_k", pf_k), pp_edge=pp_edge,
                    pf_slots=pf_slots)

    dynamics_mod.build_edge_bundle = bundle
    try:
        yield
    finally:
        dynamics_mod.build_edge_bundle = real


def test_a_sampled_chain_matches_the_reference():
    got = chain_gaps(tiny_radius_cell(small_config()))
    assert within(got["program"]), got
    # the workload's close put the kNN reference back
    assert common.reference_model is not sample_radius.reference_model


@pytest.mark.parametrize("fault", [dict(pf_k=5),
                                   dict(cutoffs={"pf": 6.0})],
                         ids=["knn", "r_pf_6"])
def test_a_planted_fault_fails_the_chain(fault):
    with edges_with(**fault):
        got = chain_gaps(tiny_radius_cell(small_config()))
    assert not within(got["program"]), got


def test_the_fp8_control_fails_the_chain():
    """The reference with fp8-rounded edge chains in the program's place."""
    cell = tiny_radius_cell(small_config())
    assert cell.config["sampling"]["control"] == "float8"
    got = chain_gaps(cell, control=True)
    assert within(got["program"]) and not within(got["control"]), got


def test_the_work_step_counts_the_valid_share():
    """A traced run's work step on the CPU: the valid share from the
    program's counters; K4 runs only on the card, so its roofline and
    `mfu.radius` read nothing here."""
    cell = tiny_radius_cell(small_config("bfloat16"))
    run = harness.Run(argparse.Namespace(workload=cell.name, seed=SEED,
                                         seconds=0.0, trace=1),
                      cell, CPU, 0.0)
    wl = harness.workload_for(run)
    try:
        wl.setup()
        wl.step(0)
        run.traced = [(0, 0.0, 0.0)]
        wl.work(run)
    finally:
        wl.close()
    # the chain's rows: B*F*M, M the slot count of the call's pockets
    b, f, p = 6, max(cell.traffic["centres"]), cell.traffic["prot_slots"]
    prot_x, _, prot_mask = common.pocket_tensors(
        [wl.pool[j] for j in wl.done[0][0]], p, CPU)
    m = radius_slot_count(prot_x, prot_mask, 8.0)
    assert m < p
    assert run.work["pf_radius_rows"] == b * f * m
    share = manifest.metric_reader("pf_valid_share.radius")(run)
    assert 0 < share < 100
    assert "k4" not in run.work and "k4_peak_s_per_step" not in run.work


def edge_args(seed: int = 4):
    config = small_config()
    args = inputs(config, 2, seed)
    _, pp = build_pp_edge(args[4], args[5], 3.5, 16)
    return (args[1], args[2], args[4], args[5],
            dict(config["model"]["graph_cutoffs"]), pp)


def build(args, pf_k: int = 0):
    px, pm, rx, rmask, cutoffs, pp = args
    return build_edge_bundle(px, pm, rx, rmask, cutoffs, ff_k=0, pf_k=pf_k,
                             pp_edge=pp)


def test_the_counters_count_rows_untraced_and_no_pairs():
    args = edge_args()
    trace.reset()
    build(args)
    build(args)
    got = trace.counters()
    b, f = args[1].shape
    assert got["edges.pf_radius_rows"] == 2 * b * f * args[2].shape[1]
    assert got["edges.pf_radius_pairs"] == 0
    assert not trace.records("edges.radius")


def test_traced_pairs_are_the_references_count():
    args = edge_args()
    px, pm, rx, rmask, cutoffs, _ = args
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bundle = build(args)
    got = trace.counters()
    want = radius.radius_pairs(px, pm, rx, rmask, cutoffs["pf"])
    assert got["edges.pf_radius_rows"] == want.numel()
    assert got["edges.pf_radius_pairs"] == int(want.sum()) > 0
    assert torch.equal(bundle["pf"].mask, want)
    assert torch.equal(bundle["fp"].mask, want.transpose(1, 2))
    assert len(trace.records("edges.radius")) == 1
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("pf.edges.radius") == 1


def test_knn_edges_count_nothing():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        build(edge_args(), pf_k=5)
    got = trace.counters()
    assert got["edges.pf_radius_rows"] == got["edges.pf_radius_pairs"] == 0
    assert not trace.records("edges.radius")


@pytest.mark.cuda
def test_a_captured_build_counts_no_pairs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graph capture")
    dev = torch.device("cuda")
    px, pm, rx, rmask, cutoffs, pp = edge_args()
    args = (px.to(dev), pm.to(dev), rx.to(dev), rmask.to(dev), cutoffs,
            type(pp)(*(a.to(dev) for a in pp)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        build(args)
    torch.cuda.current_stream().wait_stream(side)
    trace.reset()
    graph = torch.cuda.CUDAGraph()
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.cuda.graph(graph):
            build(args)
        graph.replay()
    torch.cuda.synchronize()
    got = trace.counters()
    assert got["edges.pf_radius_rows"] == px.shape[0] * px.shape[1] \
        * rx.shape[1]
    assert got["edges.pf_radius_pairs"] == 0


def chain_of(kind: str):
    """A chain of pforge-full's widths, as `chip_smoke.gvp_chain_case`
    builds it."""
    return list({"message": lambda: GVPChain(message_specs(3, 16, 128, 16)),
                 "update": lambda: GVPChain(gvp_specs(2, 16, 128)),
                 "noise": lambda: NoisePredictionBlock(
                     128, 6, 16, n_gvps=4).gvps}[kind]())


@pytest.mark.parametrize("case", chip_smoke.GVP_CHAIN_TIMED)
def test_k4_cost_is_chip_smokes(case):
    kind, rows, dtype = chip_smoke.GVP_CHAIN_CASES[case]
    gvps = chain_of(kind)
    assert k4.cost(k4.dims(gvps), rows, dtype) == \
        chip_smoke.gvp_chain_cost(gvps, rows, dtype)
    assert k4.weights(k4.dims(gvps)) == sum(p.numel() for g in gvps
                                            for p in g.parameters())
