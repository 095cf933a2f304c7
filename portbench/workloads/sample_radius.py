"""A screening pipeline on the radius graph: `sample_stacked`'s closed loop
of `PocketSampler.sample_stacked` calls (its mix keys) on a configuration
with `pf_k` 0, whose pf/fp edges are every (centre, pocket atom) pair
within r_pf.

The answers are recomputed by the radius reference
(`reference/radius.py`): while the workload is open,
`common.reference_model` builds it, so `common.reference_answers` (the
comparison, and `calibrate.py`'s readings) recomputes the answers on the
radius graph; `close` puts the kNN reference back.

The eager work step (`work`) also records each K4 launch's chain and rows
(K4's least time a launch, and its FLOPs for `mfu.radius`), checked
against the program's `gvp_chain.launches`, and the radius pf edge's
counters `edges.pf_radius_rows` and `edges.pf_radius_pairs`; it runs
profiled, which is where the program counts pairs. A program without
those counters leaves them out, and their readers read nothing."""

from __future__ import annotations

import contextlib
import importlib
from typing import List

import torch

from portbench.costs import k4
from portbench.reference import model as rm
from portbench.reference import radius
from portbench.workloads import common, sample_stacked

# the program's function that launches K4, as (module, name) where the
# GVP chains call it
K4_HOOK = ("pharmaforge_tpu_torch.models.gvp", "fused_gvp_chain")


def reference_model(config: dict, weights, device, precision: str):
    """`common.reference_model` for a radius configuration: the radius
    reference at the configuration's r_pf, edge chains rounded to
    `precision` where that is a rounding."""
    edge = precision if precision in rm.ROUNDING else "float32"
    cfg = dict(common.reference_config(config),
               pf_cutoff=float(config["model"]["graph_cutoffs"]["pf"]))
    return radius.build(cfg, weights, device, edge)


@contextlib.contextmanager
def k4_launches():
    """Inside the block the program's K4 calls (`K4_HOOK`) are recorded:
    yields a list that gets one (chain dims, rows, dtype) a call."""
    module = importlib.import_module(K4_HOOK[0])
    real = getattr(module, K4_HOOK[1])
    seen: List[tuple] = []

    def hooked(gvps, feats, vectors):
        gvps = list(gvps)
        seen.append((k4.dims(gvps), feats[..., 0].numel(),
                     str(feats.dtype).removeprefix("torch.")))
        return real(gvps, feats, vectors)

    setattr(module, K4_HOOK[1], hooked)
    try:
        yield seen
    finally:
        setattr(module, K4_HOOK[1], real)


class Workload(sample_stacked.Workload):
    def __init__(self, run):
        super().__init__(run)
        if self.config["model"]["pf_k"]:
            raise ValueError("sample_radius runs a configuration with "
                             "pf_k 0 (radius pf edges)")
        self._knn_reference = common.reference_model
        common.reference_model = reference_model

    def close(self) -> None:
        common.reference_model = self._knn_reference

    @torch.no_grad()
    def work(self, run) -> None:
        """`sample_stacked`'s eager work step, profiled, with K4's launches
        recorded and the program's counters read around it."""
        from pharmaforge_tpu_torch.utils import trace
        before = trace.counters()
        with k4_launches() as seen, torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            super().work(run)
        got = trace.counters() - before
        notes = run.work["notes"]
        launched = got["gvp_chain.launches"]
        notes.append(f"k4: {len(seen)} calls recorded in the work step, "
                     f"gvp_chain.launches counted {launched}")
        if seen and len(seen) == launched:
            times, peak_s = [], 0.0
            for chain, rows, dtype in seen:
                n_bytes, n_ops = k4.cost(chain, rows, dtype)
                t, by = common.bound(n_bytes, n_ops, dtype, run.peaks)
                times.append(t)
                peak_s += n_ops / run.peaks["ops_per_s"][dtype]
                notes.append(f"k4: {rows} rows {dtype}, {n_bytes} B, {n_ops} "
                             f"ops, least {t:.9f} s by {by}")
            run.work["k4"] = sum(times) / len(times)
            run.work["k4_peak_s_per_step"] = peak_s
        rows, pairs = (got["edges.pf_radius_rows"],
                       got["edges.pf_radius_pairs"])
        notes.append(f"pf radius edge: {rows} rows, {pairs} valid pairs "
                     f"counted in the work step")
        if rows and pairs:
            run.work["pf_radius_rows"] = rows
            run.work["pf_radius_pairs"] = pairs
