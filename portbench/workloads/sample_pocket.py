"""An interactive user generating for one pocket at a time:
`PocketSampler.sample_pocket` on one pocket x `samples` samples, one
client in a closed loop, each request timed on the host clock.

Mix keys: samples, pocket_atoms [lo, hi] (the pool's sizes spread evenly
over the range: every seed serves the same set of sizes, in an order
drawn from the seed), centres [lo, hi], pocket_pool, max_batch_size,
prot_bucket_multiple, trace_calls, check_calls and check_rows_per_call.
Set-up serves one request in each padded bucket of the pool."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from portbench import traffic
from portbench.workloads import common


class Workload:
    def __init__(self, run):
        self.run = run
        self.config = run.cell.config
        self.mix = run.cell.traffic
        self.done: List[tuple] = []

    def setup(self) -> None:
        from pharmaforge_tpu_torch.training.sampling import PocketSampler
        run, mix = self.run, self.mix
        with run.spans.span("setup.model"):
            self.weights = common.make_weights(self.config, run.seed,
                                               run.device)
            self.model = common.program_model(self.config, self.weights,
                                              run.device, "sampling")
            self.sampler = PocketSampler(
                self.model, prot_bucket_multiple=mix["prot_bucket_multiple"],
                device=run.device)
        with run.spans.span("setup.pockets"):
            self.make_pool()
        m = mix["prot_bucket_multiple"]
        buckets = {}
        for j, p in enumerate(self.pool):
            buckets.setdefault(-(-len(p["prot_x"]) // m), j)
        with run.spans.span("setup.warmup"):
            for w, j in enumerate(sorted(
                    buckets.values(),
                    key=lambda j: len(self.pool[j]["prot_x"]))):
                self.request(-1 - w, j)

    def make_pool(self) -> None:
        """The pockets of the mix, and the order requests take them in."""
        sizes = traffic.spaced_sizes(*self.mix["pocket_atoms"],
                                     self.mix["pocket_pool"])
        self.pool = common.make_pockets(self.config,
                                        traffic.rng(self.run.seed, 2), sizes)
        self.order = traffic.rng(self.run.seed, 9).permutation(
            len(self.pool))

    def plan(self, i: int, pocket: int = None):
        j = pocket if pocket is not None else \
            int(self.order[i % len(self.pool)])
        lo, hi = self.mix["centres"]
        sizes = traffic.rng(self.run.seed, 3, i).integers(
            lo, hi + 1, size=self.mix["samples"])
        return j, sizes, traffic.derive(self.run.seed, 4, i)

    def request(self, i: int, pocket: int = None):
        j, sizes, seed = self.plan(i, pocket)
        gen = torch.Generator(device=self.run.device).manual_seed(seed)
        self.sampler.sample_pocket(self.pool[j], list(sizes), gen,
                                   max_batch_size=self.mix["max_batch_size"])
        return j, sizes, seed, self.sampler.last_output

    def step(self, i: int) -> int:
        self.done.append(self.request(i))
        return 1

    def free(self) -> None:
        self.sampler = self.model = None

    def answers(self) -> List[common.Answer]:
        """`check_calls` finished requests drawn from the seed, the one
        on the largest pocket among them, and in each
        `check_rows_per_call` rows, the one with the most centres first."""
        seed, mix = self.run.seed, self.mix
        n_done = len(self.done)
        calls = common.pick(seed, 5, n_done, mix["check_calls"] - 1)
        largest = max(range(n_done),
                      key=lambda c: len(self.pool[self.done[c][0]]["prot_x"]))
        picked = []
        for c in sorted(set(calls) | {largest}):
            j, sizes, call_seed, out = self.done[c]
            n = len(sizes)
            f = out["pharm_x"].shape[1]
            gen = traffic.rng(seed, 6, c)
            rows = [int(np.argmax(sizes))]
            rows += [int(r) for r in gen.choice(n, size=n, replace=False)
                     if r not in rows][:mix["check_rows_per_call"] - 1]
            for r in rows:
                picked.append(common.Answer(
                    self.pool[j], sizes[r], call_seed, n, r, f,
                    out["pharm_x"][r], out["pharm_h"][r]))
        return picked

    def compare(self, precision: str = "float32"):
        return common.compare_answers(self, precision)

    @torch.no_grad()
    def work(self, run) -> None:
        """The least work of the kernels a step and the step's FLOPs
        (`costs/flops.py`): one eager denoiser step of the program for each
        pocket bucket among the traced requests, on the request's batch as
        `sample_pocket` builds it; averaged over the traced requests."""
        from pharmaforge_tpu_torch.data.batch import tile_pocket
        from portbench.costs import flops
        model, mult = self.model, self.mix["prot_bucket_multiple"]
        by_slots, works, notes = {}, [], []
        for c in run.traced:
            j, sizes, seed, _ = self.done[c[0]]
            pocket = self.pool[j]
            slots = -(-len(pocket["prot_x"]) // mult)
            if slots not in by_slots:
                batch = tile_pocket(pocket["prot_x"], pocket["prot_h"],
                                    list(sizes), prot_bucket_multiple=mult)
                pm = batch.prot_mask[..., None]
                com = ((batch.prot_x * pm).sum(1) / pm.sum(1)).astype(
                    np.float32)
                chain = model.chain_setup(
                    batch,
                    torch.Generator(device=run.device).manual_seed(seed),
                    com, pocket_group_size=batch.batch_size)
                by_slots[slots], got = flops.count_step(
                    lambda: model.chain_step(chain), run.peaks, common.bound)
                notes += [f"P={slots * mult}: {n}" for n in got]
            works.append(by_slots[slots])
        run.work = {k: float(np.mean([w[k] for w in works]))
                    for k in ("k1", "peak_s_per_step")}
        run.work["notes"] = notes
