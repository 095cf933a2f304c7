"""A screening pipeline: `PocketSampler.sample_stacked` on
`pockets_per_call` pockets x `samples_per_pocket` samples in one device
batch, calls back to back in one closed loop, each ending in its copy to
the host.

Mix keys: pockets_per_call, samples_per_pocket, pocket_atoms [lo, hi],
centres [lo, hi] (each sample's count, uniform), pocket_pool (pockets
made at set-up; calls take them in a seeded order), prot_slots (the
sampler's fixed slot count), warmup_calls, trace_calls, check_calls and
check_rows_per_pocket (the answers the reference recomputes)."""

from __future__ import annotations

import gc
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
            self.sampler = PocketSampler(self.model,
                                         fixed_prot_slots=mix["prot_slots"],
                                         device=run.device)
        with run.spans.span("setup.pockets"):
            self.make_pool()
        with run.spans.span("setup.warmup"):
            for w in range(mix["warmup_calls"]):
                self.call(-1 - w)
            # set-up's objects are collected here and kept out of later
            # full collections, so none lands, at a random call, in the
            # window
            gc.collect()
            gc.freeze()

    def make_pool(self) -> None:
        """The pockets of the mix, and the order calls take them in."""
        lo, hi = self.mix["pocket_atoms"]
        gen = traffic.rng(self.run.seed, 2)
        sizes = gen.integers(lo, hi + 1, size=self.mix["pocket_pool"])
        self.pool = common.make_pockets(self.config, gen, sizes)
        self.order = gen.permutation(len(self.pool))

    def plan(self, i: int):
        mix = self.mix
        per = mix["pockets_per_call"]
        ids = [int(self.order[(i * per + k) % len(self.pool)])
               for k in range(per)]
        lo, hi = mix["centres"]
        sizes = traffic.rng(self.run.seed, 3, i).integers(
            lo, hi + 1, size=(per, mix["samples_per_pocket"]))
        return ids, sizes, traffic.derive(self.run.seed, 4, i)

    def call(self, i: int):
        ids, sizes, seed = self.plan(i)
        gen = torch.Generator(device=self.run.device).manual_seed(seed)
        self.sampler.sample_stacked([self.pool[j] for j in ids],
                                    [list(s) for s in sizes], gen)
        return ids, sizes, seed, self.sampler.last_output

    def step(self, i: int) -> int:
        ids, sizes, seed, out = self.call(i)
        self.done.append((ids, sizes, seed, out))
        return int(sizes.size)

    def free(self) -> None:
        self.sampler = self.model = None
        gc.unfreeze()

    def answers(self) -> List[common.Answer]:
        """The answers the reference recomputes: `check_calls` finished
        calls drawn from the seed and, in each, `check_rows_per_pocket`
        rows of every pocket, the one with the most centres first."""
        seed, mix = self.run.seed, self.mix
        picked = []
        for c in common.pick(seed, 5, len(self.done), mix["check_calls"]):
            ids, sizes, call_seed, out = self.done[c]
            per, n = sizes.shape
            f = out["pharm_x"].shape[1]
            gen = traffic.rng(seed, 6, c)
            for k in range(per):
                rows = [int(np.argmax(sizes[k]))]
                rows += [int(r) for r in gen.choice(n, size=n, replace=False)
                         if r not in rows][:mix["check_rows_per_pocket"] - 1]
                for r in rows:
                    b = k * n + r
                    picked.append(common.Answer(
                        self.pool[ids[k]], sizes[k, r], call_seed, per * n,
                        b, f, out["pharm_x"][b], out["pharm_h"][b]))
        return picked

    def compare(self, precision: str = "float32"):
        return common.compare_answers(self, precision)

    @torch.no_grad()
    def work(self, run) -> None:
        """The least work of the kernels a step and the step's FLOPs
        (`costs/flops.py`): one eager denoiser step of the program on the
        first traced call's batch, built as `sample_stacked` builds it."""
        from pharmaforge_tpu_torch.data.batch import (concat_batches,
                                                      tile_pocket)
        from pharmaforge_tpu_torch.training.sampling import probe_pp_k_out
        from portbench.costs import flops
        ids, sizes, seed, _ = self.done[run.traced[0][0]]
        model = self.model
        c = sizes.shape[1]
        batch = concat_batches([
            tile_pocket(self.pool[j]["prot_x"], self.pool[j]["prot_h"],
                        list(s), max_prot=self.mix["prot_slots"])
            for j, s in zip(ids, sizes)])
        pm = batch.prot_mask[::c][..., None]
        coms = ((batch.prot_x[::c] * pm).sum(1) / pm.sum(1)).astype(
            np.float32)
        k_out = probe_pp_k_out(model, batch.prot_x[::c],
                               batch.prot_mask[::c])
        chain = model.chain_setup(
            batch, torch.Generator(device=run.device).manual_seed(seed),
            np.repeat(coms, c, axis=0), pocket_group_size=c, pp_k_out=k_out)
        run.work, notes = flops.count_step(lambda: model.chain_step(chain),
                                           run.peaks, common.bound)
        run.work["notes"] = notes
