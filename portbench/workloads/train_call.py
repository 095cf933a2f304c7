"""A training job: `Trainer.train_call` on `steps_per_call` batches of
`batch_size` a call, the batches from the port's loader
(`data/dataset.py::pack_batch` with its native packer, through
`data/prefetch.py`) over a processed synthetic set written into TMPDIR.

Set-up makes the trainer's first call of the window's shape on the first
batches of the feed: it captures the call's graph and replays it, as
every call of the window does. The comparison keeps what that call gave:
each step's loss, Adam's first moment after the call and the weights
after it. The window's calls take the feed as it comes, epoch after
epoch.

Mix keys: batch_size, steps_per_call, train_split_samples (two train
splits of that many), val_samples, pocket_atoms [lo, hi], centres
[lo, hi] (before the dataset's subsampling), sites [lo, hi],
trace_calls."""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from portbench import traffic
from portbench.reference import chain as rc
from portbench.reference import loader as rl
from portbench.workloads import common

FAULTS = ("half_batch", "stale_batches")


class Workload:
    def __init__(self, run):
        self.run = run
        self.config = run.cell.config
        self.mix = run.cell.traffic
        self.tmp = None
        self.batches_seen: List[object] = []
        # the trainer's seed: each epoch's batch order (`Trainer.fit`)
        self.loader_seed = int(traffic.derive(run.seed, 7) % 2 ** 31)

    def trainer_config(self, data_dir: Path) -> dict:
        t = self.config["training"]
        return {
            "training": {"batch_size": self.mix["batch_size"],
                         "steps_per_call": self.mix["steps_per_call"],
                         "trainer_args": {"max_epochs": 1},
                         "evaluation": {"sample_interval": 0,
                                        "val_loss_interval": 0}},
            "lr_scheduler": {"base_lr": t["base_lr"],
                             "weight_decay": t["weight_decay"]},
            "checkpointing": {"save_last": False, "save_top_k": 0},
            "wandb": {"mode": "disabled"},
            "dataset": {**self.config["dataset"],
                        "processed_data_dir": str(data_dir),
                        "raw_data_dir": ""},
        }

    def setup(self) -> None:
        from pharmaforge_tpu_torch.data.datamodule import \
            CrossdockedDataModule
        from pharmaforge_tpu_torch.training.logging import NullLogger
        from pharmaforge_tpu_torch.training.optim import Adam
        from pharmaforge_tpu_torch.training.trainer import Trainer
        run, mix = self.run, self.mix
        dev = run.device
        self.tmp = Path(tempfile.mkdtemp(prefix="portbench-train-"))
        with run.spans.span("setup.data"):
            n = mix["train_split_samples"]
            self.data_dir = traffic.write_processed(
                self.tmp / "data", traffic.rng(run.seed, 2),
                [n, n, mix["val_samples"]], mix["pocket_atoms"],
                mix["centres"], mix["sites"],
                common.n_elements(self.config),
                common.n_ph_types(self.config))
        with run.spans.span("setup.model"):
            self.weights = common.make_weights(self.config, run.seed, dev)
            self.model = common.program_model(self.config, self.weights, dev,
                                              "training")
            config = self.trainer_config(self.data_dir)
            trainer = Trainer(config, self.tmp / "run", logger=NullLogger(),
                              seed=self.loader_seed, device=dev)
            t = self.config["training"]
            trainer.model = self.model
            trainer.optimizer = Adam(self.model.parameters(), t["base_lr"],
                                     t["weight_decay"])
            self.gen_seed = traffic.derive(run.seed, 8)
            trainer.generator = torch.Generator(device=dev).manual_seed(
                self.gen_seed)
            self.trainer = trainer
            self.dm = CrossdockedDataModule(config["dataset"],
                                            mix["batch_size"],
                                            validation_splits=[2])
            self.dm.setup("fit")
            self.feed = self.batches()
        # the first call of the window's shape, and what the comparison
        # keeps of it
        with run.spans.span("setup.first_call"):
            names = [n for n, _ in self.model.named_parameters()]
            out = self.call(-1)
            self.first_losses = [row["train total loss"] for row in out]
            state = trainer.optimizer.opt.state
            self.moment = {n: state[p]["exp_avg"].detach().clone()
                           for n, p in zip(names, trainer.optimizer.params)}
            self.after = {n: p.detach().clone()
                          for n, p in self.model.named_parameters()}

    def batches(self):
        """The feed: the loader's padded batches, epoch after epoch, each
        epoch's order from the trainer's seed plus the epoch (as
        `Trainer.fit` draws it)."""
        from pharmaforge_tpu_torch.data.batch import pad_batch_to_multiple
        from pharmaforge_tpu_torch.data.prefetch import prefetch
        epoch = 0
        while True:
            loader = self.dm.train_dataloader(seed=self.trainer.seed + epoch)
            for batch in prefetch(loader):
                yield pad_batch_to_multiple(batch, self.mix["batch_size"])[0]
            epoch += 1

    def call(self, i: int) -> List[dict]:
        """Call i of the window (-1: set-up's): its steps' metrics."""
        with self.run.spans.span("loader_wait"):
            batch = [next(self.feed)
                     for _ in range(self.mix["steps_per_call"])]
        if self.run.args.trace and 0 <= i < self.mix["trace_calls"]:
            self.batches_seen.extend(batch)
        with self.run.spans.span("train_call"):
            return self.trainer.train_call(batch)

    def step(self, i: int) -> int:
        return len(self.call(i))

    def free(self) -> None:
        self.feed.close()
        self.trainer = self.model = self.dm = None

    def close(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)

    # -------------------------------------------------------- comparison

    def reference_steps(self, precision: str = "float32",
                        fault: str = None) -> Dict[str, object]:
        """The reference's steps of the first call from the same weights,
        its batches re-derived from the raw files and draws from a
        generator seeded as the trainer's: each step's loss, the first
        step's gradient as Adam gets it, Adam's first moment and the
        weights after the call. `fault` plants one of the faults the
        comparison must catch (`FAULTS`): "half_batch", the loss of the
        first half of each batch; "stale_batches", every step on the
        call's first batch."""
        dev, mix = self.run.device, self.mix
        cfg = common.reference_config(self.config)
        ds = self.config["dataset"]
        data = rl.Complexes(self.data_dir, [0, 1])
        feed = rl.batches(data, mix["batch_size"], self.loader_seed,
                          ds["subsample_min"], ds["subsample_max"],
                          common.n_ph_types(self.config),
                          common.n_elements(self.config))
        call = [next(feed) for _ in range(mix["steps_per_call"])]
        if fault == "stale_batches":
            call = [call[0]] * len(call)
        t = self.config["training"]
        with common.matmul_precision(precision):
            model = common.reference_model(self.config, self.weights, dev,
                                           precision)
            params = dict(model.named_parameters())
            adam = rc.Adam(params.values(), t["base_lr"], t["weight_decay"])
            gen = torch.Generator(device=dev).manual_seed(self.gen_seed)
            losses, first = [], None
            for j, raw in enumerate(call):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in raw.items()}
                if fault == "half_batch":
                    half = batch["pharm_mask"].shape[0] // 2
                    batch = {k: v[:half] for k, v in batch.items()}
                total = rc.loss(model, cfg, batch, gen)
                grads = torch.autograd.grad(total, list(params.values()))
                losses.append(float(total.detach()))
                if j == 0:
                    first = {n: g + t["weight_decay"] * p.detach()
                             for (n, p), g in zip(params.items(), grads)}
                adam.step(grads)
        return {"losses": losses, "first_grad": first,
                "moment": dict(zip(params, adam.m)),
                "after": {n: p.detach() for n, p in params.items()}}

    def program_steps(self) -> Dict[str, object]:
        return {"losses": list(self.first_losses), "moment": self.moment,
                "after": self.after}

    def compare(self, precision: str = "float32", fault: str = None):
        return training_gaps(self.program_steps(),
                             self.reference_steps(precision, fault),
                             self.weights)

    def work(self, run) -> None:
        """The least work of the kernels a step and the step's FLOPs
        (`costs/flops.py`): one eager forward and backward of the
        program's loss on the first traced batch (no update)."""
        from portbench.costs import flops
        model = self.model
        batch = self.batches_seen[0]
        gen = torch.Generator(device=run.device).manual_seed(0)

        def step():
            model.loss(batch, gen, train=True)[0].backward()

        run.work, notes = flops.count_step(step, run.peaks, common.bound)
        run.work["notes"] = notes
        model.zero_grad(set_to_none=True)


def training_gaps(prog: dict, ref: dict, weights: dict) -> Dict[str, float]:
    """The numbers compared, over the steps of one call: the widest
    relative gap of the step losses; of Adam's first moment after the
    call (each step's gradient as the optimizer got it, weighted by
    0.9 ** steps since) and of the weights' change over the call, each
    leaf's gap between the two norms over the larger of the reference's
    norm of that leaf and of the median leaf. Leaves whose first reference
    gradient is under a thousandth of the median leaf's (nought to
    rounding: Adam moves them by round-off alone) are left out of the
    change."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"], strict=True))
    names = list(ref["moment"])

    def norms(d):
        return np.array([float(torch.linalg.vector_norm(d[n].float()))
                         for n in names])

    def gap(p, r):
        return float(np.max(np.abs(p - r) / np.maximum(r, np.median(r))))

    g_r = norms(ref["first_grad"])
    moved = g_r >= 1e-3 * np.median(g_r)
    d_p = norms({n: prog["after"][n] - weights[n] for n in names})
    d_r = norms({n: ref["after"][n] - weights[n] for n in names})
    return {"loss_gap": float(loss_gap),
            "moment_gap": gap(norms(prog["moment"]), norms(ref["moment"])),
            "change_gap": gap(d_p[moved], d_r[moved])}
