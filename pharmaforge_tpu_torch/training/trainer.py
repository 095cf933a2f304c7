"""The training loop.

Port of `pharmaforge_tpu/training/trainer.py` (`Trainer.fit` :249-422),
the replacement for PyTorch Lightning's loop (reference train.py:126-153;
pharmacodiff.py:245-318), on one device:

* an epoch loop with fractional-epoch validation (`val_loss_interval`)
  and ReduceLROnPlateau on 'val total loss';
* train-time generative evaluation every `sample_interval` epochs
  (pharmacodiff.py:281-284, 320-357): pharmacophores sampled for random
  validation pockets through `PocketSampler`, scored by `SampleAnalyzer`;
* Adam with L2 weight decay, optional clip, gradient accumulation
  (`accumulate_grad_batches`), the learning rate set per step;
* save-last and save-top-k each epoch, and resume from a checkpoint;
* metrics under the reference's names in `<run_dir>/metrics.jsonl`, and a
  per-step progress line on stderr.

It runs on CUDA unless given another device, and raises without CUDA when
none is named. Inside a process group (`parallel/mesh.py`) it trains data
parallel with the JAX trainer's rank discipline (trainer.py:34-45,
151-162, 348-380, 440-475): every rank loads the same global batches and
keeps its rows, the gradients and validation sums are summed over the
ranks, and rank 0 alone writes metrics, progress lines and checkpoints;
the sampling evaluation runs on every rank. The JAX trainer's
transient-retry code has no counterpart here.

`training.steps_per_call` = K runs the JAX trainer's chunk path
(trainer.py:344-393): the batches of an epoch are grouped by padded
shape, every K of one shape run as one `multi_train_step` call at one
learning rate, and the leftovers of each shape run singly at the epoch's
end. The per-step bookkeeping (metrics, progress, the fractional-epoch
validation with its plateau cut, train-time sampling) runs for each step
after its call, on the state after the call, so a cut takes effect at the
next call. On the card every call replays a CUDA graph of its steps, and
every validation batch a graph of its forward (one per padded shape); on
the CPU and under a gloo process group both run eagerly
(`train_state.captured`; the fit prints which). A validation's metrics
stay on the device until its last batch and come to the host in one
copy. All randomness
(diffusion noise, dropout, sampling) comes from one `torch.Generator` on
the device, seeded with `seed`, drawn alike on every rank, and kept in
the checkpoint.

Spans (`utils/trace.py`): each `train_call` is one root span
"trainer.call" holding "trainer.stack" (the batches cut to this rank's
rows and stacked) and the train step's spans
(`train_state.multi_train_step`); each `validate` one root span
"trainer.validate"; the loader's prefetcher adds "loader.wait" where the
loop waits for a batch (`data/prefetch.py`).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from pharmaforge_tpu_torch import resolve_device
from pharmaforge_tpu_torch.analysis.metrics import SampleAnalyzer
from pharmaforge_tpu_torch.data.batch import (
    bucket_size,
    pad_batch_to_multiple,
    stack_batches,
)
from pharmaforge_tpu_torch.data.datamodule import CrossdockedDataModule
from pharmaforge_tpu_torch.data.prefetch import prefetch
from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
from pharmaforge_tpu_torch.parallel.mesh import (
    broadcast_module,
    is_main,
    local_batch,
    world,
)
from pharmaforge_tpu_torch.training.checkpoints import RunCheckpointer
from pharmaforge_tpu_torch.training.logging import MetricsLogger, NullLogger
from pharmaforge_tpu_torch.training.optim import Adam, ReduceLROnPlateau
from pharmaforge_tpu_torch.training.sampling import PocketSampler
from pharmaforge_tpu_torch.training.train_state import (
    eval_metrics,
    multi_train_step,
    step_mode,
)
from pharmaforge_tpu_torch.utils import trace


class Trainer:

    def __init__(self, config: dict, run_dir: Path,
                 logger: Optional[MetricsLogger] = None, debug: bool = False,
                 seed: int = 0, device=None):
        self.run_dir = Path(run_dir)
        self.debug = debug
        self.seed = seed
        self.device = resolve_device(device)

        tr = config["training"]
        targs = tr.get("trainer_args", {})
        self.batch_size = tr["batch_size"]
        self.max_epochs = targs.get("max_epochs", 10)
        self.accumulate = targs.get("accumulate_grad_batches", 1) or 1
        self.limit_train_batches = 100 if debug else None
        # optimizer steps a call (JAX trainer.py:122-125)
        self.steps_per_call = tr.get("steps_per_call", 1) or 1
        # PL semantics: float = fraction of the val loader, int = batches
        self.limit_val_batches = targs.get("limit_val_batches", 1.0)
        ev = tr.get("evaluation", {})
        self.sample_interval = ev.get("sample_interval", 1.0)
        self.val_loss_interval = ev.get("val_loss_interval", 1.0)
        self.pharms_per_pocket = ev.get("pharms_per_pocket", 2)
        self.n_pockets_to_sample = ev.get("n_pockets", 8)

        lrs = config.get("lr_scheduler", {})
        self.base_lr = float(lrs.get("base_lr", 1e-3))
        self.weight_decay = float(lrs.get("weight_decay", 0.0))
        self.clip_value = tr.get("clip_value")
        self.plateau = ReduceLROnPlateau(
            **{k: v for k, v in lrs.get("reducelronplateau", {}).items()
               if k in ("mode", "factor", "patience", "min_lr", "verbose")})

        # rank 0 owns every file and printed line
        self.is_main = is_main()
        self.logger = logger or (
            MetricsLogger(self.run_dir, config.get("wandb")) if self.is_main
            else NullLogger())
        self.checkpointer = RunCheckpointer(self.run_dir,
                                            **config.get("checkpointing", {}))
        self.model: Optional[PharmacophoreDiffusion] = None
        self.optimizer: Optional[Adam] = None
        self.generator: Optional[torch.Generator] = None
        self._sampler: Optional[PocketSampler] = None
        self.lr = self.base_lr
        self.global_step = 0
        self.epoch = 0
        self.last_sample_marker = 0.0
        self.last_val_marker = 0.0
        self.progress_refresh = 1 if debug else int(
            tr.get("progress_refresh", 20))
        self._progress_width = 0
        self._progress_live = False

    # ----------------------------------------------------------- progress

    def _progress(self, batch_idx: int, n_batches: int, metrics: dict):
        """Per-step progress line on stderr: in place on a tty, plain
        lines otherwise, every `progress_refresh` steps."""
        r = self.progress_refresh
        if not self.is_main or not r or (batch_idx % r
                                         and batch_idx != n_batches - 1):
            return
        loss = metrics.get("train total loss", float("nan"))
        msg = (f"epoch {self.epoch} [{batch_idx + 1}/{n_batches}] "
               f"train total loss {loss:.4f} lr {self.lr:.2e}")
        if sys.stderr.isatty():
            self._progress_width = max(self._progress_width, len(msg))
            print("\r" + msg.ljust(self._progress_width), end="",
                  file=sys.stderr, flush=True)
            self._progress_live = True
        else:
            print(msg, file=sys.stderr, flush=True)

    def _progress_close(self):
        """Finish an in-place progress line before other prints."""
        if self._progress_live:
            print(file=sys.stderr, flush=True)
            self._progress_live = False

    # ----------------------------------------------------------------- fit

    def train_call(self, batches: list) -> List[Dict[str, float]]:
        """One call of len(`batches`) optimizer steps of `self.model` at
        the current learning rate, on padded global batches of one shape
        (this rank's rows of each in a process group); each step's
        metrics."""
        with trace.span("trainer.call"):
            with trace.span("trainer.stack"):
                local = [local_batch(b) for b in batches]
                stacked = stack_batches([b for b, _ in local])
            out = multi_train_step(self.model, self.optimizer, stacked,
                                   self.generator, self.lr, local[0][1])
            return [{k: float(v[j]) for k, v in out.items()}
                    for j in range(len(batches))]

    def fit(self, model: PharmacophoreDiffusion,
            datamodule: CrossdockedDataModule,
            resume_from: Optional[str] = None) -> PharmacophoreDiffusion:
        """Train `model` (moved to the trainer's device) on `datamodule`
        for `max_epochs`; `resume_from` ('last', 'best' or a checkpoint
        directory) restores weights, optimizer, generator and counters."""
        self.model = model.to(self.device)
        datamodule.setup("fit")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.optimizer = Adam(model.parameters(), self.base_lr,
                              self.weight_decay, self.clip_value,
                              self.accumulate)
        if resume_from is not None:
            state, meta = self.checkpointer.restore(resume_from)
            model.load_state_dict(state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
            self.generator.set_state(state["rng"])
            self.global_step = meta["step"]
            self.epoch = meta.get("epoch", 0)
            self.lr = meta.get("lr", self.base_lr)
            self.last_sample_marker = meta.get("last_sample_marker", 0.0)
            self.plateau.load_state_dict(meta.get("plateau", {}))
        # every rank starts from rank 0's weights
        broadcast_module(model)

        n_params = sum(p.numel() for p in model.parameters())
        if self.is_main:
            print(f"training on {self.device} | {n_params:,} params | "
                  f"batch {self.batch_size} | {self.max_epochs} epochs"
                  + (f" | {world()} ranks" if world() > 1 else ""))
            print(f"train steps: {self.steps_per_call} a call, "
                  f"{step_mode(self.device)}; validation batches "
                  f"likewise")

        while self.epoch < self.max_epochs:
            loader = datamodule.train_dataloader(seed=self.seed + self.epoch)
            n_batches = len(loader)
            if self.limit_train_batches:
                n_batches = min(n_batches, self.limit_train_batches)
            epoch_t0 = time.time()
            epoch_metrics: Dict[str, list] = {}

            def run_call(entries):
                """One call over [(batch_idx, batch)] of one shape, then
                each step's bookkeeping on the state after the call."""
                rows = self.train_call([b for _, b in entries])
                for (batch_idx, _), aux in zip(entries, rows):
                    self._after_step(batch_idx, n_batches, aux,
                                     epoch_metrics, datamodule)

            pending: Dict[tuple, list] = {}   # padded shape -> entries
            for batch_idx, batch in enumerate(prefetch(loader)):
                if batch_idx >= n_batches:
                    break
                # partial batches pad to the full size: one shape a bucket
                batch, _ = pad_batch_to_multiple(batch, self.batch_size)
                shape = batch.prot_x.shape
                entries = pending.setdefault(shape, [])
                entries.append((batch_idx, batch))
                if len(entries) == self.steps_per_call:
                    run_call(pending.pop(shape))
            # the leftovers of each shape, one step a call
            for entries in pending.values():
                for entry in entries:
                    run_call([entry])

            # end of epoch: validation, epoch means, schedule, checkpoint
            val_metrics = self.validate(datamodule)
            epoch_means = {f"{k} epoch": float(np.mean(v))
                           for k, v in epoch_metrics.items()
                           if k.startswith("train")}
            self.logger.log({**val_metrics, **epoch_means},
                            step=self.global_step)
            self.lr = self.plateau.step(val_metrics["val total loss"],
                                        self.lr)
            self.epoch += 1
            self._progress_close()
            secs = time.time() - epoch_t0
            train_loss = np.mean(epoch_metrics.get("train total loss", [0.0]))
            if self.is_main:
                print(f"epoch {self.epoch}/{self.max_epochs} train total "
                      f"loss {train_loss:.4f} val total loss "
                      f"{val_metrics['val total loss']:.4f} "
                      f"({n_batches / secs if secs > 0 else 0.0:.2f} "
                      f"steps/s)")
            self.save_checkpoint(val_metrics["val total loss"])
        return model

    def _after_step(self, batch_idx: int, n_batches: int, aux: dict,
                    epoch_metrics: dict, datamodule) -> None:
        """Per-step bookkeeping: metrics, progress, and the fractional-
        epoch cadence of train-time sampling and validation (JAX
        trainer.py:307-344). It runs after the step's call, so the cadence
        reads the state after the call: with K steps a call it fires at
        call boundaries."""
        epoch_exact = self.epoch + batch_idx / max(n_batches, 1)
        self.global_step += 1
        metrics = dict(aux, lr=self.lr, epoch_exact=epoch_exact)
        for k, v in metrics.items():
            epoch_metrics.setdefault(k, []).append(v)
        self.logger.log(metrics, step=self.global_step)
        self._progress(batch_idx, n_batches, metrics)
        if (self.sample_interval > 0
                and epoch_exact - self.last_sample_marker
                >= self.sample_interval):
            self.last_sample_marker = epoch_exact
            self.logger.log(self.sample_and_analyze(datamodule.val_dataset),
                            step=self.global_step)
        if epoch_exact - self.last_val_marker >= self.val_loss_interval:
            self.last_val_marker = epoch_exact
            val_metrics = self.validate(datamodule)
            self.logger.log(val_metrics, step=self.global_step)
            self.lr = self.plateau.step(val_metrics["val total loss"],
                                        self.lr)

    # ------------------------------------------------------------ validate

    def val_batch_count(self, loader) -> int:
        """The validation batches taken from `loader`:
        `limit_val_batches` as a fraction of them (at least one unless 0)
        or as a count (PL's semantics)."""
        n_batches = len(loader)
        limit = self.limit_val_batches
        if isinstance(limit, float):
            return max(int(n_batches * limit), 1) if limit > 0 else 0
        if limit is not None:
            return min(n_batches, int(limit))
        return n_batches

    def validate(self, datamodule) -> Dict[str, float]:
        """Validation metrics averaged over the (limited) val loader,
        weighted by each batch's real size; in a process group each batch's
        metrics are the global batch's (summed over the ranks). Batch i's
        metrics go into row i of a device buffer, which comes to the host
        in one copy after the last batch; the weighted sums are then formed
        in batch order in Python floats."""
        with trace.span("trainer.validate"):
            return self._validate(datamodule)

    def _validate(self, datamodule) -> Dict[str, float]:
        loader = datamodule.val_dataloader(seed=self.seed)
        n_batches = self.val_batch_count(loader)
        names, stack, sizes = [], None, []
        for batch_idx, batch in enumerate(prefetch(loader)):
            if batch_idx >= n_batches:
                break
            batch, bs = pad_batch_to_multiple(batch, self.batch_size)
            batch, rows = local_batch(batch)
            names, out = eval_metrics(self.model, batch, self.generator,
                                      rows)
            if stack is None:
                stack = out.new_empty((n_batches, len(names)))
            stack[batch_idx].copy_(out)
            sizes.append(bs)
        sums: Dict[str, float] = {}
        per_batch = stack[:len(sizes)].tolist() if sizes else []
        for bs, vals in zip(sizes, per_batch):
            for k, v in zip(names, vals):
                sums[k] = sums.get(k, 0.0) + v * bs
        weights = float(sum(sizes))
        return {k: v / max(weights, 1) for k, v in sums.items()}

    # -------------------------------------------------- sample_and_analyze

    def sample_and_analyze(self, val_dataset) -> dict:
        """Sample pharmacophores for random validation pockets, each at its
        own pharmacophore's size, and score their validity (reference
        pharmacodiff.py:320-357)."""
        n_pockets = min(self.n_pockets_to_sample, len(val_dataset))
        idxs = np.random.default_rng(int(self.global_step)).integers(
            0, len(val_dataset), size=n_pockets)
        pockets = [val_dataset[int(i)] for i in idxs]
        n_pharms = [[len(p["pharm_x"])] * self.pharms_per_pocket
                    for p in pockets]
        init_coms = np.stack([p["pharm_x"].mean(axis=0) for p in pockets])
        if self._sampler is None:
            # every pocket padded to the dataset-wide slot count
            sizes = val_dataset.prot_idx[:, 1] - val_dataset.prot_idx[:, 0]
            self._sampler = PocketSampler(
                self.model, fixed_prot_slots=bucket_size(int(sizes.max())),
                device=self.device)
        per_pocket = self._sampler.sample(pockets, n_pharms, self.generator,
                                          max_batch_size=64,
                                          init_pharm_com=init_coms)
        flat = [ph for pocket_phs in per_pocket for ph in pocket_phs]
        try:
            return SampleAnalyzer().analyze(flat)
        except ValueError:
            return {}

    # ----------------------------------------------------------- checkpoint

    def save_checkpoint(self, monitored: float) -> None:
        if not self.is_main:
            return
        state = {
            "model": {k: v.detach().cpu()
                      for k, v in self.model.state_dict().items()},
            "optimizer": self.optimizer.state_dict(),
            "rng": self.generator.get_state(),
        }
        meta = {
            "step": int(self.global_step),
            "epoch": int(self.epoch),
            "lr": float(self.lr),
            "last_sample_marker": float(self.last_sample_marker),
            "plateau": self.plateau.state_dict(),
            "monitored": float(monitored),
        }
        self.checkpointer.save(state, meta, metric=monitored)
