"""Optimizer and learning-rate schedule.

Port of `pharmaforge_tpu/training/optim.py`, with the JAX trainer's
gradient accumulation (`optax.MultiSteps`) folded in. The reference
training setup (pharmacodiff.py:254-263) is Adam with L2 weight decay
added to the gradient before the moment updates (torch.optim.Adam's
`weight_decay`, not decoupled AdamW), an optional clip by value first,
and a ReduceLROnPlateau schedule on 'val total loss' that sets the
learning rate per step.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import torch


class Adam:
    """The JAX package's `optax.chain(clip(c), add_decayed_weights(wd),
    scale_by_adam(0.9, 0.999, 1e-8), scale(-lr))`, wrapped in
    `optax.MultiSteps(every_k_schedule=accumulate)` when `accumulate` > 1.

    `step(lr)` reads each parameter's `.grad`. With accumulation the
    first `accumulate` - 1 calls only fold the gradients into a running
    mean (`acc += (g - acc) / (n + 1)`, optax's Welford form) and leave the
    parameters alone; the k-th call clips the mean, applies the update and
    returns True.

    On CUDA the step can be captured in a CUDA graph
    (`training/train_state.py::TrainGraphs`): the inner `torch.optim.Adam`
    is `capturable` (its step counts live on the device), the learning
    rate is a 0-d device tensor that `set_lr` writes between replays, and
    the moments, step counts and accumulation buffers are made here, once,
    so a graph that reads and writes them stays valid; `load_state_dict`
    copies into them. The phase of the accumulation cycle, `mini_step`, is
    a host integer: a graph is specialised to the phase it starts at, and
    its runner advances `mini_step`. On the CPU `capturable` raises, so
    there the rate is a float and the update the non-capturable one (the
    same arithmetic up to rounding)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 weight_decay: float = 0.0, clip_value: Optional[float] = None,
                 accumulate: int = 1):
        self.params: List[torch.nn.Parameter] = [p for p in params
                                                 if p.requires_grad]
        dev = self.params[0].device if self.params else torch.device("cpu")
        self.capturable = dev.type == "cuda"
        self.lr = (torch.tensor(float(lr), device=dev) if self.capturable
                   else float(lr))
        self.opt = torch.optim.Adam(self.params, lr=self.lr,
                                    betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=weight_decay,
                                    capturable=self.capturable)
        for p in self.params:
            self.opt.state[p] = {
                "step": torch.zeros((), dtype=torch.float32,
                                    device=p.device if self.capturable
                                    else "cpu"),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}
        self.clip_value = clip_value
        self.accumulate = max(int(accumulate or 1), 1)
        self.mini_step = 0
        self._acc: List[torch.Tensor] = (
            [torch.zeros_like(p) for p in self.params]
            if self.accumulate > 1 else [])
        # the captured train steps of these parameters, by signature, and
        # the memory pool they share (training/train_state.py)
        self.train_graphs: dict = {}
        self.graph_pool = None

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def set_lr(self, lr: float) -> None:
        """The learning rate of the following updates: written into the
        device tensor a captured step reads (CUDA), or the float the
        update reads (CPU)."""
        if self.capturable:
            self.lr.fill_(float(lr))
        else:
            self.lr = float(lr)
            for group in self.opt.param_groups:
                group["lr"] = self.lr

    def step(self, lr: Optional[float] = None) -> bool:
        """Apply (or accumulate) the current gradients, at rate `lr` where
        given (else at the last rate set); True when the parameters were
        updated. Inside a CUDA graph capture pass no `lr`: the graph reads
        the rate `set_lr` writes before each replay."""
        if lr is not None:
            self.set_lr(lr)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.accumulate > 1:
            n = self.mini_step
            for a, g in zip(self._acc, grads):
                if n == 0:
                    a.zero_()
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.accumulate
            if self.mini_step:
                return False
            grads = self._acc
        for p, g in zip(self.params, grads):
            if self.clip_value is not None:
                g = torch.clamp(g, -self.clip_value, self.clip_value)
            p.grad = g
        self.opt.step()
        return True

    def state_dict(self) -> dict:
        return {"adam": self.opt.state_dict(), "mini_step": self.mini_step,
                "acc": ([a.clone() for a in self._acc] if self.mini_step
                        else None)}

    def load_state_dict(self, state: dict) -> None:
        """Restore a `state_dict` into this optimizer's own tensors (the
        ones a captured step holds); the learning rate and the settings
        stay this optimizer's (the trainer passes the rate each call)."""
        held = {p: self.opt.state[p] for p in self.params}
        groups = [{k: v for k, v in g.items() if k != "params"}
                  for g in self.opt.param_groups]
        self.opt.load_state_dict(state["adam"])
        with torch.no_grad():
            for p in self.params:
                new = self.opt.state.get(p, {})
                for k, t in held[p].items():
                    if k in new:
                        t.copy_(new[k])
                    else:
                        t.zero_()
                self.opt.state[p] = held[p]
            for group, saved in zip(self.opt.param_groups, groups):
                group.update(saved)
            self.mini_step = state.get("mini_step", 0)
            acc = state.get("acc")
            if self.mini_step and acc is not None:
                for a, b in zip(self._acc, acc):
                    a.copy_(b)


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Host-side mirror of torch.optim.lr_scheduler.ReduceLROnPlateau with
    the reference's config surface (configs/dev.yml:30-35); the JAX
    package's copy, so both step the same sequence."""

    factor: float = 0.1
    patience: int = 20
    min_lr: float = 0.0
    mode: str = "min"
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    verbose: bool = False

    best: float = None  # type: ignore[assignment]
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def is_better(self, current: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return current < self.best * (1 - self.threshold)
            return current < self.best - self.threshold
        if self.threshold_mode == "rel":
            return current > self.best * (1 + self.threshold)
        return current > self.best + self.threshold

    def step(self, metric: float, lr: float) -> float:
        """Record a monitored value; return the (possibly reduced) LR."""
        if self.is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            new_lr = max(lr * self.factor, self.min_lr)
            if self.verbose and new_lr < lr:
                print(f"ReduceLROnPlateau: reducing lr {lr:.3g} -> "
                      f"{new_lr:.3g}")
            lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return lr

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, state: dict) -> None:
        self.best = state.get("best")
        self.num_bad_epochs = state.get("num_bad_epochs", 0)
        self.cooldown_counter = state.get("cooldown_counter", 0)
