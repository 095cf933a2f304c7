"""Train and validation steps.

Port of `pharmaforge_tpu/training/train_state.py`. `multi_train_step` is
the counterpart of `make_multi_train_step` (:70-107, a `lax.scan`): K
optimizer steps as one call, each differentiating the masked diffusion
loss and applying (or, with gradient accumulation, accumulating) the Adam
update at the call's one learning rate, and the K steps' metrics back in
one device-to-host copy. `train_step` is a call of one step; `eval_step`
(the counterpart of `make_eval_step`, :110-117) computes one validation
batch's metrics with dropout off and no gradient.

On the card a call is one replay of a CUDA graph of its K steps
(`TrainGraphs`: forward, the kernels K1 and K2, the backward with K3 and
the Adam update all captured), kept per signature on the optimizer, and a
validation batch one replay of a graph of its forward (`EvalGraphs`, K1
and K2 captured), kept per signature on the model; what the two runners
share with the chain's is `utils/graphs.py`. On the CPU, and under a
gloo process group (whose all-reduce a graph cannot hold), the same work
runs eagerly; `captured` decides, and `step_mode` says which in words.

Spans (`utils/trace.py`), inside the trainer's "trainer.call": a call's
"train.graphs" (the signature lookup, with "train.capture" inside where a
graph is captured), "train.load" (the batches' copy into the graph's
inputs), "train.replay" (the replay's enqueue; "train.eager" for the
eager steps) and "train.fetch" (the metrics' copy to the host, which
waits for the device); a validation batch's "eval.capture" where its
graph is captured. Each runner counts its captures and replays in the
registry: "train.captures", "train.replays", "train.replayed.<kernel>"
and the same under "eval.".

Under data parallelism (`rows`, see `PharmacophoreDiffusion.loss`) each
rank differentiates its share of the global loss and the gradients are
summed over the ranks before the update, so every rank applies the
global batch's update to identical parameters.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pharmaforge_tpu_torch.data.batch import (
    PharmComplexBatch,
    stack_batches,
    unstack_batch,
)
from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
from pharmaforge_tpu_torch.parallel.mesh import all_reduce_grads
from pharmaforge_tpu_torch.training.optim import Adam
from pharmaforge_tpu_torch.utils import graphs, trace


def captured(device) -> bool:
    """Whether train steps and validation batches on `device` run as CUDA
    graph replays: on CUDA without a process group or in an NCCL one (a
    gloo all-reduce cannot be captured)."""
    if torch.device(device).type != "cuda":
        return False
    return not dist.is_initialized() or dist.get_backend() == "nccl"


def step_mode(device) -> str:
    """`captured`'s decision for `device`, in words."""
    if captured(device):
        return "captured (each call one CUDA graph replay)"
    if torch.device(device).type != "cuda":
        return f"eager (on {torch.device(device).type})"
    return (f"eager (a {dist.get_backend()} process group: its all-reduce "
            f"cannot be captured)")


def _one_step(model: PharmacophoreDiffusion, optimizer: Adam,
              batch: PharmComplexBatch, generator: torch.Generator,
              rows: Optional[Tuple[int, int]],
              noise: Optional[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """One optimizer step at the optimizer's current rate; its metrics as
    device scalars."""
    optimizer.zero_grad()
    total, aux = model.loss(batch, generator, train=True, phase="train",
                            noise=noise, rows=rows)
    total.backward()
    if rows is not None:
        all_reduce_grads(list(model.parameters()))
    optimizer.step()
    return aux


def _vector(aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([v.detach().float() for v in aux.values()])


def multi_train_step(model: PharmacophoreDiffusion, optimizer: Adam,
                     batches: PharmComplexBatch, generator: torch.Generator,
                     lr: float, rows: Optional[Tuple[int, int]] = None,
                     noise: Optional[Sequence[Dict[str, Any]]] = None
                     ) -> Dict[str, np.ndarray]:
    """K optimizer steps on `batches` (K same-shape batches stacked on a
    leading axis, `data.batch.stack_batches`), all at rate `lr`, drawing
    dropout and diffusion noise from `generator` in order. `noise`, where
    given, is K dicts of injected draws (`loss`'s), taken by the eager
    steps only (the graphs draw from `generator`). Returns each metric
    as a [K] array, in one device-to-host copy. With `rows` (this rank's
    slice of each global batch) the gradients are summed over the ranks
    before each update.

    On the card the K steps replay a CUDA graph (`TrainGraphs`), captured
    at the first call of each signature (shapes, K, the accumulation
    phase, `rows`, the model and the generator) and kept on `optimizer`
    with every other signature's until a weight or an optimizer tensor
    moves to new storage; a capture that fails raises. Elsewhere
    (`captured`) they run eagerly."""
    k = batches.pharm_x.shape[0]
    if noise is not None and len(noise) != k:
        raise ValueError(f"{len(noise)} noise dicts for {k} steps")
    optimizer.set_lr(lr)
    if captured(model.device):
        if noise is not None:
            raise ValueError("injected draws: the captured steps draw from "
                             "the generator (eager_train_steps takes them)")
        with trace.span("train.graphs"):
            runner = optimizer.train_graphs.get(
                (graphs.spec(batches), optimizer.mini_step, rows, id(model),
                 id(generator)), _state_tensors(model, optimizer),
                lambda pool: TrainGraphs(model, optimizer, generator,
                                         batches, rows, pool))
        with trace.span("train.load"):
            runner.load(batches)
        with trace.span("train.replay"):
            names, out = runner.names, runner.run()
    else:
        with trace.span("train.eager"):
            names, out = eager_train_steps(model, optimizer, batches,
                                           generator, rows, noise)
    with trace.span("train.fetch"):
        vals = out.to("cpu", copy=True).numpy()
    return {name: vals[:, i] for i, name in enumerate(names)}


def eager_train_steps(model: PharmacophoreDiffusion, optimizer: Adam,
                      batches: PharmComplexBatch,
                      generator: torch.Generator,
                      rows: Optional[Tuple[int, int]] = None,
                      noise: Optional[Sequence[Dict[str, Any]]] = None
                      ) -> Tuple[List[str], torch.Tensor]:
    """`multi_train_step`'s K steps run eagerly at the optimizer's current
    rate, on any device: (metric names, their values [K, metrics] on the
    device). The path of the CPU and of gloo ranks; on the card, what a
    captured call is held against."""
    k = batches.pharm_x.shape[0]
    noise = [None] * k if noise is None else list(noise)
    per_step = [_one_step(model, optimizer, unstack_batch(batches, j),
                          generator, rows, noise[j]) for j in range(k)]
    return list(per_step[0]), torch.stack([_vector(a) for a in per_step])


def train_step(model: PharmacophoreDiffusion, optimizer: Adam,
               batch: PharmComplexBatch, generator: torch.Generator,
               lr: float, rows: Optional[Tuple[int, int]] = None,
               noise: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
    """One optimizer step (one micro-batch under accumulation): a
    `multi_train_step` call of one step. Returns the metrics as floats."""
    out = multi_train_step(model, optimizer, stack_batches([batch]),
                           generator, lr, rows,
                           None if noise is None else [noise])
    return {k: float(v[0]) for k, v in out.items()}


def eval_step(model: PharmacophoreDiffusion, batch: PharmComplexBatch,
              generator: torch.Generator,
              rows: Optional[Tuple[int, int]] = None) -> Dict[str, float]:
    """Validation metrics: dropout off, fresh diffusion noise; the global
    batch's with `rows`. Returns them as floats."""
    names, out = eval_metrics(model, batch, generator, rows)
    return dict(zip(names, out.tolist()))


def eval_metrics(model: PharmacophoreDiffusion, batch: PharmComplexBatch,
                 generator: torch.Generator,
                 rows: Optional[Tuple[int, int]] = None
                 ) -> Tuple[List[str], torch.Tensor]:
    """`eval_step`'s metrics left on the device: (names, values [M]).

    On the card the batch replays a CUDA graph (`EvalGraphs`), captured at
    the first call of its signature (every field's shape and dtype,
    `rows`, the model and the generator) and kept on the model, apart from
    the train graphs, with every other signature's until a weight or
    buffer moves to new storage; the values are the graph's output, which
    its next replay overwrites. A capture that fails raises. Elsewhere
    (`captured`) the forward runs eagerly."""
    if captured(model.device):
        runner = model._eval_graphs.get(
            (graphs.spec(batch), rows, id(model), id(generator)),
            (*model.parameters(), *model.buffers()),
            lambda pool: EvalGraphs(model, generator, batch, rows, pool))
        runner.load(batch)
        return runner.names, runner.run()
    return eager_eval(model, batch, generator, rows)


@torch.no_grad()
def eager_eval(model: PharmacophoreDiffusion, batch: PharmComplexBatch,
               generator: torch.Generator,
               rows: Optional[Tuple[int, int]] = None
               ) -> Tuple[List[str], torch.Tensor]:
    """One validation batch's forward run eagerly, on any device: (metric
    names, their values [M] on the device). The path of the CPU and of
    gloo ranks; on the card, what a replay is held against."""
    _, aux = model.loss(batch, generator, train=False, phase="val",
                        rows=rows)
    return list(aux), _vector(aux)


# ------------------------------------------------------------ the runner

def _state_tensors(model: PharmacophoreDiffusion,
                   optimizer: Adam) -> List[torch.Tensor]:
    """Every tensor a train step reads and writes in place: the weights and
    buffers, Adam's moments and step counts, the accumulation buffers and
    the learning rate."""
    opt_state = [t for p in optimizer.params
                 for t in optimizer.opt.state[p].values()]
    lr = [optimizer.lr] if torch.is_tensor(optimizer.lr) else []
    return [*model.parameters(), *model.buffers(), *opt_state,
            *optimizer._acc, *lr]


class TrainGraphs:
    """K train steps as one CUDA graph: the counterpart of the JAX
    package's scanned multi-step call.

    The graph reads the call's K batches from input tensors of its own,
    which `load` fills before each replay, and writes the K steps'
    metrics into `out` [K, metrics]. It updates the model's
    weights, Adam's state and the accumulation buffers in place, reads the
    learning rate from the optimizer's device tensor, and draws dropout
    and diffusion noise from `generator`, registered with the graph, so a
    replay advances it as K eager steps do. Python state the steps change
    runs once, at capture: `run` replays its effect (the accumulation
    phase `mini_step`; the kernel counters, re-counted as captured
    launches x replays under "train.replayed.<kernel>").

    The warm-up step (`utils/graphs.py`) is undone: the weights, Adam's
    state, the accumulation buffers and phase and the generator restored.
    Every graph of one optimizer shares its cache's memory pool (`pool`).
    `capture_ms` is the host time of the warm-up and the capture,
    `pool_bytes` the device memory the capture reserved. Building one
    counts "train.captures" once its capture returned, inside the span
    "train.capture"."""

    def __init__(self, model: PharmacophoreDiffusion, optimizer: Adam,
                 generator: torch.Generator, batches: PharmComplexBatch,
                 rows: Optional[Tuple[int, int]], pool):
        with trace.span("train.capture"):
            self._capture(model, optimizer, generator, batches, rows, pool)
            trace.count("train.captures")

    def _capture(self, model, optimizer, generator, batches, rows,
                 pool) -> None:
        dev = model.device
        self.model, self.optimizer, self.generator = model, optimizer, \
            generator
        self.rows = rows
        self.k = batches.pharm_x.shape[0]
        self.phase = optimizer.mini_step
        self.inputs = graphs.stage(batches, dev)
        state = _state_tensors(model, optimizer)
        t0 = time.perf_counter()
        saved = ([t.detach().clone() for t in state], generator.get_state())
        self.names = list(graphs.warm_up(dev, lambda: self._step(0)))
        with torch.no_grad():
            for t, copy in zip(state, saved[0]):
                t.copy_(copy)
        generator.set_state(saved[1])
        optimizer.mini_step = self.phase
        optimizer.zero_grad()
        del saved
        self.out = torch.zeros((self.k, len(self.names)), device=dev)
        self.graph, self.counts, self.pool_bytes = graphs.capture(
            dev, self._body, pool, generator)
        optimizer.mini_step = self.phase
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _step(self, j: int) -> Dict[str, torch.Tensor]:
        """Step j of the call, on the graph's input tensors."""
        return _one_step(self.model, self.optimizer,
                         unstack_batch(self.inputs, j), self.generator,
                         self.rows, None)

    def _body(self) -> None:
        """The K steps, each writing its metrics into its row of `out`:
        what the graph holds."""
        for j in range(self.k):
            self.out[j].copy_(_vector(self._step(j)))

    def load(self, batches: PharmComplexBatch) -> None:
        """Copy a call's batches of this signature into the graph's input
        tensors."""
        graphs.load_into(self.inputs, batches)

    def run(self) -> torch.Tensor:
        """One replay: the call's K steps, enqueued on the current stream;
        returns `out`, which this graph's next replay overwrites."""
        opt = self.optimizer
        if opt.mini_step != self.phase:
            raise RuntimeError(f"train graph of phase {self.phase} replayed "
                               f"at phase {opt.mini_step}")
        self.graph.replay()
        opt.mini_step = (self.phase + self.k) % opt.accumulate
        graphs.count_replays("train", self.counts, 1)
        return self.out


# ------------------------------------------------- the validation runner

class EvalGraphs:
    """One validation batch's forward as a CUDA graph: the counterpart of
    the JAX package's jitted eval step, `TrainGraphs` less the optimizer.

    The graph reads the batch from input tensors of its own, which `load`
    fills before each replay, and writes `loss(train=False, phase="val")`'s
    metrics into `out` [M], allocated outside the graph's pool, so no
    other graph's replay touches it. It reads the model's weights and
    buffers in place, so a replay after any train call sees the current
    weights, and draws the diffusion noise from `generator`, registered
    with the graph, so a replay advances it as one eager `eager_eval`
    does. Python state that the forward changes runs once, at capture:
    `run` replays its effect (eval mode, which `loss` sets; the kernel
    counters, re-counted as captured launches x replays under
    "eval.replayed.<kernel>").

    The warm-up forward (`utils/graphs.py`) is undone: the generator
    restored. The graphs of one model share its cache's memory pool
    (`pool`). `capture_ms` is the host time of the warm-up and the capture,
    `pool_bytes` the device memory the capture reserved. Building one
    counts "eval.captures" once its capture returned, inside the span
    "eval.capture"."""

    def __init__(self, model: PharmacophoreDiffusion,
                 generator: torch.Generator, batch: PharmComplexBatch,
                 rows: Optional[Tuple[int, int]], pool):
        with trace.span("eval.capture"):
            self._capture(model, generator, batch, rows, pool)
            trace.count("eval.captures")

    def _capture(self, model, generator, batch, rows, pool) -> None:
        dev = model.device
        self.model, self.generator, self.rows = model, generator, rows
        self.inputs = graphs.stage(batch, dev)
        t0 = time.perf_counter()
        saved = generator.get_state()
        self.names, _ = graphs.warm_up(dev, lambda: eager_eval(
            model, self.inputs, generator, rows))
        generator.set_state(saved)
        self.out = torch.zeros(len(self.names), device=dev)
        self.graph, self.counts, self.pool_bytes = graphs.capture(
            dev, self._body, pool, generator)
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _body(self) -> None:
        """The forward, writing its metrics into `out`: what the graph
        holds."""
        self.out.copy_(eager_eval(self.model, self.inputs, self.generator,
                                  self.rows)[1])

    def load(self, batch: PharmComplexBatch) -> None:
        """Copy a batch of this signature into the graph's input
        tensors."""
        graphs.load_into(self.inputs, batch)

    def run(self) -> torch.Tensor:
        """One replay, enqueued on the current stream; returns `out`,
        which this graph's next replay overwrites."""
        self.graph.replay()
        self.model.train(False)
        graphs.count_replays("eval", self.counts, 1)
        return self.out
