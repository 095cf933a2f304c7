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
and K2 captured), kept per signature on the model. On the CPU, and under
a gloo process group (whose all-reduce a graph cannot hold), the same
work runs eagerly; `captured` decides, and `step_mode` says which in
words.

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

import dataclasses
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
from pharmaforge_tpu_torch.models import diffusion
from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
from pharmaforge_tpu_torch.parallel.mesh import all_reduce_grads
from pharmaforge_tpu_torch.training.optim import Adam
from pharmaforge_tpu_torch.utils import trace

_FIELDS = [f.name for f in dataclasses.fields(PharmComplexBatch)]


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
    at the first call of each signature and kept on `optimizer`; a
    capture that fails raises. Elsewhere (`captured`) they run eagerly."""
    k = batches.pharm_x.shape[0]
    if noise is not None and len(noise) != k:
        raise ValueError(f"{len(noise)} noise dicts for {k} steps")
    optimizer.set_lr(lr)
    if captured(model.device):
        if noise is not None:
            raise ValueError("injected draws: the captured steps draw from "
                             "the generator (eager_train_steps takes them)")
        graphs = _graphs_for(model, optimizer, batches, generator, rows)
        with trace.span("train.load"):
            graphs.load(batches)
        with trace.span("train.replay"):
            names, out = graphs.names, graphs.run()
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
    the first call of its signature and kept on the model; the values are
    the graph's output, which its next replay overwrites. A capture that
    fails raises. Elsewhere (`captured`) the forward runs eagerly."""
    if captured(model.device):
        graphs = _eval_graphs_for(model, batch, generator, rows)
        graphs.load(batch)
        return graphs.names, graphs.run()
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


def _shapes(batch: PharmComplexBatch) -> tuple:
    """Every field's name, shape and dtype: a graph's input signature."""
    return tuple((name, np.shape(getattr(batch, name)),
                  np.asarray(getattr(batch, name)).dtype.str)
                 for name in _FIELDS)


def _warm_up(dev, fn):
    """`fn()` on a new side stream that starts after the current stream's
    work, which then waits for it: first-use work outside any graph."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    return out


def _capture(dev, generator: torch.Generator, pool, body) -> tuple:
    """`body()` captured into a new CUDA graph in memory pool `pool`, with
    `generator` registered and Python's cyclic collector paused
    (`diffusion.collector_paused`). Returns (the graph, the launches the
    capture counted, by kernel, the device memory it reserved)."""
    with diffusion.collector_paused():
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        before = diffusion.kernel_counts()
        with torch.cuda.graph(graph, pool=pool):
            body()
        after = diffusion.kernel_counts()
        torch.cuda.synchronize(dev)
        return (graph, {k: after[k] - before[k] for k in after},
                torch.cuda.memory_reserved(dev) - reserved)


def _graphs_for(model: PharmacophoreDiffusion, optimizer: Adam,
                batches: PharmComplexBatch, generator: torch.Generator,
                rows) -> "TrainGraphs":
    """The kept graph of this call's signature (shapes, K, the
    accumulation phase, `rows`, the model and the generator), or a new one.
    When the weights' or the optimizer's tensors have moved since the kept
    graphs were captured, those are freed first."""
    with trace.span("train.graphs"):
        addrs = tuple(t.data_ptr() for t in _state_tensors(model, optimizer))
        kept = optimizer.train_graphs
        if any(g.addrs != addrs for g in kept.values()):
            kept.clear()
            optimizer.graph_pool = None
        key = (_shapes(batches), optimizer.mini_step, rows, id(model),
               id(generator))
        graphs = kept.get(key)
        if graphs is None:
            graphs = TrainGraphs(model, optimizer, generator, batches, rows)
            kept[key] = graphs
        return graphs


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

    Before the capture one step runs eagerly on a side stream, so the
    first-use work (kernel builds, launch attributes, K3's scratch query,
    cuBLAS workspaces) happens outside the graph; the weights, Adam's
    state, the accumulation buffers and phase and the generator are then
    restored, so that step leaves no trace. Every graph of one optimizer
    shares one memory pool. `addrs` are the storage addresses of the
    tensors the graph updates in place, `capture_ms` the host time of the
    warm-up and the capture, `pool_bytes` the device memory the capture
    reserved. Building one counts "train.captures" once its capture
    returned, inside the span "train.capture"."""

    def __init__(self, model: PharmacophoreDiffusion, optimizer: Adam,
                 generator: torch.Generator, batches: PharmComplexBatch,
                 rows: Optional[Tuple[int, int]]):
        with trace.span("train.capture"):
            self._capture(model, optimizer, generator, batches, rows)
            trace.count("train.captures")

    def _capture(self, model, optimizer, generator, batches, rows) -> None:
        dev = model.device
        self.model, self.optimizer, self.generator = model, optimizer, \
            generator
        self.rows = rows
        self.k = batches.pharm_x.shape[0]
        self.phase = optimizer.mini_step
        self.inputs = {name: torch.from_numpy(np.array(getattr(
            batches, name))).to(dev) for name in _FIELDS}
        state = _state_tensors(model, optimizer)
        self.addrs = tuple(t.data_ptr() for t in state)
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            saved = ([t.detach().clone() for t in state],
                     generator.get_state())
            self.names = list(_warm_up(dev, lambda: self._step(0)))
            with torch.no_grad():
                for t, copy in zip(state, saved[0]):
                    t.copy_(copy)
            generator.set_state(saved[1])
            optimizer.mini_step = self.phase
            optimizer.zero_grad()
            del saved
            self.out = torch.zeros((self.k, len(self.names)), device=dev)
            if optimizer.graph_pool is None:
                optimizer.graph_pool = torch.cuda.graph_pool_handle()
            self.graph, self.counts, self.pool_bytes = _capture(
                dev, generator, optimizer.graph_pool, self._body)
            optimizer.mini_step = self.phase
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _step(self, j: int) -> Dict[str, torch.Tensor]:
        """Step j of the call, on the graph's input tensors."""
        batch = PharmComplexBatch(**{name: self.inputs[name][j]
                                     for name in _FIELDS})
        return _one_step(self.model, self.optimizer, batch, self.generator,
                         self.rows, None)

    def _body(self) -> None:
        """The K steps, each writing its metrics into its row of `out`:
        what the graph holds."""
        for j in range(self.k):
            self.out[j].copy_(_vector(self._step(j)))

    def load(self, batches: PharmComplexBatch) -> None:
        """Copy a call's batches of this signature into the graph's input
        tensors."""
        for name in _FIELDS:
            self.inputs[name].copy_(torch.from_numpy(
                np.asarray(getattr(batches, name))))

    def run(self) -> torch.Tensor:
        """One replay: the call's K steps, enqueued on the current stream;
        returns `out`, which this graph's next replay overwrites."""
        opt = self.optimizer
        if opt.mini_step != self.phase:
            raise RuntimeError(f"train graph of phase {self.phase} replayed "
                               f"at phase {opt.mini_step}")
        self.graph.replay()
        opt.mini_step = (self.phase + self.k) % opt.accumulate
        diffusion.count_replays("train", self.counts, 1)
        return self.out


# ------------------------------------------------- the validation runner

def _weight_addrs(model: PharmacophoreDiffusion) -> tuple:
    """The storage addresses of every weight and buffer of `model`."""
    return tuple(t.data_ptr() for t in (*model.parameters(),
                                        *model.buffers()))


def _eval_graphs_for(model: PharmacophoreDiffusion, batch: PharmComplexBatch,
                     generator: torch.Generator, rows) -> "EvalGraphs":
    """The kept validation graph of this batch's signature (every field's
    shape and dtype, `rows`, the model and the generator), or a new one.
    The graphs live on the model (`_eval_graphs`); when a weight or buffer
    has moved to new storage since they were captured, they are freed
    first."""
    addrs = _weight_addrs(model)
    kept = getattr(model, "_eval_graphs", None)
    if kept is None or any(g.addrs != addrs for g in kept.values()):
        kept = model._eval_graphs = {}
    key = (_shapes(batch), rows, id(model), id(generator))
    graphs = kept.get(key)
    if graphs is None:
        pool = next(iter(kept.values())).pool if kept else None
        graphs = EvalGraphs(model, generator, batch, rows, pool)
        kept[key] = graphs
    return graphs


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

    Before the capture the forward runs once eagerly on a side stream, so
    first-use work (kernel builds, launch attributes, cuBLAS workspaces)
    happens outside the graph; the generator is then restored, so that
    run leaves no trace. The graphs of one model share one memory pool
    (`pool`), apart from the train graphs'. `addrs` are the storage
    addresses of the weights and buffers the graph reads, `capture_ms`
    the host time of the warm-up and the capture, `pool_bytes` the device
    memory the capture reserved. Building one counts "eval.captures" once
    its capture returned, inside the span "eval.capture"."""

    def __init__(self, model: PharmacophoreDiffusion,
                 generator: torch.Generator, batch: PharmComplexBatch,
                 rows: Optional[Tuple[int, int]], pool=None):
        with trace.span("eval.capture"):
            self._capture(model, generator, batch, rows, pool)
            trace.count("eval.captures")

    def _capture(self, model, generator, batch, rows, pool) -> None:
        dev = model.device
        self.model, self.generator, self.rows = model, generator, rows
        self.inputs = {name: torch.from_numpy(np.array(getattr(
            batch, name))).to(dev) for name in _FIELDS}
        self.addrs = _weight_addrs(model)
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            saved = generator.get_state()
            self.names, _ = _warm_up(dev, lambda: eager_eval(
                model, self._batch(), generator, rows))
            generator.set_state(saved)
            self.out = torch.zeros(len(self.names), device=dev)
            self.pool = pool or torch.cuda.graph_pool_handle()
            self.graph, self.counts, self.pool_bytes = _capture(
                dev, generator, self.pool, self._body)
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _batch(self) -> PharmComplexBatch:
        return PharmComplexBatch(**self.inputs)

    def _body(self) -> None:
        """The forward, writing its metrics into `out`: what the graph
        holds."""
        self.out.copy_(eager_eval(self.model, self._batch(), self.generator,
                                  self.rows)[1])

    def load(self, batch: PharmComplexBatch) -> None:
        """Copy a batch of this signature into the graph's input
        tensors."""
        for name in _FIELDS:
            self.inputs[name].copy_(torch.from_numpy(
                np.asarray(getattr(batch, name))))

    def run(self) -> torch.Tensor:
        """One replay, enqueued on the current stream; returns `out`,
        which this graph's next replay overwrites."""
        self.graph.replay()
        self.model.train(False)
        diffusion.count_replays("eval", self.counts, 1)
        return self.out
