"""What the port's three CUDA graph runners share: the reverse chain's
(`models/diffusion.py::ChainGraphs`), the train call's and the validation
batch's (`training/train_state.py::TrainGraphs`, `EvalGraphs`), and the
one module of the port that makes, captures into or pools CUDA graphs.

A runner stages its inputs into tensors of its own (`stage`), runs its
work once eagerly on a side stream so that first-use work (kernel builds,
launch attributes, K3's scratch query, cuBLAS workspaces) happens outside
any graph (`warm_up`), undoes that run's effects and captures the work
(`capture`); a later call of the same signature copies its inputs in
(`load_into`) and replays. A `GraphCache` keeps a runner's graphs by
signature (`spec`) in one memory pool. A capture counts each kernel
launch once (`kernel_counts`); each replay counts them again
(`count_replays`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from pharmaforge_tpu_torch.utils import trace

# the registry's counters that a graph's capture records, by kernel: each
# replay of the graph counts them again as "<kind>.replayed.<kernel>"
KERNEL_COUNTERS = {"knn_select": "knn_select.launches",
                   "pp_message": "pp_message.launches",
                   "pp_message_bwd": "pp_message.bwd_launches",
                   "corrections": "conv.corrections",
                   "gvp_chain": "gvp_chain.launches"}


@contextlib.contextmanager
def collector_paused():
    """Dead reference cycles collected now, and Python's cyclic garbage
    collector off inside the block: a collection during a CUDA graph
    capture could destroy an old graph kept in such a cycle, which a
    capturing stream does not allow (the capture is invalidated)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def kernel_counts() -> Dict[str, int]:
    """The kernel counters now, by kernel (`KERNEL_COUNTERS`)."""
    now = trace.counters()
    return {k: now[name] for k, name in KERNEL_COUNTERS.items()}


def count_replays(kind: str, captured: Dict[str, int], replays: int) -> None:
    """Count `replays` replays of a `kind` graph ("chain", "train" or
    "eval") whose capture counted `captured` (kernel -> launches):
    "<kind>.replays" and "<kind>.replayed.<kernel>"."""
    trace.count(f"{kind}.replays", replays)
    for k, n in captured.items():
        trace.count(f"{kind}.replayed.{k}", n * replays)


# ------------------------------------------------------------ the inputs

def _tensors(tree):
    """The tensors and numpy arrays of a nest of dataclasses, dicts,
    tuples and lists, in order."""
    if dataclasses.is_dataclass(tree):
        tree = vars(tree)
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        yield tree
    elif isinstance(tree, (dict, tuple, list)):
        for v in tree.values() if isinstance(tree, dict) else tree:
            yield from _tensors(v)


def spec(tree):
    """The structure of a nest with every tensor as (shape, dtype,
    device) and every numpy array as (shape, dtype): what a captured graph
    is specialised to."""
    if torch.is_tensor(tree):
        return tuple(tree.shape), tree.dtype, tree.device
    if isinstance(tree, np.ndarray):
        return tree.shape, tree.dtype.str
    if dataclasses.is_dataclass(tree):
        return type(tree).__name__, spec(vars(tree))
    if isinstance(tree, dict):
        return tuple((k, spec(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return type(tree).__name__, tuple(spec(v) for v in tree)
    return tree


def stage(tree, dev=None):
    """A copy of a nest in which every tensor and numpy array is a new
    tensor on `dev` (a tensor's own device where `dev` is None) and every
    other leaf is kept: the inputs a graph reads, which `load_into`
    refills."""
    if isinstance(tree, np.ndarray):
        return torch.tensor(tree, device=dev)
    if torch.is_tensor(tree):
        return tree.to(dev or tree.device, copy=True)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **stage(vars(tree), dev))
    if isinstance(tree, dict):
        return {k: stage(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [stage(v, dev) for v in tree]
        return type(tree)(*items if hasattr(tree, "_fields") else [items])
    return tree


def load_into(staged, tree) -> None:
    """Copy the tensors and arrays of `tree`, a nest of `staged`'s
    signature, into `staged`'s tensors."""
    for dst, src in zip(_tensors(staged), _tensors(tree), strict=True):
        dst.copy_(torch.as_tensor(src))


# ------------------------------------------------ the warm-up and capture

def warm_up(dev, fn: Callable):
    """`fn()` on a new side stream of `dev` that starts after the current
    stream's work, which then waits for it: first-use work outside any
    graph. Returns what `fn` returns."""
    with torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = fn()
        torch.cuda.current_stream(dev).wait_stream(side)
    return out


def capture(dev, body: Callable, pool,
            generator: Optional[torch.Generator] = None) -> tuple:
    """`body()` captured into a new CUDA graph in memory pool `pool`, with
    `generator` (where given) registered, so each replay advances it as an
    eager run does, and Python's cyclic collector paused
    (`collector_paused`). Returns (the graph, the launches the capture
    counted, by kernel, the device memory it reserved)."""
    with torch.cuda.device(dev), collector_paused():
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = kernel_counts()
        with torch.cuda.graph(graph, pool=pool):
            body()
        after = kernel_counts()
        torch.cuda.synchronize(dev)
        return (graph, {k: after[k] - before[k] for k in after},
                torch.cuda.memory_reserved(dev) - reserved)


class GraphCache:
    """A runner's captured graphs by signature (`graphs`), all in one
    memory pool (`pool`). They read tensors in place (weights, optimizer
    state), so `get` drops them all, and the pool, when one of those has
    moved to new storage since."""

    def __init__(self):
        self.graphs: dict = {}
        self.pool = None
        self._addrs: Optional[tuple] = None

    def clear(self) -> None:
        self.graphs.clear()
        self.pool = self._addrs = None

    def get(self, key, read: Iterable[torch.Tensor],
            build: Callable[[object], object]):
        """The graphs kept under `key`, else `build(pool)`'s, kept under
        it; `read` are the tensors the graphs read in place. A build that
        raises keeps nothing."""
        addrs = tuple(t.data_ptr() for t in read)
        if addrs != self._addrs:
            self.clear()
            self._addrs = addrs
        if key not in self.graphs:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            self.graphs[key] = build(self.pool)
        return self.graphs[key]
