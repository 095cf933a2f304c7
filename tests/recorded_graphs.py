"""A CPU stand-in for CUDA graphs, for the graph runners' tests.

`recorded_graphs(monkeypatch)` replaces what the runners call in
`pharmaforge_tpu_torch/utils/graphs.py`: `warm_up` runs its function at
once (no side stream), `capture` returns a `RecordedGraph` whose replay
reruns the captured body, and the pool handle is a name. A capture runs
the body's host code once, as a CUDA graph capture does (the kernel
counters count its launches), and undoes every tensor write it made and
the registered generator's draws, as a capture enqueues nothing. It also
takes every chain (`ReverseChain.device`) and every train or validation
device (`train_state.captured`) as captured. The real graphs run in the
card tests (`test_torch_port_cuda.py`).
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pharmaforge_tpu_torch.models import diffusion
from pharmaforge_tpu_torch.training import train_state
from pharmaforge_tpu_torch.utils import graphs


class RecordedGraph:
    """Stands in for `torch.cuda.CUDAGraph`: a replay reruns the body of
    its capture. `made` counts the graphs made."""

    made = 0

    def __init__(self, body):
        RecordedGraph.made += 1
        self.body = body

    def replay(self):
        self.body()


class _Undone(TorchDispatchMode):
    """Inside the block every tensor an operator writes is saved before
    its first write; `undo` puts the saved values back."""

    def __init__(self):
        super().__init__()
        self.saved = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            value = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in value if isinstance(value, (list, tuple)) else [value]:
                if torch.is_tensor(t) and id(t) not in self.saved:
                    self.saved[id(t)] = (t, t.clone())
        return func(*args, **kwargs)

    def undo(self):
        with torch.no_grad():
            for t, value in reversed(list(self.saved.values())):
                t.copy_(value)


def _capture(dev, body, pool, generator=None):
    rng = None if generator is None else generator.get_state()
    before = graphs.kernel_counts()
    undone = _Undone()
    with undone:
        body()
    undone.undo()
    after = graphs.kernel_counts()
    if rng is not None:
        generator.set_state(rng)
    return RecordedGraph(body), {k: after[k] - before[k] for k in after}, 0


def recorded_graphs(monkeypatch):
    """The runners' CUDA calls replaced by the CPU stand-ins above."""
    monkeypatch.setattr(graphs, "warm_up", lambda dev, fn: fn())
    monkeypatch.setattr(graphs, "capture", _capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(diffusion.ReverseChain, "device",
                        property(lambda self: torch.device("cuda")))
    monkeypatch.setattr(train_state, "captured", lambda device: True)
