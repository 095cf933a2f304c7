"""The port's counters and spans, in one place.

Counters: one registry of named counts (`count`, `counters`, `reset`)
under dotted names:

* the kernel wrappers' launches, `knn_select.launches`,
  `pp_message.launches` (K2) and `pp_message.bwd_launches` (K3), and the
  pocket-copy correction's passes, `conv.corrections`. Inside a CUDA graph
  capture a launch counts once, where it is captured, not where it is
  replayed;
* the graph runners' captures and replays: `chain.captures` (one a
  `ChainGraphs` built), `chain.replays` (one a graph replay) and
  `chain.replayed.<kernel>` (what those replays ran: each replay counts
  the launches its graph's capture counted), and likewise `train.` for
  `TrainGraphs` and `eval.` for `EvalGraphs`. A known signature replays
  and never captures.

Spans: `span(name)` marks a phase of a public call. On a thread that
`torch.profiler` records, it enters a record function "pf." + name, so
the phase lands in the profiler's timeline on the clock of the device
events, and puts its host start and end (`time.perf_counter_ns`) into
the ring (`records`). The ring is how the benchmark's readers get the
spans: its trace (`portbench/trace.py::Trace`) keeps the profiler's
device operations and only its own host annotations, and the profile is
gone when they read; they place the ring's spans on the profiler's
clock by the benchmark's calls, which both clocks hold. Once that trace
keeps the "pf." host events, the ring is needed for the producer thread
alone.
The record function is of the function scope (the one `torch.compile`'s
generated code enters, `torch._C._profiler._RecordFunctionFast`): a
user-scope `torch.profiler.record_function` is also drawn on the device's
timeline, as an annotation spanning every kernel it launched, which that
trace counts as a device operation.
Everywhere else it returns one shared null context: the cost of a span
is then one check of the profiler's state. Each public call opens one
root span and its phases nest inside it on the same thread, which is the
parent link. No span sits inside a CUDA graph capture, none adds device
work or a sync, and none is opened per denoiser step or per replay.

A thread the profiler did not start records nothing through it
(`record_function` is thread-local), so the batch prefetcher's producer
thread (`data/prefetch.py`) stamps its batches into the ring itself,
always: one `Record` a batch ("loader.pack"), with its sequence number,
the time its packing took and, once the consumer takes it, when and
whether it was already queued.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch

# entries the ring keeps: a 50 s training run at ~70 steps/s hands over
# ~3,500 batches, and a reader selects among them after the run
RING_SIZE = 16384

_counts: Dict[str, int] = {}
_lock = threading.Lock()
_ring: "collections.deque[Record]" = collections.deque(maxlen=RING_SIZE)
_NULL = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> "collections.Counter[str]":
    """A snapshot of every counter (a name never counted reads 0)."""
    with _lock:
        return collections.Counter(_counts)


def reset() -> None:
    """Every counter to nothing, and the ring emptied."""
    with _lock:
        _counts.clear()
    _ring.clear()


class Record:
    """One entry of the ring: a span's `name` (without "pf.") and its host
    start and end on `time.perf_counter_ns`; for a batch of the
    prefetcher, its sequence number `seq` in its iterator and, once the
    consumer took it, `taken_ns` and `queued` (whether it was already
    waiting in the queue)."""

    __slots__ = ("name", "start_ns", "end_ns", "seq", "taken_ns", "queued")

    def __init__(self, name: str, start_ns: int, end_ns: int,
                 seq: Optional[int] = None):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.seq = seq
        self.taken_ns: Optional[int] = None
        self.queued: Optional[bool] = None

    def taken(self, queued: bool) -> None:
        """The consumer took the batch now; `queued`: without waiting."""
        self.taken_ns = time.perf_counter_ns()
        self.queued = queued


def records(name: Optional[str] = None) -> List[Record]:
    """The ring's entries in the order they ended (all, or those of
    `name`)."""
    got = list(_ring.copy())
    return got if name is None else [r for r in got if r.name == name]


def batch_packed(seq: int, start_ns: int) -> Record:
    """Stamp batch `seq` of a prefetcher, packed from `start_ns` to now,
    into the ring; the consumer marks the record when it takes the
    batch."""
    rec = Record("loader.pack", start_ns, time.perf_counter_ns(), seq=seq)
    _ring.append(rec)
    return rec


class _Span:
    """A span on a profiled thread: the profiler's record function, and
    its host times into the ring on the way out."""

    __slots__ = ("name", "annotation", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.annotation = torch._C._profiler._RecordFunctionFast(
            "pf." + self.name)
        self.annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _ring.append(Record(self.name, self.start_ns, time.perf_counter_ns()))
        self.annotation.__exit__(*exc)
        return False


def span(name: str):
    """The context of phase `name` (see the module's note): a profiler
    record "pf.<name>" on the host while the calling thread is profiled,
    else one shared null context."""
    if _profiling():
        return _Span(name)
    return _NULL
