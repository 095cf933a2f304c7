"""Host-side batch prefetching.

Port of `pharmaforge_tpu/data/prefetch.py`: a daemon thread packs batches
into a small bounded queue while the main thread drives the device, so
packing overlaps the step (numpy releases the GIL in its copies).

The producer stamps each batch into the ring of `utils/trace.py` (the
profiler does not see its thread): "loader.pack", the time `next` took on
the wrapped iterable, with the batch's sequence number; the consumer
marks when it took the batch and whether the batch was already queued.
Where the consumer has to wait, the wait is the span "loader.wait".
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator

from pharmaforge_tpu_torch.utils import trace


class _End:
    pass


class _Raise:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Iterate `iterable` on a background thread, `depth` items ahead.
    The producer's exceptions re-raise at the consuming site; the thread is
    a daemon, so abandoning the iterator cannot hang shutdown."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)

    def producer():
        try:
            items = iter(iterable)
            seq = 0
            while True:
                t0 = time.perf_counter_ns()
                try:
                    item = next(items)
                except StopIteration:
                    break
                q.put((item, trace.batch_packed(seq, t0)))
                seq += 1
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            q.put(_Raise(e))
            return
        q.put(_End)

    thread = threading.Thread(target=producer, daemon=True,
                              name="batch-prefetch")
    thread.start()
    while True:
        try:
            got, queued = q.get_nowait(), True
        except queue.Empty:
            with trace.span("loader.wait"):
                got, queued = q.get(), False
        if got is _End:
            break
        if isinstance(got, _Raise):
            raise got.exc
        item, record = got
        record.taken(queued)
        yield item
