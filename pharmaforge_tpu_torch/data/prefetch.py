"""Host-side batch prefetching.

Port of `pharmaforge_tpu/data/prefetch.py`: a daemon thread packs batches
into a small bounded queue while the main thread drives the device, so
packing overlaps the step (numpy releases the GIL in its copies).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


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
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            q.put(_Raise(e))
            return
        q.put(_End)

    thread = threading.Thread(target=producer, daemon=True,
                              name="batch-prefetch")
    thread.start()
    while True:
        item = q.get()
        if item is _End:
            break
        if isinstance(item, _Raise):
            raise item.exc
        yield item
