"""Background-thread batch prefetcher: collation on the host overlaps the
device's step. The counterpart of the JAX package's `train/prefetch.py`."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch(batches: Iterable, depth: int = 2) -> Iterator:
    """Wrap a batch iterator with a depth-bounded background producer. An
    exception in the producer is raised in the consumer; a consumer that
    stops early (the generator is closed) stops the producer after the
    batch it is making and joins it."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()

    def producer():
        try:
            for b in batches:
                if stop.is_set():
                    break
                q.put(b)
        except BaseException as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while t.is_alive():  # drain so a blocked put returns
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        t.join()
