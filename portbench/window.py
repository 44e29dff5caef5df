"""The measured window of a closed backlog.

The window starts at the first submission. New work is submitted while
the window is younger than `seconds`, and then until the traffic's size
cycle in progress is whole, topping the backlog up to `outstanding`
requests in whole groups of `group`. The window ends when the last request
submitted completes, so every request that starts counts whole, a stall
anywhere inside shows in the rate, and every run serves whole cycles of
the same sizes.
"""

from __future__ import annotations

import threading
import time
from concurrent import futures
from typing import Callable, List, Optional


class Done:
    """One request's record: its index in the traffic, submit and completion
    times (host clock, seconds), and its result or exception."""

    __slots__ = ("index", "t_submit", "t_done", "result", "error")

    def __init__(self, index: int, t_submit: float):
        self.index, self.t_submit = index, t_submit
        self.t_done: Optional[float] = None
        self.result = None
        self.error: Optional[BaseException] = None


def closed_loop(submit: Callable[[int], futures.Future], n_available: int, seconds: float,
                outstanding: int, group: int = 1, cycle: int = 1, clock=time.perf_counter,
                timeout: float = 600.0):
    """Run the window. submit(i) starts request i of the traffic (cycling
    when i passes n_available) and returns its Future; `cycle` is the
    traffic's size cycle (a multiple of `group`). Returns (records in
    submission order, window start, window end)."""
    lock = threading.Lock()
    records: List[Done] = []
    pending = set()

    def finish(rec: Done, fut: futures.Future) -> None:
        t = clock()
        try:
            rec.result = fut.result()
        except BaseException as e:  # noqa: BLE001 — recorded as the request's failure
            rec.error = e
        with lock:
            rec.t_done = t

    def start(i: int) -> None:
        rec = Done(i, clock())
        fut = submit(i % n_available)
        records.append(rec)
        pending.add(fut)
        fut.add_done_callback(lambda f, r=rec: finish(r, f))

    t0 = clock()
    while len(pending) < outstanding:
        start(len(records))
    while pending:
        done, _ = futures.wait(pending, timeout=timeout, return_when=futures.FIRST_COMPLETED)
        if not done:
            raise TimeoutError(f"no request completed within {timeout} s")
        pending -= done
        if clock() - t0 < seconds or len(records) % cycle:
            while len(pending) + group <= outstanding and (
                    clock() - t0 < seconds or len(records) % cycle):
                for _ in range(group):
                    start(len(records))
    for rec in records:  # a done callback may still be running
        while True:
            with lock:
                if rec.t_done is not None:
                    break
            time.sleep(0.001)
    return records, t0, max(r.t_done for r in records)
