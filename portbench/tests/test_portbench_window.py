"""The window-end rule: work is submitted only while the window is younger
than its length, in whole groups, and the window ends when the last request
submitted inside it completes."""

import threading
from concurrent import futures

from portbench import window


class FakeClock:
    def __init__(self):
        self.t = 0.0
        self.lock = threading.Lock()

    def __call__(self):
        with self.lock:
            return self.t


def test_window_ends_at_last_completion():
    clock = FakeClock()
    pending = []

    def submit(i):
        f = futures.Future()
        pending.append(f)
        if len(pending) % 4 == 0:  # a group of 4 completes one second later
            group = pending[-4:]

            def finish():
                with clock.lock:
                    clock.t += 1.0
                for g in group:
                    g.set_result(i)

            threading.Timer(0.01, finish).start()
        return f

    recs, t0, t1 = window.closed_loop(submit, 100, seconds=3.0, outstanding=8, group=4,
                                      clock=clock, timeout=5)
    assert t0 == 0.0
    # submissions stop once the window is 3 s old; everything submitted completes
    assert all(r.t_submit < 3.0 for r in recs)
    assert all(r.t_done is not None and r.error is None for r in recs)
    assert t1 == max(r.t_done for r in recs)
    assert len(recs) % 4 == 0 and len(recs) >= 12


def test_failed_request_is_recorded():
    def submit(i):
        f = futures.Future()
        f.set_exception(ValueError("bad")) if i == 1 else f.set_result(i)
        return f

    recs, _, _ = window.closed_loop(submit, 10, seconds=0.0, outstanding=3)
    assert [r.error is not None for r in recs] == [False, True, False]


def test_window_serves_whole_cycles():
    clock = FakeClock()

    def submit(i):
        with clock.lock:
            clock.t += 1.0  # each request takes a second
        f = futures.Future()
        f.set_result(i)
        return f

    recs, _, _ = window.closed_loop(submit, 100, seconds=5.5, outstanding=2, cycle=4,
                                    clock=clock, timeout=5)
    # submissions pass the 5.5 s deadline only to finish the cycle in progress
    assert len(recs) % 4 == 0
    assert sum(r.t_submit >= 5.5 for r in recs) < 4
