"""The per-test time limit (tests/time_limit.py, armed by the root conftest.py)."""

import contextlib
import signal
import threading
import time

import pytest

from tests.time_limit import TimeLimitExceeded, time_limit


def _sentinel(signum, frame):
    pass


@contextlib.contextmanager
def _known_alarm_state():
    """Install a known SIGALRM handler with no timer, and put back the test's own
    limit (armed around the call, so this runs inside the test's body)."""
    outer = signal.signal(signal.SIGALRM, _sentinel)
    outer_timer = signal.setitimer(signal.ITIMER_REAL, 0)
    try:
        yield
    finally:
        signal.signal(signal.SIGALRM, outer)
        signal.setitimer(signal.ITIMER_REAL, *outer_timer)


def _assert_restored():
    assert signal.getsignal(signal.SIGALRM) is _sentinel
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)


def test_every_call_runs_under_the_limit():
    assert signal.getsignal(signal.SIGALRM) not in (signal.SIG_DFL, signal.SIG_IGN, None)
    assert 0.0 < signal.getitimer(signal.ITIMER_REAL)[0] <= 450


def test_overrun_raises_at_the_limit():
    with _known_alarm_state():
        t0 = time.monotonic()
        with pytest.raises(TimeLimitExceeded, match="sleeper exceeded its time limit of 1 s"):
            with time_limit(1, "sleeper exceeded its time limit of 1 s"):
                time.sleep(5)
        assert 0.9 < time.monotonic() - t0 < 2.0
        _assert_restored()


def test_body_in_time_raises_nothing():
    with _known_alarm_state():
        with time_limit(1):
            time.sleep(0.05)
        _assert_restored()


def test_off_the_main_thread_the_body_runs_unguarded():
    seen = []

    def body():
        with time_limit(0.05):
            time.sleep(0.2)
            seen.append(signal.getitimer(signal.ITIMER_REAL))

    with _known_alarm_state():
        worker = threading.Thread(target=body)
        worker.start()
        worker.join()
        assert seen == [(0.0, 0.0)]
        _assert_restored()
