"""A wall-clock limit on a block of code, for the per-test limit of the root conftest.py."""

import contextlib
import signal
import threading


class TimeLimitExceeded(BaseException):
    """Raised in a body that outruns its limit; a BaseException so that a bare
    `except Exception` in the code under test cannot swallow it."""


@contextlib.contextmanager
def time_limit(seconds, message=None):
    """Raise TimeLimitExceeded in the body once it has run `seconds`.

    SIGALRM reaches only the main thread, so elsewhere the body runs unguarded.
    The previous SIGALRM handler and a zero timer are restored on the way out.
    """
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def _expire(signum, frame):
        raise TimeLimitExceeded(message or f"exceeded the time limit of {seconds} s")

    previous = signal.signal(signal.SIGALRM, _expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
