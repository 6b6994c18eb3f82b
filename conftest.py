"""A wall-clock limit on every test, so one that never returns fails and its
worker goes on to the next (tests/conftest.py holds the tests' own hooks)."""

import time

import pytest

from tests.time_limit import time_limit

# Limit on one test's setup, call and teardown together: about three times the
# slowest test under `-n 6` (160-180 s), and short enough that a hang starting
# late in the suite still ends inside the suite's own time limit.
LIMIT_S = 450
# The least a phase is given, so that a teardown after a call that used up the
# limit is guarded too.
GRACE_S = 30

_deadline = pytest.StashKey[float]()


def _phase(item, when):
    left = max(item.stash[_deadline] - time.monotonic(), GRACE_S)
    return time_limit(left, f"{item.nodeid} exceeded its time limit of {LIMIT_S} s in {when}")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    item.stash[_deadline] = time.monotonic() + LIMIT_S
    with _phase(item, "setup"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _phase(item, "call"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _phase(item, "teardown"):
        yield
