"""A reentrant lock granted in the order it was asked for.

The trainer holds its step lock through each step and asks for it again a
few microseconds after releasing it.  ``threading``'s locks let the
releasing thread take them back before a waiting thread wakes, so a viewer
frame waiting for the lock could wait for a whole chunk of steps.  Here a
thread that asks again queues behind the threads already waiting: steps
and waiting frames alternate.
"""
from __future__ import annotations

import collections
import threading


class FairRLock:
    """Reentrant lock, first come first served; a context manager."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._owner = None
        self._depth = 0
        self._queue = collections.deque()

    def acquire(self) -> bool:
        me = threading.get_ident()
        with self._cond:
            if self._owner == me:
                self._depth += 1
                return True
            ticket = object()
            self._queue.append(ticket)
            while self._owner is not None or self._queue[0] is not ticket:
                self._cond.wait()
            self._queue.popleft()
            self._owner, self._depth = me, 1
            return True

    def release(self):
        with self._cond:
            if self._owner != threading.get_ident():
                raise RuntimeError('release of a FairRLock not held by '
                                   'this thread')
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
                self._cond.notify_all()

    def __reduce__(self):
        # a copy (copy.deepcopy of a trainer) is a new, free lock
        return FairRLock, ()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
