"""Fault-tolerance utilities: heartbeats, straggler detection, preemption
hooks, auto-resume (plain Python: the port's copy of the reference's
``fault_tolerance.py``).

At 1000+ nodes the failure model is: a host dies (restart from checkpoint,
possibly elastic onto fewer hosts), a host slows down (straggler — detect,
report, evict + elastic restart), or the job is preempted (emergency
checkpoint on SIGTERM).  In lockstep SPMD training a slow host *is* a slow
step, so detection is timing-based at the launcher.
"""
from __future__ import annotations

import json
import os
import signal
import time


class Heartbeat:
    """Launcher-side liveness file; an external supervisor (or another pod's
    coordinator) treats a stale mtime as host failure."""

    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self, step: int):
        now = time.time()
        if now - self._last >= self.interval_s:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "time": now}, f)
            os.replace(tmp, self.path)
            self._last = now


class StragglerMonitor:
    """Rolling per-step time stats; flags steps slower than k× the median.

    In lockstep SPMD a straggling host inflates everyone's step time — the
    launcher reports it and, above `evict_after` consecutive flags, asks the
    supervisor for an elastic restart excluding the slow host.
    """

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 evict_after: int = 10):
        self.window = window
        self.threshold = threshold
        self.evict_after = evict_after
        self.times: list[float] = []
        self.consecutive_slow = 0
        self.flagged_steps: list[int] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True when an evict/elastic-restart is recommended."""
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 10:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.threshold * med:
                self.consecutive_slow += 1
                self.flagged_steps.append(step)
            else:
                self.consecutive_slow = 0
        return self.consecutive_slow >= self.evict_after


class PreemptionGuard:
    """SIGTERM/SIGINT → set a flag; the train loop checkpoints and exits.

    Use as a context manager around the training loop.
    """

    def __init__(self):
        self.preempted = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.preempted = True

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # non-main thread (tests)
                pass
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False
