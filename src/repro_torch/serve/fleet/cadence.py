"""RebalanceCadence: periodic load-driven fleet rebalancing.

The cluster load harness used to call `FleetRouter.rebalance()` at a
scripted point mid-replay — fine for a demo, useless for operations.
This is the operational version: a small policy object the owner ticks
(from its serving loop, a timer thread, or per replay chunk) that fires
``rebalance("cadence")`` whenever both gates pass:

  * **interval** — at least ``interval_s`` elapsed since the last fire
    (clock injected, so fake-clock tests and trace replays drive it
    deterministically);
  * **traffic** — at least ``min_rows`` rows were routed since the last
    fire, measured by delta-windowing the router's monotone
    ``rows_routed`` counter with the shared `CounterWindow` primitive.
    An idle cluster never churns: consistent hashing already owns
    placement when there is no load signal worth replanning on.

The cadence keeps its own `CounterWindow` over ``rows_routed`` rather
than reading the router's per-tenant load window — `rebalance()` itself
consumes that one (`observed_loads`), and two consumers of one delta
window would halve each other's signal.
"""
from __future__ import annotations

import time
from typing import Callable

from repro_torch.serve.autoscale.controller import CounterWindow


class RebalanceCadence:
    """Tick-driven periodic `FleetRouter.rebalance` (see module doc)."""

    def __init__(
        self,
        router,
        *,
        interval_s: float = 30.0,
        min_rows: int = 1,
        clock: "Callable[[], float] | None" = None,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if min_rows < 0:
            raise ValueError(f"min_rows must be >= 0, got {min_rows}")
        self.router = router
        self.interval_s = float(interval_s)
        self.min_rows = int(min_rows)
        self.clock = clock if clock is not None else getattr(
            router, "clock", time.monotonic
        )
        self._rows_win = CounterWindow()
        self._pending_rows = 0.0
        self._last_fire = self.clock()
        self.fires = 0
        self.migrations = 0

    def due(self, now: "float | None" = None) -> bool:
        """Would a `tick` at ``now`` fire?  (Does not consume the row
        window — `tick` re-reads it.)"""
        now = self.clock() if now is None else now
        if now - self._last_fire < self.interval_s:
            return False
        rows = self._pending_rows + self._rows_win.delta(
            "rows", float(self.router.rows_routed)
        )
        self._pending_rows = rows  # bank the delta for the actual tick
        return rows >= self.min_rows

    def tick(self, now: "float | None" = None) -> "list | None":
        """One cadence step: rebalance if due, else no-op.  Returns the
        migration list when it fired (possibly empty — a balanced plan
        migrates nothing), None when it did not."""
        now = self.clock() if now is None else now
        if not self.due(now):
            return None
        self._last_fire = now
        self._pending_rows = 0.0
        events = self.router.rebalance("cadence")
        self.fires += 1
        self.migrations += len(events)
        return events

    def report(self) -> dict:
        return {
            "interval_s": self.interval_s,
            "min_rows": self.min_rows,
            "fires": self.fires,
            "migrations": self.migrations,
        }
