"""TraceRecorder: a bounded, fake-clock-testable event timeline.

Standard-library copy of the reference package's recorder, so the
port's serving tick keeps its spans.  One recorder holds one timeline:
the tick phases (encode / pack / device_put / launch / readback / decode)
and the backend's kernel launches append typed events — span begin/end,
instants, counters, and cross-thread async spans — into one bounded ring.

  * **Zero-cost when disabled.**  Servers construct against the shared
    `NULL_TRACER`; every record method is one branch, and `span()`
    returns one shared no-op context manager.
  * **Bounded.**  Events live in a ``deque(maxlen=capacity)`` ring;
    ``dropped`` counts evictions.
  * **Fake-clock-testable.**  Time enters only through ``clock``.
  * **Thread-tolerant.**  Each append is one ``deque.append``; duration
    spans nest per *track* (one per thread by default).

Event phases follow the Chrome trace-event vocabulary: ``B``/``E`` span
begin/end, ``X`` complete span (start and duration known when recorded),
``i`` instant, ``C`` counter, ``b``/``n``/``e`` async span.

The serving stack is handed its recorder (``tracer=``).  The fit and the
encoding have no such argument: they record into the process's current
recorder, `active`, which is `NULL_TRACER` unless a `recording` block is
open::

    with recording(TraceRecorder(capacity=1 << 20)) as rec:
        clf.fit(x, y)
    rec.export_chrome("fit.json")
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Callable, NamedTuple


class TraceEvent(NamedTuple):
    """One timeline event (timestamps in the recorder's clock domain)."""

    ts: float           # seconds, recorder clock
    phase: str          # "B" | "E" | "i" | "C" | "b" | "n" | "e"
    name: str
    cat: str            # category (export filter; required for async)
    track: str          # logical lane — exported as a thread id
    args: "dict | None"
    id: "int | None"    # async-span correlation id (b/n/e only)
    dur: "float | None" = None  # seconds (X only)


_new_tuple = tuple.__new__


class _NoopSpan:
    """Shared do-nothing context manager — the disabled `span()` path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


#: The one shared no-op context manager: what `TraceRecorder.span` (and
#: `core.evolve.PhaseClock`'s spans) return while recording is off.
NOOP_SPAN = _NoopSpan()


class _Span:
    """Context manager emitting a matched B/E pair on one track."""

    __slots__ = ("_rec", "_name", "_cat", "_track", "_args")

    def __init__(self, rec, name, cat, track, args):
        self._rec = rec
        self._name = name
        self._cat = cat
        self._track = track
        self._args = args

    def __enter__(self) -> "_Span":
        self._rec.begin(
            self._name, cat=self._cat, track=self._track,
            **(self._args or {}),
        )
        return self

    def __exit__(self, *exc) -> bool:
        self._rec.end(self._name, cat=self._cat, track=self._track)
        return False


class TraceRecorder:
    """Bounded ring buffer of typed trace events.

    ``capacity`` bounds memory (oldest events are evicted; ``dropped``
    counts them).  ``clock`` is the timestamp source — inject a fake for
    deterministic tests.  ``enabled`` can be toggled live; a disabled
    recorder costs one branch per record call.
    """

    def __init__(
        self,
        capacity: int = 65536,
        *,
        clock: Callable[[], float] = time.perf_counter,
        enabled: bool = True,
    ):
        self.enabled = bool(enabled)
        self.clock = clock
        self.capacity = int(capacity)
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity
        )
        self._recorded = 0
        self._ids = itertools.count(1)

    # -- lifecycle ------------------------------------------------------
    def enable(self) -> "TraceRecorder":
        self.enabled = True
        return self

    def disable(self) -> "TraceRecorder":
        self.enabled = False
        return self

    def clear(self) -> None:
        self._events.clear()
        self._recorded = 0

    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        """Events evicted by the ring bound (0 = the window is complete)."""
        return self._recorded - len(self._events)

    def events(self) -> list[TraceEvent]:
        """Snapshot of the ring, oldest first (C-level copy: safe against
        concurrent appends)."""
        return list(self._events)

    def next_id(self) -> int:
        """Fresh async-span correlation id (itertools.count: one C-level
        step, safe under the GIL)."""
        return next(self._ids)

    # -- recording ------------------------------------------------------
    def _record(self, phase, name, cat, track, args, id=None) -> None:
        # the one hot branch: a disabled recorder does nothing else
        if not self.enabled:
            return
        self._recorded += 1
        self._events.append(TraceEvent(
            self.clock(), phase, name, cat,
            track if track is not None
            else threading.current_thread().name,
            args or None, id,
        ))

    def begin(self, name: str, *, cat: str = "", track: "str | None" = None,
              **args) -> None:
        """Open a duration span on ``track`` (must be closed by `end`)."""
        self._record("B", name, cat, track, args)

    def end(self, name: str, *, cat: str = "", track: "str | None" = None,
            **args) -> None:
        """Close the innermost open span on ``track``."""
        self._record("E", name, cat, track, args)

    def span(self, name: str, *, cat: str = "", track: "str | None" = None,
             **args):
        """``with tracer.span("tick.encode", tenant=t): ...`` — emits a
        matched B/E pair.  Disabled recorders return one shared no-op
        context manager: no allocation on the hot path."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, cat, track, args)

    def instant(self, name: str, *, cat: str = "",
                track: "str | None" = None, **args) -> None:
        """A point-in-time marker (scheduler fire, plan swap, ...)."""
        self._record("i", name, cat, track, args)

    def complete(self, name: str, start: float, end: float, *, cat: str = "",
                 track: "str | None" = None, **args) -> None:
        """A span whose start and end (recorder clock) the caller has
        already read: one ``X`` event, for a phase timed by its own clock
        reads (`core.evolve.PhaseClock`)."""
        if not self.enabled:
            return
        self._recorded += 1
        # tuple.__new__ skips the NamedTuple's Python-level constructor: a
        # fit records nine of these a generation
        self._events.append(_new_tuple(TraceEvent, (
            start, "X", name, cat,
            track if track is not None
            else threading.current_thread().name,
            args or None, None, end - start,
        )))

    def counter(self, name: str, value: float, *, cat: str = "",
                track: "str | None" = None) -> None:
        """One sample of a named counter series (queue depth, ...)."""
        self._record("C", name, cat, track, {"value": value})

    # -- async (cross-thread) spans ------------------------------------
    def async_begin(self, name: str, id: int, *, cat: str = "request",
                    track: "str | None" = None, **args) -> None:
        """Open a correlated span that may end on another thread —
        the request-lifecycle primitive."""
        self._record("b", name, cat, track, args, id=id)

    def async_instant(self, name: str, id: int, *, cat: str = "request",
                      track: "str | None" = None, **args) -> None:
        self._record("n", name, cat, track, args, id=id)

    def async_end(self, name: str, id: int, *, cat: str = "request",
                  track: "str | None" = None, **args) -> None:
        self._record("e", name, cat, track, args, id=id)

    # -- export conveniences (full API in .export) ----------------------
    def export_chrome(self, path: str) -> dict:
        """Write the timeline as Chrome-trace/Perfetto JSON (open it at
        https://ui.perfetto.dev or chrome://tracing)."""
        from repro_torch.serve.observability.export import export_chrome

        return export_chrome(self, path)

    def export_jsonl(self, path: str) -> int:
        """Write the timeline as one JSON object per line."""
        from repro_torch.serve.observability.export import export_jsonl

        return export_jsonl(self, path)

    def __repr__(self) -> str:
        state = "on" if self.enabled else "off"
        return (f"<TraceRecorder {state} {len(self._events)}"
                f"/{self.capacity} events, {self.dropped} dropped>")


#: Shared disabled recorder — what every serving layer defaults to.
#: Recording through it is a single branch; `span()` through it is a
#: single shared no-op object.  Never enable this instance (it is shared
#: process-wide); construct a fresh `TraceRecorder` to actually trace.
NULL_TRACER = TraceRecorder(capacity=1, enabled=False)

_active = NULL_TRACER


def active() -> TraceRecorder:
    """The process's current recorder: `NULL_TRACER` outside a
    `recording` block."""
    return _active


@contextlib.contextmanager
def recording(rec: TraceRecorder):
    """Make ``rec`` the process's current recorder (`active`) for the
    block, and restore the previous one on exit, also when the block
    raises.  Code that reads `active` while the block is open records into
    ``rec``: the search's phases, encoding and packing, the kernel
    library's load."""
    global _active
    prev, _active = _active, rec
    try:
        yield rec
    finally:
        _active = prev
