"""The device's side of a traced run: `torch.profiler` over the window, and
what the metric readers take from it.

Only device activity is traced (CUPTI), so the host's own clocks inside the
program read as they do untraced.  Every operation on the card counts as busy:
kernels, copies and fills.
"""
from __future__ import annotations

import re
import time

_ANON = re.compile(r"\(anonymous namespace\)::")


def short_name(name: str, keep: int = 90) -> str:
    """An operation's name without its argument list (and without the
    anonymous namespace of the circuit kernels), cut to ``keep`` letters."""
    name = _ANON.sub("", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):  # the first "(" outside template brackets
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut].strip()[:keep]


def kernel_name(name: str) -> str:
    """A kernel's bare name: ``eval_program_kernel`` of
    ``(anonymous namespace)::eval_program_kernel(Program, ...)``."""
    return short_name(name, 10_000).split(" ")[-1].split("::")[-1]


class DeviceTrace:
    """The device operations of one traced window, in start order."""

    def __init__(self, ops: "list[tuple[str, int, int]]", window_s: float):
        self.ops = sorted(ops, key=lambda o: o[1])   # (name, start ns, end ns)
        self.window_s = window_s

    def busy_s(self) -> float:
        """Seconds in which some operation ran: the union of their spans."""
        busy, end = 0, None
        for _, s, e in self.ops:
            if end is None or s >= end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def durations_s(self, kernel: str) -> "list[float]":
        """Seconds of each launch of ``kernel`` (its name up to the
        parenthesis of its signature), in start order."""
        return [(e - s) / 1e9 for name, s, e in self.ops if kernel_name(name) == kernel]

    def top_ops(self, k: int = 10) -> "list[list]":
        """The ``k`` operations that took most device time, summed by name."""
        total: dict = {}
        for name, s, e in self.ops:
            key = short_name(name)
            total[key] = total.get(key, 0) + (e - s) / 1e9
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> "list[list]":
        """Idle device time between operations, summed by the pair of
        operations around each gap: the host's work between them."""
        total: dict = {}
        end, prev = None, None
        for name, s, e in self.ops:
            short = short_name(name, 40)
            if end is not None and s > end:
                key = f"host between {prev} and {short}"
                total[key] = total.get(key, 0) + (s - end) / 1e9
            if end is None or e > end:
                end, prev = e, short
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:k]]


class Profile:
    """``with Profile(on) as p:`` traces the device over the block when
    ``on``; afterwards ``p.trace`` is a `DeviceTrace` (None when off).  The
    block's work is synchronised before the profiler stops, and the window
    is timed from the profiler's start to that synchronisation."""

    def __init__(self, on: bool):
        self.on = on
        self.trace: "DeviceTrace | None" = None

    def __enter__(self) -> "Profile":
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.on:
            import torch
            from torch.autograd import DeviceType
            torch.cuda.synchronize()
            window_s = time.perf_counter() - self._t0
            self._prof.__exit__(*exc)
            ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in self._prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA]
            self.trace = DeviceTrace(ops, window_s)
        return False
