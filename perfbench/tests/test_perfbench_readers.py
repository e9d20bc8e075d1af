"""The shared arithmetic of the metric readers, on hand-made traces."""
import pytest

from perfbench import devtrace, readers
from perfbench.harness import Run

KERNEL = "eval_program_kernel"
NAME = "(anonymous namespace)::eval_program_kernel(Program, int const*, int*, int, int)"


def traced(durations_ns, bounds_s, others=()):
    """A run whose trace holds one launch of the kernel per duration, 1 ms
    apart, and the other operations given as (name, start ns, end ns)."""
    ops = [(NAME, i * 1_000_000, i * 1_000_000 + d) for i, d in enumerate(durations_ns)]
    trace = devtrace.DeviceTrace(ops + list(others), window_s=1.0)
    return Run(trace=trace, kernel=KERNEL, launch_bounds_s=list(bounds_s))


def test_roofline_is_bounds_over_times_when_every_launch_is_traced():
    run = traced([4000, 6000], [1e-6, 2e-6])
    assert readers.roofline_pct(run) == pytest.approx(100.0 * 3e-6 / 10e-6)


@pytest.mark.parametrize("traced_launches", [1, 2, 3])
def test_roofline_lets_the_traced_launches_stand_for_all(traced_launches):
    """The profiler may lose the records of a few launches: the reading is
    still the mean least time over the mean traced time, not nothing."""
    run = traced([5000] * traced_launches, [1e-6] * 4)
    assert readers.roofline_pct(run) == pytest.approx(20.0)


def test_roofline_ignores_other_kernels():
    other = ("void at::native::reduce_kernel<512, 1>(float*)", 10, 900_000)
    run = traced([5000], [1e-6], [other])
    assert readers.roofline_pct(run) == pytest.approx(20.0)


@pytest.mark.parametrize("durations, bounds, trace", [
    ([], [1e-6], True),       # the trace holds no launch of the kernel
    ([5000], [], True),       # no launch was made in the window
    ([5000], [1e-6], False),  # an untraced run
])
def test_roofline_reads_nothing_without_both_sides(durations, bounds, trace):
    run = traced(durations, bounds)
    if not trace:
        run.trace = None
    assert readers.roofline_pct(run) is None
