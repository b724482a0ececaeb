"""step_busy_ms: device milliseconds a step in which a kernel ran (the
union of kernel intervals, copies left out), over the profiled
sub-window's steps. Device trace. Moves stream_msps."""

from benchmark.trace import busy_seconds


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls or not t.kernels():
        return None
    return busy_seconds(t, ("kernel",)) / t.calls * 1e3
