"""device_idle_pct: the share of the profiled sub-window in which no
kernel and no copy ran on the card. Device trace. Moves stream_msps."""

from benchmark.trace import busy_seconds


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops or t.seconds <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(t) / t.seconds)
