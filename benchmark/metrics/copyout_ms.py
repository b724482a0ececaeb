"""copyout_ms: host milliseconds a batch in the program's copy-out of the
step's outputs (``models/channelizer.py``: ``_to_host``, outermost calls,
and ``_pairs_to_complex``), by the harness's spans around both. The
traced run synchronises the device after each step, so no device wait is
in it. Moves stream_msps."""

NAMES = ("bench.to_host", "bench.pairs_to_complex")


def read(ctx):
    if ctx.spans is None or not ctx.span_calls:
        return None
    if not any(ctx.spans.count[n] for n in NAMES):
        return None
    return sum(ctx.spans.total[n] for n in NAMES) / ctx.span_calls * 1e3
