"""emit_ms: host milliseconds a batch in the emission layer
(``runtime/emission.py``: every emitter's ``process_step``), by the
harness's spans around each call. Moves stream_msps."""


def read(ctx):
    if ctx.spans is None or not ctx.span_calls:
        return None
    if not ctx.spans.count["bench.emit"]:
        return None
    return ctx.spans.total["bench.emit"] / ctx.span_calls * 1e3
