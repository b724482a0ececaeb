"""process_p95_ms: the 95th percentile of the process() call's host wall
time, from hand-in to its ProcessResult, over the traced run's calls
outside the profiled sub-window (numpy's linear interpolation): the
batch tail in a cell where batch_p95_ms is not end to end, beside it
where it is. The harness's spans and the device synchronisation after
each step are in it. Host clock. Moves stream_msps."""

import numpy as np


def read(ctx):
    if ctx.spans is None or not ctx.latencies:
        return None
    lat = [x for i, x in enumerate(ctx.latencies)
           if ctx.first_call + i not in ctx.spans.skip]
    if not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
