"""batch_p95_ms: the 95th percentile, over every process() call of the
window, of the call's host wall time from hand-in to its ProcessResult
(numpy's linear interpolation). Host clock."""

import numpy as np


def read(ctx):
    if not ctx.latencies:
        return None
    return float(np.percentile(ctx.latencies, 95)) * 1e3
