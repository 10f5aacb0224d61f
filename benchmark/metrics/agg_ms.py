"""agg_ms (kernels): the device time of the aggregation's kernels in the
traced window, in ms an epoch (`trace.is_aggregation`)."""
from benchmark.trace import aggregation_s


def read(ctx):
    if ctx.trace is None or not ctx.traced_epochs:
        return None
    s = aggregation_s(ctx.trace, ctx.own_kernels)
    return None if s is None else s * 1e3 / ctx.traced_epochs
