"""agg_roofline (kernels): the aggregation calls' floors over their
measured device time, in %. The floors are the yardstick's
(`counts.epoch_aggregation_floor_s`): each call's bytes at MaxK's k
channels over 3.35 TB/s, or its operations over the dtype's peak, the
larger."""
from benchmark.counts import epoch_aggregation_floor_s
from benchmark.trace import aggregation_s


def read(ctx):
    if ctx.trace is None or not ctx.traced_epochs:
        return None
    s = aggregation_s(ctx.trace, ctx.own_kernels)
    if not s:
        return None
    floor = epoch_aggregation_floor_s(ctx.config, ctx.num_edges, ctx.dtype)
    return 100.0 * floor * ctx.traced_epochs / s
