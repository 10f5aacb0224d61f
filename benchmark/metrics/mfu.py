"""mfu (whole step): the model's operations an epoch, counted from the
configuration's shapes (`counts.epoch_flops`), over the untraced window's
seconds an epoch times the compute dtype's peak, in %."""
from benchmark.counts import PEAK_FLOPS, epoch_flops


def read(ctx):
    if not ctx.epoch_s or ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * epoch_flops(ctx.config, ctx.num_edges) / (
        ctx.epoch_s * PEAK_FLOPS[ctx.dtype])
