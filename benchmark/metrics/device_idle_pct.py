"""device_idle_pct (device): the share of the traced window in which no
operation ran on the device, in % (1 minus the union of the device
operations' intervals over the window)."""
from benchmark.trace import busy_s


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - busy_s(ctx.trace) / ctx.trace.window_s)
