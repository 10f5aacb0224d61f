"""bwd_ms (whole step): device ms an epoch of the `step.backward` spans
(`loss.backward()`, and across ranks the gradient all-reduce) in the traced
call, between each span's stream events."""
from benchmark.program_spans import device_ms_per_epoch


def read(ctx):
    return device_ms_per_epoch(ctx, "step.backward")
