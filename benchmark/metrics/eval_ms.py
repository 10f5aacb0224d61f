"""eval_ms (whole step): device ms an epoch of the `eval` spans
(`Trainer.eval_step`: the evaluation forward and its metrics) in the
traced call, between each span's stream events."""
from benchmark.program_spans import device_ms_per_epoch


def read(ctx):
    return device_ms_per_epoch(ctx, "eval")
