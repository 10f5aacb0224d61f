"""agg_span_ms (kernels): device ms an epoch inside the `aggregate` spans
(`kernels/api.py::aggregate`) and the `aggregate.backward` spans (the
backward of the autograd Functions it reaches) in the traced call: the
aggregation measured where the program calls it, the counterpart of
`agg_ms`, which sums its kernels in the device trace."""
from benchmark.program_spans import device_ms_per_epoch


def read(ctx):
    return device_ms_per_epoch(ctx, "aggregate", "aggregate.backward")
