"""model_ms (model: models/, train/optim.py): the device time in the traced
window of every device operation that is not one of the port's own
kernels (cuBLAS products, PyTorch's element-wise and reduction kernels,
copies and sets), in ms an epoch."""
from benchmark.trace import base_name


def read(ctx):
    if ctx.trace is None or not ctx.traced_epochs:
        return None
    ops = [o for o in ctx.trace.device
           if base_name(o.name) not in ctx.own_kernels]
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) / 1e3 / ctx.traced_epochs
