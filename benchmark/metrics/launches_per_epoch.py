"""launches_per_epoch (dispatch: kernels/api.py, kernels/planned.py): the
port's kernel launches in the traced window, as its wrappers count them
(`kernels/_build.py::launches`), over the window's epochs."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_epochs:
        return None
    return sum(ctx.launches.values()) / ctx.traced_epochs
