"""setup_kernels_s (set-up): self seconds of the `setup.kernels` span
(`kernels/_build.py::build_all`: the kernels built with nvcc where not yet
built, and loaded)."""
from benchmark.program_spans import self_s


def read(ctx):
    return self_s("setup.kernels")
