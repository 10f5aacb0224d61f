"""setup_first_step_s (set-up): self seconds of the `setup.first_step` span
(the Trainer's first `train_step` on the host clock, kernels and plans built
at first use; no synchronise: the device may still run it after)."""
from benchmark.program_spans import self_s


def read(ctx):
    return self_s("setup.first_step")
