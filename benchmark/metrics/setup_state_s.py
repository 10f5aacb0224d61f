"""setup_state_s (set-up): self seconds of the `setup.state` span
(`Trainer.init_state`: the model, its weights and the optimizer)."""
from benchmark.program_spans import self_s


def read(ctx):
    return self_s("setup.state")
