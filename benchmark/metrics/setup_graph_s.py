"""setup_graph_s (set-up): self seconds of the `setup.graph` span
(`Trainer.__init__`: the graph's plans, the features, labels and masks on
the device)."""
from benchmark.program_spans import self_s


def read(ctx):
    return self_s("setup.graph")
