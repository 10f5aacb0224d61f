"""host_syncs_per_epoch (device): the program's waits on the device in the
traced call (the `host_syncs` counter: `Trainer._sync`, the metrics' copy
to the host, a rank's staging), over its epochs."""
from benchmark.program_spans import count_per_epoch


def read(ctx):
    return count_per_epoch(ctx, "host_syncs")
