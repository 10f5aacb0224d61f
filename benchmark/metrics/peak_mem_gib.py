"""peak_mem_gib (device): `torch.cuda.max_memory_allocated` over the
untraced window, after `reset_peak_memory_stats` at its start, in GiB."""


def read(ctx):
    if not ctx.peak_window_bytes:
        return None
    return ctx.peak_window_bytes / 2**30
