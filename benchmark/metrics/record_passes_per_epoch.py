"""record_passes_per_epoch (kernels): the record passes `csr_cbsr_spmm`
launched in the traced call (the `record_passes` counter, one a record
pass of `graphs/tiles.py::RecordWalk`), over its epochs. A program without
record walks launches its CBSR kernel once a source block and counts no
record passes: then None."""
from benchmark.program_spans import count_per_epoch


def read(ctx):
    try:
        from spgemm_gnn_tpu_torch.graphs import tiles
    except ImportError:
        return None
    if not hasattr(tiles, "RecordWalk"):
        return None
    return count_per_epoch(ctx, "record_passes")
