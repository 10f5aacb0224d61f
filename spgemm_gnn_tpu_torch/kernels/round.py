"""The `round_rows` CUDA kernel: y = bf16(pre ⊙ x), the messages of the
16-bit feature stream (source in `csrc/round.cu`, plain version
`ops/spmm.py::round_rows_plain`). In the JAX package this is XLA glue (the
node factor in f32, then `astype(bfloat16)`); the bf16 forms of the
aggregation kernels gather its rows (kernels/planned.py).
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.ops.spmm import round_rows_plain


def round_rows(x: torch.Tensor, pre: torch.Tensor | None = None
               ) -> torch.Tensor:
    """y[r] = bf16(pre[r] · x[r]) (a None factor is 1), the f32 product
    rounded once to nearest even: x f32 [N, w] → y bf16 [N, w], bit-equal to
    `round_rows_plain`."""
    if _build.on_cpu(x):
        return round_rows_plain(x, pre)
    dev = x.device
    x = x.contiguous()
    _build.require(x, "x", torch.float32, dev, (None, None))
    n, width = x.shape
    if pre is not None:
        _build.require(pre, "pre", torch.float32, dev, (n,))
    if width % 8 == 0:
        _build.require_aligned(x, "x")
    y = torch.empty((n, width), dtype=torch.bfloat16, device=dev)
    if n and width:
        with torch.cuda.device(dev):
            status = _build.library("round").round_rows(
                x.data_ptr(), None if pre is None else pre.data_ptr(),
                y.data_ptr(), n, width, _build.stream_of(x))
        _build.check(status, "round_rows")
        _build.launches["round_rows"] += 1
    return y
