"""The `csr_spmm` CUDA kernel: y = A_w x over a CSRPlan's schedule, edge-
balanced row segments over L2-sized source blocks (counterpart of
`spgemm_gnn_tpu/kernels/spgemm_pallas.py::planned_spmm`, the windowed
regime; source in `csrc/spmm.cu`, schedule in `graphs/tiles.py`, plain
version in `ops/spmm.py`). The autograd pair around it is
`kernels/planned.py::Aggregate`.

On bf16 rows (the 16-bit feature stream) it launches the bf16 form of the
kernel, `csr_spmm_bf16` (counted under that name): 16-byte loads of 8
channels widened to f32, f32 sums and y, and a schedule sized for 2-byte
channels.
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.ops.spmm import csr_blocked_plain

MAX_DIM = 1024   # a row's accumulators live in one warp's registers


def csr_spmm(plan: CSRPlan, x: torch.Tensor, pre: torch.Tensor | None = None,
             post: torch.Tensor | None = None) -> torch.Tensor:
    """y[v] = post[v] · Σ_{u ∈ in(v)} pre[u] · x[u] (a None factor is 1)
    over the plan's CSR (R rows), through its schedule for x's shape and row
    bytes (built at the first call with them, then kept on the plan).

    x f32 or bf16 [S, dim] → y f32 [R, dim]. Indices are trusted to lie in
    [0, S): graphs come from `from_edges`.
    """
    bf16 = x.dtype == torch.bfloat16
    if bf16 and x.shape[-1] % 8:
        raise ValueError(f"csr_spmm on bf16 rows needs dim % 8 == 0; got "
                         f"{x.shape[-1]}")
    sched = plan.schedule(x.shape[0], x.shape[1], x.element_size())
    if _build.on_cpu(x):
        return csr_blocked_plain(sched.block_indptr, sched.indices, x, pre,
                                 post)
    dev = x.device
    _build.require(x, "x", torch.bfloat16 if bf16 else torch.float32, dev,
                   (None, None))
    n_src, dim = x.shape
    if dim % 4 or not 4 <= dim <= MAX_DIM:
        raise ValueError(f"csr_spmm needs dim % 4 == 0 and 4 <= dim <= "
                         f"{MAX_DIM}; got {dim}")
    n_rows = plan.num_rows
    for t, what in ((sched.indices, "indices"), (sched.seg, "seg"),
                    (sched.fix, "fix")):
        _build.require(t, what, torch.int32, dev)
    if pre is not None:
        _build.require(pre, "pre", torch.float32, dev, (n_src,))
    if post is not None:
        _build.require(post, "post", torch.float32, dev, (n_rows,))
    _build.require_aligned(x, "x")
    y = torch.empty((n_rows, dim), dtype=torch.float32, device=dev)
    scratch = torch.empty((sched.n_slots, dim), dtype=torch.float32,
                          device=dev) if sched.n_slots else None
    if n_rows:
        name = "csr_spmm_bf16" if bf16 else "csr_spmm"
        with torch.cuda.device(dev):
            status = getattr(_build.library("spmm"), name)(
                sched.seg.data_ptr(), sched.fix.data_ptr(),
                sched.pass_seg.data_ptr(), sched.pass_fix.data_ptr(),
                sched.nb, sched.indices.data_ptr(), x.data_ptr(),
                None if pre is None else pre.data_ptr(),
                None if post is None else post.data_ptr(), y.data_ptr(),
                None if scratch is None else scratch.data_ptr(), dim,
                _build.stream_of(x))
        _build.check(status, name)
        _build.launches[name] += 1
    return y
