"""The `csr_spmm` CUDA kernel: y = A_w x over a CSRPlan's schedule, edge-
balanced row segments over L2-sized source blocks (counterpart of
`spgemm_gnn_tpu/kernels/spgemm_pallas.py::planned_spmm`, the windowed
regime; source in `csrc/spmm.cu`, schedule in `graphs/tiles.py`, plain
version in `ops/spmm.py`). The autograd pair around it is
`kernels/planned.py::Aggregate`.
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
    over the plan's CSR (R rows), through its schedule for x's shape (built
    at the first call with that shape, then kept on the plan).

    x f32 [S, dim] → y f32 [R, dim]. Indices are trusted to lie in [0, S):
    graphs come from `from_edges`.
    """
    sched = plan.schedule(x.shape[0], x.shape[1])
    if _build.on_cpu(x):
        return csr_blocked_plain(sched.block_indptr, sched.indices, x, pre,
                                 post)
    dev = x.device
    _build.require(x, "x", torch.float32, dev, (None, None))
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
        with torch.cuda.device(dev):
            status = _build.library("spmm").csr_spmm(
                sched.seg.data_ptr(), sched.fix.data_ptr(),
                sched.pass_seg.data_ptr(), sched.pass_fix.data_ptr(),
                sched.nb, sched.indices.data_ptr(), x.data_ptr(),
                None if pre is None else pre.data_ptr(),
                None if post is None else post.data_ptr(), y.data_ptr(),
                None if scratch is None else scratch.data_ptr(), dim,
                _build.stream_of(x))
        _build.check(status, "csr_spmm")
        _build.launches["csr_spmm"] += 1
    return y
