"""The `csr_spmm` CUDA kernel: y = A_w x over a CSRPlan's schedule, edge-
balanced row segments over L2-sized source blocks (counterpart of
`spgemm_gnn_tpu/kernels/spgemm_pallas.py::planned_spmm`, the windowed
regime; source in `csrc/spmm.cu`, schedule in `graphs/tiles.py`, plain
version in `ops/spmm.py`). The autograd pair around it is
`kernels/planned.py::Aggregate`.

On bf16 rows (the 16-bit feature stream) it launches the bf16 form of the
kernel, `csr_spmm_bf16` (counted under that name): 16-byte loads of 8
channels widened to f32, f32 sums and y, and a schedule sized for 2-byte
channels. With `out_dtype=torch.bfloat16` (the 16-bit model, `--dtype
bfloat16`) it runs `csr_spmm_bf16_out` (counted under that name): the same
kernel's f32 sums with no post, then `round_out` (`csrc/round.cu`), one
pass that rounds each sum to bf16 and multiplies it by bf16(post) in bf16.

`csr_cbsr_spmm` is the same product on a MaxK (k-sparse) input given as one
bf16 CBSR record per source node (`ops/maxk.py::cbsr_records`), through the
schedule of the dense form (bf16 rows of the same width): the kernel
`csr_cbsr_spmm_bf16` copies each edge's record instead of its dense row and
gives `csr_spmm_bf16`'s y on the densified rows bit for bit. With `out_dtype=torch.bfloat16` it runs
`csr_cbsr_spmm_bf16_out` (counted under that name): the same sums, then
`round_out`, as `csr_spmm_bf16_out`. Plain version: `ops/spmm.py::
csr_cbsr_plain`.
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.ops.maxk import record_words
from spgemm_gnn_tpu_torch.ops.spmm import csr_blocked_plain, csr_cbsr_plain

MAX_DIM = 1024   # a row's accumulators live in one warp's registers
# the CBSR kernels take dim <= 256: f32 records pack their ids as uint8 (the
# JAX kernel's limit), and the bf16-record kernels hold a row's sum in two
# float4s a lane
MAX_CBSR_DIM = 256


def check_out_dtype(in_dtype: torch.dtype, out_dtype: torch.dtype | None,
                    what: str = "rows") -> bool:
    """True for a bf16 output, which needs bf16 input `what` (rows, or a
    CBSR stream's record values); None or f32 is f32."""
    if out_dtype in (None, torch.float32):
        return False
    if out_dtype != torch.bfloat16:
        raise ValueError(f"out_dtype is f32 or bf16; got {out_dtype}")
    if in_dtype != torch.bfloat16:
        raise ValueError(f"a bf16 output needs bf16 {what}; got {in_dtype}")
    return True


def csr_spmm(plan: CSRPlan, x: torch.Tensor, pre: torch.Tensor | None = None,
             post: torch.Tensor | None = None,
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y[v] = post[v] · Σ_{u ∈ in(v)} pre[u] · x[u] (a None factor is 1)
    over the plan's CSR (R rows), through its schedule for x's shape and row
    bytes (built at the first call with them, then kept on the plan).

    x f32 or bf16 [S, dim] → y f32 [R, dim]; with out_dtype bf16 (bf16 x
    only), y bf16 = bf16(bf16(Σ) · bf16(post)). Indices are trusted to lie
    in [0, S): graphs come from `from_edges`.
    """
    bf16 = x.dtype == torch.bfloat16
    out16 = check_out_dtype(x.dtype, out_dtype)
    if bf16 and x.shape[-1] % 8:
        raise ValueError(f"csr_spmm on bf16 rows needs dim % 8 == 0; got "
                         f"{x.shape[-1]}")
    sched = plan.schedule(x.shape[0], x.shape[1], x.element_size())
    if _build.on_cpu(x):
        return csr_blocked_plain(sched.block_indptr, sched.indices, x, pre,
                                 post, out_dtype)
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
    return _launch(plan, sched, "csr_spmm_bf16" if bf16 else "csr_spmm", x,
                   (x.data_ptr(), None if pre is None else pre.data_ptr()),
                   post, out16, (dim,))


def _launch(plan: CSRPlan, sched, kernel: str, src: torch.Tensor,
            inputs: tuple, post: torch.Tensor | None, out16: bool,
            tail: tuple) -> torch.Tensor:
    """Launch `kernel` of the spmm library over the schedule on the source
    tensor `src` (`inputs`: the C call's pointers between the indices and
    post; `tail`: its ints, the last one dim), then, for a bf16 output,
    `round_out` on its f32 sums; counts the launch under `kernel` or its
    `_out` name."""
    dev, n_rows, dim = src.device, plan.num_rows, tail[-1]
    y = torch.empty((n_rows, dim), dtype=torch.float32, device=dev)
    scratch = torch.empty((sched.n_slots, dim), dtype=torch.float32,
                          device=dev) if sched.n_slots else None
    if not n_rows:
        return y.to(torch.bfloat16) if out16 else y
    with torch.cuda.device(dev):
        status = getattr(_build.library("spmm"), kernel)(
            sched.seg.data_ptr(), sched.fix.data_ptr(),
            sched.pass_seg.data_ptr(), sched.pass_fix.data_ptr(), sched.nb,
            sched.indices.data_ptr(), *inputs,
            None if post is None or out16 else post.data_ptr(), y.data_ptr(),
            None if scratch is None else scratch.data_ptr(), *tail,
            _build.stream_of(src))
        _build.check(status, kernel)
        if out16:
            y16 = torch.empty((n_rows, dim), dtype=torch.bfloat16, device=dev)
            status = _build.library("round").round_out(
                y.data_ptr(), None if post is None else post.data_ptr(),
                y16.data_ptr(), n_rows, dim, _build.stream_of(src))
            _build.check(status, "round_out")
            y = y16
    _build.launches[f"{kernel}_out" if out16 else kernel] += 1
    return y


def _check_records(records: torch.Tensor, k: int, dim: int) -> None:
    if not 1 <= k < dim or dim > MAX_CBSR_DIM or dim % 8:
        raise ValueError(f"csr_cbsr_spmm needs 1 <= k < dim <= "
                         f"{MAX_CBSR_DIM} and dim % 8 == 0; got k={k}, "
                         f"dim={dim}")
    width = record_words(k, dim, torch.bfloat16)
    if records.dim() != 2 or records.shape[1] != width:
        raise ValueError(f"records has shape {tuple(records.shape)}, expected "
                         f"[S, {width}] (cbsr_records of k bf16 values)")


def csr_cbsr_spmm(plan: CSRPlan, records: torch.Tensor, k: int, dim: int,
                  post: torch.Tensor | None = None,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y = post ⊙ A · densify(records) over the plan's CSR (R rows):
    records int32 [S, record_words(k, dim, bf16)] from `ops.maxk.
    cbsr_records` of k bf16 values (the pre factor already in them) and
    their channels (distinct within a row) → y f32 [R, dim], through the
    schedule of bf16 rows of width dim: `csr_spmm`'s y on the densified bf16
    rows, bit for bit. out_dtype bf16: y bf16 = bf16(bf16(Σ) · bf16(post)).
    Needs 1 <= k < dim <= 256 and dim % 8 == 0, on the CPU too."""
    out16 = check_out_dtype(torch.bfloat16, out_dtype)
    _check_records(records, k, dim)
    sched = plan.schedule(records.shape[0], dim, 2)
    if _build.on_cpu(records):
        return csr_cbsr_plain(sched.block_indptr, sched.indices, records, k,
                              dim, post, out_dtype)
    dev = records.device
    _build.require(records, "records", torch.int32, dev, (None, None))
    _build.require_aligned(records, "records")
    for t, what in ((sched.indices, "indices"), (sched.seg, "seg"),
                    (sched.fix, "fix")):
        _build.require(t, what, torch.int32, dev)
    if post is not None:
        _build.require(post, "post", torch.float32, dev, (plan.num_rows,))
    return _launch(plan, sched, "csr_cbsr_spmm_bf16", records,
                   (records.data_ptr(),), post, out16, (k, dim))
