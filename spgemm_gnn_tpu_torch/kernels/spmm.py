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
CBSR record per source node (`ops/maxk.py::cbsr_records`), through the
schedule of the dense form of the same width and value type: the kernels
copy each edge's record instead of its dense row and give the dense
form's y on the densified rows bit for bit. On f32 records (the f32 path)
it launches `csr_cbsr_spmm` (counted under that name), which takes the pre
factor per edge as `csr_spmm` does; on bf16 records (the pre factor
already in them) `csr_cbsr_spmm_bf16`, and with `out_dtype=torch.bfloat16`
`csr_cbsr_spmm_bf16_out` (counted under that name): the same sums, then
`round_out`, as `csr_spmm_bf16_out`. Plain version: `ops/spmm.py::
csr_cbsr_plain`.

`csr_sspmm` is MaxK's backward on a windowed plan (the sampled backward):
the product on Aᵀ at each row's k kept channels only, 0 at the others,
through the dense form's schedule, `csr_spmm`'s bits at the kept channels.
On f32 messages (the raw cotangent, with a pre factor applied per edge)
it launches `csr_sspmm`; on bf16 messages (the pre factor already in them)
`csr_sspmm_bf16`, or `csr_sspmm_bf16_out` with a bf16 output, which it
rounds itself (each counted under its name). Plain version: `ops/spmm.py::
csr_sspmm_plain`.
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.ops.maxk import record_words
from spgemm_gnn_tpu_torch.ops.spmm import (csr_blocked_plain, csr_cbsr_plain,
                                           csr_sspmm_plain)

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


def check_sampled(plan, m: torch.Tensor, ch: torch.Tensor,
                  out_dtype: torch.dtype | None, what: str,
                  pre: torch.Tensor | None = None,
                  f32: bool = False) -> bool:
    """Raise unless m is bf16 (or, with `f32`, f32) [S, dim] with dim <=
    256 and dim % 8 == 0 (dim % 4 == 0 for f32), ch uint8 [plan.num_rows,
    k] with 1 <= k < dim, and a pre factor comes only with f32 messages
    (bf16 ones carry it), naming the sampled backward `what`; True for a
    bf16 output."""
    dtypes = (torch.float32, torch.bfloat16) if f32 else (torch.bfloat16,)
    if m.dtype not in dtypes or m.dim() != 2:
        raise ValueError(f"{what} takes {'f32 or ' if f32 else ''}bf16 "
                         f"messages [S, dim]; got {m.dtype} "
                         f"{tuple(m.shape)}")
    out16 = check_out_dtype(m.dtype, out_dtype)
    dim = m.shape[1]
    step = 8 if m.dtype == torch.bfloat16 else 4
    if dim % step or not step <= dim <= MAX_CBSR_DIM:
        raise ValueError(f"{what} needs dim % {step} == 0 and {step} <= dim "
                         f"<= {MAX_CBSR_DIM} (uint8 channel ids) on "
                         f"{m.dtype} messages; got {dim}")
    if (ch.dtype != torch.uint8 or ch.dim() != 2
            or ch.shape[0] != plan.num_rows or not 1 <= ch.shape[1] < dim):
        raise ValueError(f"{what} takes channel ids uint8 "
                         f"[{plan.num_rows}, k] with 1 <= k < {dim}; got "
                         f"{ch.dtype} {tuple(ch.shape)}")
    if pre is not None and m.dtype == torch.bfloat16:
        raise ValueError(f"{what}: bf16 messages carry their pre factor; "
                         f"give pre with f32 messages only")
    return out16


def csr_spmm(plan: CSRPlan, x: torch.Tensor, pre: torch.Tensor | None = None,
             post: torch.Tensor | None = None,
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y[v] = post[v] · Σ_{u ∈ in(v)} pre[u] · x[u] (a None factor is 1)
    over the plan's CSR (R rows), through its schedule for x's shape and row
    bytes (built at the first call with them, then kept on the plan).

    x f32 or bf16 [S, dim] → y f32 [R, dim]; with out_dtype bf16 (bf16 x
    only), y bf16 = bf16(bf16(Σ) · bf16(post)). Raises unless S exceeds
    the plan's largest source id (`CSRPlan.max_src`).
    """
    bf16 = x.dtype == torch.bfloat16
    out16 = check_out_dtype(x.dtype, out_dtype)
    if bf16 and x.shape[-1] % 8:
        raise ValueError(f"csr_spmm on bf16 rows needs dim % 8 == 0; got "
                         f"{x.shape[-1]}")
    _build.require_sources(plan, x.shape[0], "csr_spmm")
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
    _require_schedule(plan, sched, dev, post)
    if pre is not None:
        _build.require(pre, "pre", torch.float32, dev, (n_src,))
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
    scratch = _scratch(sched, dim, dev)
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


def _scratch(sched, width: int, dev: torch.device) -> torch.Tensor | None:
    """The split runs' slots of a pass: f32 [n_slots, width], or None."""
    return torch.empty((sched.n_slots, width), dtype=torch.float32,
                       device=dev) if sched.n_slots else None


def _require_schedule(plan: CSRPlan, sched, dev: torch.device,
                      post: torch.Tensor | None) -> None:
    for t, what in ((sched.indices, "indices"), (sched.seg, "seg"),
                    (sched.fix, "fix")):
        _build.require(t, what, torch.int32, dev)
    if post is not None:
        _build.require(post, "post", torch.float32, dev, (plan.num_rows,))


def _check_records(records: torch.Tensor, k: int, dim: int,
                   value_dtype: torch.dtype, pre: torch.Tensor | None
                   ) -> None:
    if value_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"csr_cbsr_spmm takes f32 or bf16 record values; "
                         f"got {value_dtype}")
    step = 8 if value_dtype == torch.bfloat16 else 4
    if not 1 <= k < dim or dim > MAX_CBSR_DIM or dim % step:
        raise ValueError(f"csr_cbsr_spmm needs 1 <= k < dim <= "
                         f"{MAX_CBSR_DIM} and dim % {step} == 0 on "
                         f"{value_dtype} records; got k={k}, dim={dim}")
    width = record_words(k, dim, value_dtype)
    if records.dim() != 2 or records.shape[1] != width:
        raise ValueError(f"records has shape {tuple(records.shape)}, expected "
                         f"[S, {width}] (cbsr_records of k {value_dtype} "
                         f"values)")
    if pre is not None and value_dtype == torch.bfloat16:
        raise ValueError("csr_cbsr_spmm: bf16 records carry their pre "
                         "factor; give pre with f32 records only")


def csr_cbsr_spmm(plan: CSRPlan, records: torch.Tensor, k: int, dim: int,
                  post: torch.Tensor | None = None,
                  out_dtype: torch.dtype | None = None, *,
                  pre: torch.Tensor | None = None,
                  value_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = post ⊙ A (pre ⊙ densify(records)) over the plan's CSR (R rows):
    records int32 [S, record_words(k, dim, value_dtype)] from `ops.maxk.
    cbsr_records` of k values of `value_dtype` and their channels (distinct
    within a row) → y f32 [R, dim], through the schedule of rows of width
    dim and that type: `csr_spmm(plan, densified, pre, post)`'s y bit for
    bit. f32 values take an optional pre factor f32 [S]; bf16 values carry
    it already (none is taken), and out_dtype bf16 gives y bf16 =
    bf16(bf16(Σ) · bf16(post)). Needs 1 <= k < dim <= 256 and dim % 8 == 0
    (bf16) or dim % 4 == 0 (f32), on the CPU too."""
    out16 = check_out_dtype(value_dtype, out_dtype, "record values")
    _check_records(records, k, dim, value_dtype, pre)
    _build.require_sources(plan, records.shape[0], "csr_cbsr_spmm")
    f32 = value_dtype == torch.float32
    sched = plan.schedule(records.shape[0], dim, 4 if f32 else 2)
    if _build.on_cpu(records):
        return csr_cbsr_plain(sched.block_indptr, sched.indices, records, k,
                              dim, post, out_dtype, pre=pre,
                              value_dtype=value_dtype)
    dev = records.device
    _build.require(records, "records", torch.int32, dev, (None, None))
    _build.require_aligned(records, "records")
    _require_schedule(plan, sched, dev, post)
    if not f32:
        return _launch(plan, sched, "csr_cbsr_spmm_bf16", records,
                       (records.data_ptr(),), post, out16, (k, dim))
    if pre is not None:
        _build.require(pre, "pre", torch.float32, dev, (records.shape[0],))
    return _launch(plan, sched, "csr_cbsr_spmm", records,
                   (records.data_ptr(),
                    None if pre is None else pre.data_ptr()),
                   post, False, (k, dim))


def csr_sspmm(plan: CSRPlan, m: torch.Tensor, ch: torch.Tensor,
              post: torch.Tensor | None = None,
              out_dtype: torch.dtype | None = None, *,
              pre: torch.Tensor | None = None) -> torch.Tensor:
    """dx[r, c] = post[r] · Σ_{u ∈ in(r)} pre[u] · m[u, c] for the k
    channels c = ch[r, :] of each row r of the plan's CSR (Aᵀ of the
    forward), 0 at r's other channels: m f32 or bf16 [S, dim] (the
    messages: the f32 cotangent, with an optional pre factor f32 [S]; or
    bf16 messages, the pre factor already in them), ch uint8
    [plan.num_rows, k] (distinct within a row, from
    `kernels.maxk.maxk_fwd(..., with_ids=True)`) → dx f32 [R, dim], or for
    bf16 messages with out_dtype bf16, bf16(bf16(Σ) · bf16(post)). At each
    kept channel the bits of `csr_spmm(plan, m, pre, post, out_dtype)`,
    through the same schedule."""
    out16 = check_sampled(plan, m, ch, out_dtype, "csr_sspmm", pre,
                          f32=True)
    n_src, dim = m.shape
    _build.require_sources(plan, n_src, "csr_sspmm")
    sched = plan.schedule(n_src, dim, m.element_size())
    if _build.on_cpu(m):
        return csr_sspmm_plain(sched.block_indptr, sched.indices, m, ch,
                               post, out_dtype, pre=pre)
    dev = m.device
    k = ch.shape[1]
    _build.require(m, "m", m.dtype, dev, (n_src, dim))
    _build.require(ch, "ch", torch.uint8, dev, (plan.num_rows, k))
    _require_schedule(plan, sched, dev, post)
    f32 = m.dtype == torch.float32
    if pre is not None:
        _build.require(pre, "pre", torch.float32, dev, (n_src,))
    n_rows = plan.num_rows
    y = torch.empty((n_rows, dim),
                    dtype=torch.bfloat16 if out16 else torch.float32,
                    device=dev)
    acc = torch.empty((n_rows, k), dtype=torch.float32, device=dev)
    scratch = _scratch(sched, k, dev)
    if not n_rows:
        return y
    name = ("csr_sspmm" if f32 else
            "csr_sspmm_bf16_out" if out16 else "csr_sspmm_bf16")
    head = (sched.seg.data_ptr(), sched.fix.data_ptr(),
            sched.pass_seg.data_ptr(), sched.pass_fix.data_ptr(), sched.nb,
            sched.indices.data_ptr(), m.data_ptr())
    tail = (ch.data_ptr(), None if post is None else post.data_ptr(),
            acc.data_ptr(), None if scratch is None else scratch.data_ptr(),
            y.data_ptr(), k, dim)
    with torch.cuda.device(dev):
        lib = _build.library("spmm")
        if f32:
            status = lib.csr_sspmm(*head,
                                   None if pre is None else pre.data_ptr(),
                                   *tail, _build.stream_of(m))
        else:
            status = lib.csr_sspmm_bf16(*head, *tail, int(out16),
                                        _build.stream_of(m))
        _build.check(status, name)
    _build.launches[name] += 1
    return y
