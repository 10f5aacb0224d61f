"""The stream CUDA kernels over a StreamPlan's edge chunks (source in
`csrc/stream.cu`, plain versions in `ops/stream.py`):
- `stream_spmm`: y = A_w x (counterpart of
  `spgemm_gnn_tpu/kernels/stream_pallas.py::stream_spmm`);
- `stream_cbsr_spmm`: the same product with x given as one CBSR record per
  node (`ops.maxk.cbsr_records`; counterpart of
  `stream_pallas.py::stream_spmm_cbsr`).
Both load the plan's hot set (`StreamPlan.hot_set`, at the call's row size)
with an L2 evict-last hint. `stream_spmm_at` and `stream_cbsr_spmm_at` take
the hot-set budget and the kernels' launch shape as arguments, for
`utils/stream_sweep.py` and chip_smoke.py; the wrappers run them at the
defaults below.

Each also takes the 16-bit feature stream's input: bf16 rows for
`stream_spmm`, records with bf16 values (`value_dtype`) for
`stream_cbsr_spmm`, launching the bf16 form of its kernel (`stream_spmm_bf16`,
`stream_cbsr_spmm_bf16`, counted under those names); the sums and y stay f32.
With `out_dtype=torch.bfloat16` (the 16-bit model, `--dtype bfloat16`; bf16
input only) they launch the bf16-output forms (`stream_spmm_bf16_out`,
`stream_cbsr_spmm_bf16_out`): the same sums, y rounded once to bf16 where a
row's sum is whole, then times bf16(post) in bf16.

`stream_sspmm` is the sampled backward of a MaxK aggregation on bf16
messages (B3 on Aᵀ, then B4's channel sampling, as one kernel pair): for
each row v of the plan (Aᵀ) only the k channels ch[v] that v's MaxK kept,
dx[v, ch[v, j]] = post[v] · Σ_u m[u, ch[v, j]], zeros elsewhere, each sum
bit for bit `stream_spmm`'s at that channel (`stream_sspmm_bf16`, and with
a bf16 output `stream_sspmm_bf16_out`, `stream_spmm_bf16_out`'s). Pass 1
walks A once (the forward plan): each edge's k terms go to a 2k-byte slot
at the edge's position in Aᵀ's order (`StreamPlan.transpose_positions`);
pass 2 is B3's walk on Aᵀ over those slots. `stream_sspmm_at` runs either
pass alone and `stream_ksample_at` the k-channel gather probe (the same
sums, gathered from the messages), for utils/stream_sweep.py and
chip_smoke.py.
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels.spmm import (MAX_CBSR_DIM, MAX_DIM,
                                               check_out_dtype, check_sampled)
from spgemm_gnn_tpu_torch.ops.maxk import packed_channel_words, record_words
from spgemm_gnn_tpu_torch.ops.stream import (stream_cbsr_spmm_plain,
                                             stream_spmm_plain,
                                             stream_sspmm_plain)

# The launch shapes the kernels are built for, keyed by a row's 16-byte
# slices per lane (row bytes <= 512, 1024, 2048, 4096: f32 dim 256 and bf16
# dim 512 share a key) for stream_spmm's rows fetched ahead, and by value
# slots per lane (k <= 32, 64, 128, 256) for stream_cbsr_spmm's edges loaded
# ahead: BATCHES for records of f32 values (into registers), BATCHES16 for
# records of bf16 ones (into a ring of 4 KB of shared memory a warp: 32
# records of 128 B at k <= 32). The first entry is the default: at dim 256
# and k 32, the best of utils/stream_sweep.py on the ogbn-products stand-in
# (PERF.md); wider rows keep about 8 KB of registers in flight per warp.
DEPTHS = {1: (8, 4, 16), 2: (8, 4, 16), 4: (4,), 8: (2,)}
BATCHES = {1: (8, 4, 16), 2: (8,), 4: (4,), 8: (4,)}
BATCHES16 = {1: (32,), 2: (16,), 4: (8,), 8: (4,)}
# stream_sspmm_at's timing variants of pass 1 -> the C entry point's mode
VARIANTS_SAMPLED = {None: 0, "no_store": 1, "in_order": 2, "no_ids": 3}


STREAM_DTYPES = (torch.float32, torch.bfloat16)

# stream_cbsr_spmm_at's timing variants -> the C entry point's argument
# (f32 records: `scatter`; bf16 records: `mode`)
VARIANTS = {None: 1, "scatter_free": 0}
VARIANTS16 = {None: 0, "no_load": 1, "no_scatter": 2}


def _slices(n: int) -> int:
    """Per lane: ceil(n / 32) rounded up to a power of two (the kernels'
    template argument)."""
    return 1 if n <= 32 else 2 if n <= 64 else 4 if n <= 128 else 8


def _require_plan(plan, dev: torch.device, n_src: int,
                  pre: torch.Tensor | None, post: torch.Tensor | None) -> None:
    n_rows, n_chunks = plan.num_rows, plan.num_chunks
    _build.require_sources(plan, n_src, "stream plan")
    _build.require(plan.indptr, "indptr", torch.int32, dev, (n_rows + 1,))
    _build.require(plan.indices, "indices", torch.int32, dev, (None,))
    _build.require(plan.chunk_row0, "chunk_row0", torch.int32, dev,
                   (n_chunks,))
    _build.require(plan.carry_rows, "carry_rows", torch.int32, dev, (None,))
    if pre is not None:
        _build.require(pre, "pre", torch.float32, dev, (n_src,))
    if post is not None:
        _build.require(post, "post", torch.float32, dev, (n_rows,))


def _outputs(plan, dim: int, dev: torch.device, out16: bool
             ) -> tuple[torch.Tensor, ...]:
    """y and its scratch, in the C call's order (held until the call)."""
    # per chunk, the partial sum of a row that began in an earlier chunk
    carry = torch.empty((plan.num_chunks, dim), dtype=torch.float32,
                        device=dev)
    if not out16:
        y = torch.empty((plan.num_rows, dim), dtype=torch.float32, device=dev)
        return y, carry
    y = torch.empty((plan.num_rows, dim), dtype=torch.bfloat16, device=dev)
    # per warp span, the f32 sum of the row that goes on past it
    spans = -(-plan.num_chunks // plan.warp_chunks)
    heads = torch.empty((spans, dim), dtype=torch.float32, device=dev)
    return y, carry, heads


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _choose(value: int | None, allowed: tuple, what: str) -> int:
    if value is None:
        return allowed[0]
    if value not in allowed:
        raise ValueError(f"{what} must be one of {allowed} here; got {value}")
    return value


def _check_rows(x: torch.Tensor) -> None:
    """The 16-bit rows' width rule, on every device: one 16-B load per 8
    channels (the reference's stream needs dim % 8 == 0 for any dtype)."""
    if x.dtype == torch.bfloat16 and x.shape[-1] % 8:
        raise ValueError(f"stream_spmm on bf16 rows needs dim % 8 == 0; got "
                         f"{x.shape[-1]}")


def stream_spmm(plan, x: torch.Tensor, pre: torch.Tensor | None = None,
                post: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y[v] = post[v] · Σ_{u ∈ in(v)} pre[u] · x[u] over the StreamPlan's
    CSR (a None factor is 1); x f32 or bf16 [S, dim] → y f32
    [plan.num_rows, dim], or, with out_dtype bf16 (bf16 x only), y bf16 =
    bf16(bf16(Σ) · bf16(post)). Raises unless S exceeds the plan's
    largest source id (`StreamPlan.max_src`)."""
    _check_rows(x)
    check_out_dtype(x.dtype, out_dtype)
    _build.require_sources(plan, x.shape[0], "stream_spmm")
    if _build.on_cpu(x):
        return stream_spmm_plain(plan, x, pre, post, out_dtype)
    return stream_spmm_at(plan, x, pre, post, out_dtype=out_dtype)


def stream_spmm_at(plan, x: torch.Tensor, pre: torch.Tensor | None = None,
                   post: torch.Tensor | None = None, *,
                   hot_budget: int | None = None,
                   depth: int | None = None,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """`stream_spmm`'s kernel on a CUDA x with the hot set of `hot_budget`
    bytes (None: `stream_tiles.HOT_BUDGET`; 0: none) and `depth` rows
    fetched ahead into registers (None: the default of DEPTHS). Every
    choice gives the same bits."""
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    out16 = check_out_dtype(x.dtype, out_dtype)
    _build.require(x, "x", torch.bfloat16 if bf16 else torch.float32, dev,
                   (None, None))
    _check_rows(x)
    n_src, dim = x.shape
    if dim % 4 or not 4 <= dim <= MAX_DIM:
        raise ValueError(f"stream_spmm needs dim % 4 == 0 and 4 <= dim <= "
                         f"{MAX_DIM}; got {dim}")
    row_bytes = dim * x.element_size()
    depth = _choose(depth, DEPTHS[_slices(row_bytes // 16)], "depth")
    _require_plan(plan, dev, n_src, pre, post)
    _build.require_aligned(x, "x")
    outs = _outputs(plan, dim, dev, out16)
    if plan.num_rows:
        hot = plan.hot_set(row_bytes, hot_budget)
        name = ("stream_spmm_bf16_out" if out16 else
                "stream_spmm_bf16" if bf16 else "stream_spmm")
        with torch.cuda.device(dev):
            status = getattr(_build.library("stream"), name)(
                plan.indptr.data_ptr(), plan.indices.data_ptr(),
                x.data_ptr(), _ptr(pre), _ptr(post),
                plan.chunk_row0.data_ptr(), plan.carry_rows.data_ptr(),
                _ptr(hot.mask), *(t.data_ptr() for t in outs),
                plan.num_rows, plan.num_chunks, plan.carry_rows.numel(),
                plan.num_edges, plan.chunk, dim, depth, plan.warp_chunks,
                _build.stream_of(x))
        _build.check(status, name)
        _build.launches[name] += 1
    return outs[0]



def _check_cbsr(records: torch.Tensor, k: int, dim: int,
                value_dtype: torch.dtype, out_dtype: torch.dtype | None,
                pre: torch.Tensor | None) -> bool:
    """Raise unless the records fit (k, dim, value_dtype) and, for bf16
    values, no pre factor is given; True for a bf16 output, which needs
    bf16 values."""
    if value_dtype not in STREAM_DTYPES:
        raise ValueError(f"record values are f32 or bf16; got {value_dtype}")
    out16 = check_out_dtype(value_dtype, out_dtype, "record values")
    if dim > MAX_CBSR_DIM:
        raise ValueError(f"stream_cbsr_spmm supports dim <= {MAX_CBSR_DIM} "
                         f"(uint8 channel ids); got dim={dim}")
    if not 1 <= k < dim:
        raise ValueError(f"stream_cbsr_spmm needs 1 <= k < dim; got k={k}, "
                         f"dim={dim}")
    width = record_words(k, dim, value_dtype)
    if records.dim() != 2 or records.shape[1] != width:
        raise ValueError(f"records has shape {tuple(records.shape)}, expected "
                         f"[S, {width}] (cbsr_records of k {value_dtype} "
                         f"values)")
    if pre is not None and value_dtype == torch.bfloat16:
        raise ValueError("stream_cbsr_spmm on bf16 values takes no pre "
                         "factor: fold it into the values (round_rows)")
    return out16


def stream_cbsr_spmm(plan, records: torch.Tensor, k: int, dim: int,
                     pre: torch.Tensor | None = None,
                     post: torch.Tensor | None = None,
                     value_dtype: torch.dtype = torch.float32,
                     out_dtype: torch.dtype | None = None
                     ) -> torch.Tensor:
    """y = post ⊙ A (pre ⊙ cbsr(values, channels)) over the StreamPlan:
    records int32 [S, record_words(k, dim, value_dtype)] from
    `ops.maxk.cbsr_records(values, channels, dim)` with values of
    `value_dtype` (f32, or bf16 for the 16-bit stream and model; channels
    distinct within a row) → y f32 [plan.num_rows, dim], equal by value to
    `stream_spmm` on the densified input; out_dtype bf16 (bf16 values
    only) as in `stream_spmm`. bf16 values take no pre factor (the planner
    rounds it into them). Needs 1 <= k < dim <= 256, on the CPU too: the
    ids are packed as uint8, as in the JAX kernel."""
    _check_cbsr(records, k, dim, value_dtype, out_dtype, pre)
    _build.require_sources(plan, records.shape[0], "stream_cbsr_spmm")
    if _build.on_cpu(records):
        return stream_cbsr_spmm_plain(plan, records, k, dim, pre, post,
                                      value_dtype, out_dtype)
    return stream_cbsr_spmm_at(plan, records, k, dim, pre, post,
                               value_dtype=value_dtype, out_dtype=out_dtype)


def stream_cbsr_spmm_at(plan, records: torch.Tensor, k: int, dim: int,
                        pre: torch.Tensor | None = None,
                        post: torch.Tensor | None = None, *,
                        hot_budget: int | None = None,
                        batch: int | None = None,
                        variant: str | None = None,
                        value_dtype: torch.dtype = torch.float32,
                        out_dtype: torch.dtype | None = None
                        ) -> torch.Tensor:
    """`stream_cbsr_spmm`'s kernel on CUDA records with the hot set of
    `hot_budget` bytes (None: `stream_tiles.HOT_BUDGET`; 0: none), `batch`
    edges loaded ahead (None: the default of BATCHES, or BATCHES16 for
    bf16 values); every choice gives the same bits. `variant` names one of
    utils/stream_sweep.py's timing variants, whose y is wrong by design (k
    <= 32): "scatter_free" for f32 values (values summed in registers, no
    shared-memory scatter); for bf16 values "no_load" (the records of the
    first stages only: the walk and the scatter) and "no_scatter" (records
    loaded, nothing scattered: the walk and the gather)."""
    out16 = _check_cbsr(records, k, dim, value_dtype, out_dtype, pre)
    dev = records.device
    bf16 = value_dtype == torch.bfloat16
    if dim % 4 or dim < 4:
        raise ValueError(f"stream_cbsr_spmm needs dim % 4 == 0; got {dim}")
    batch = _choose(batch, (BATCHES16 if bf16 else BATCHES)[_slices(k)],
                    "batch")
    codes = VARIANTS16 if bf16 else VARIANTS
    if variant not in codes:
        raise ValueError(f"variant must be one of {tuple(codes)} for "
                         f"{value_dtype} values; got {variant!r}")
    if variant is not None and _slices(k) != 1:
        raise ValueError("the timing variants are built for k <= 32")
    n_src = records.shape[0]
    width = record_words(k, dim, value_dtype)
    _build.require(records, "records", torch.int32, dev, (n_src, width))
    _build.require_aligned(records, "records")
    _require_plan(plan, dev, n_src, pre, post)
    outs = _outputs(plan, dim, dev, out16)
    if plan.num_rows:
        hot = plan.hot_set(4 * width, hot_budget)
        name = ("stream_cbsr_spmm_bf16_out" if out16 else
                "stream_cbsr_spmm_bf16" if bf16 else "stream_cbsr_spmm")
        args = (plan.indptr.data_ptr(), plan.indices.data_ptr(),
                records.data_ptr(), _ptr(pre), _ptr(post),
                plan.chunk_row0.data_ptr(), plan.carry_rows.data_ptr(),
                _ptr(hot.mask), *(t.data_ptr() for t in outs),
                plan.num_rows, plan.num_chunks, plan.carry_rows.numel(),
                plan.num_edges, plan.chunk, k,
                *(() if bf16 else (packed_channel_words(k, dim),)), dim,
                batch, plan.warp_chunks)
        with torch.cuda.device(dev):
            fn = getattr(_build.library("stream"), name)
            status = fn(*args, codes[variant], _build.stream_of(records))
        _build.check(status, name)
        _build.launches[name] += 1
    return outs[0]


def stream_cbsr16_attrs(k: int, dim: int, batch: int | None = None,
                        variant: str | None = None,
                        out16: bool = False) -> dict:
    """Registers and local (spill) bytes a thread, and resident blocks of
    256 threads (and warps) an SM, of the kernel that `stream_cbsr_spmm`
    runs on bf16 records at (k, dim, batch, variant), with a bf16 output if
    `out16`: for utils/stream_sweep.py and chip_smoke.py. Needs the card."""
    batch = _choose(batch, BATCHES16[_slices(k)], "batch")
    out = torch.zeros(3, dtype=torch.int32)
    status = _build.library("stream").stream_cbsr16_attrs(
        k, dim, batch, VARIANTS16[variant], int(out16), out.data_ptr())
    _build.check(status, "stream_cbsr16_attrs")
    regs, local, blocks = out.tolist()
    return dict(regs=regs, local_bytes=local, blocks_per_sm=blocks,
                warps_per_sm=blocks * 8)


def stream_sspmm(plan, fwd_plan, m: torch.Tensor, ch: torch.Tensor,
                 post: torch.Tensor | None = None,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """dx[v, c] = post[v] · Σ_{u ∈ in(v)} m[u, c] for the k channels c =
    ch[v, :] of each row v of `plan` (the transpose of `fwd_plan`'s CSR),
    0 at v's other channels: m bf16 [S, dim] (the messages, a pre factor
    already in them), ch uint8 [plan.num_rows, k] (distinct within a row,
    from `kernels.maxk.maxk_fwd(..., with_ids=True)`) → dx f32
    [plan.num_rows, dim], or with out_dtype bf16, bf16(bf16(Σ) ·
    bf16(post)). At each kept channel the bits of `stream_spmm(plan, m,
    None, post, out_dtype)`."""
    check_sampled(plan, m, ch, out_dtype, "stream_sspmm")
    _build.require_sources(plan, m.shape[0], "stream_sspmm")
    if _build.on_cpu(m):
        return stream_sspmm_plain(plan, m, ch, post, out_dtype)
    return stream_sspmm_at(plan, fwd_plan, m, ch, post, out_dtype=out_dtype)


def _sampled_outputs(plan, dim: int, kw: int, dev: torch.device,
                     out16: bool) -> tuple[torch.Tensor, ...]:
    """dx (dense) and its compact scratch: the carry slots and span heads
    of kw floats (k padded to a multiple of 4)."""
    y = torch.empty((plan.num_rows, dim),
                    dtype=torch.bfloat16 if out16 else torch.float32,
                    device=dev)
    carry = torch.empty((plan.num_chunks, kw), dtype=torch.float32,
                        device=dev)
    spans = -(-plan.num_chunks // plan.warp_chunks)
    heads = torch.empty((spans, kw), dtype=torch.float32, device=dev)
    return y, carry, heads


def new_slots(n_edges: int, k: int, dev: torch.device) -> torch.Tensor:
    """stream_sspmm's slot buffer: bf16 [n_edges, k], in a flat buffer 16
    bytes longer (pass 2 copies whole 16-byte words)."""
    return torch.empty(n_edges * k + 8, dtype=torch.bfloat16,
                       device=dev)[:n_edges * k].view(n_edges, k)


def stream_sspmm_at(plan, fwd_plan, m: torch.Tensor, ch: torch.Tensor,
                    post: torch.Tensor | None = None, *,
                    out_dtype: torch.dtype | None = None,
                    passes: tuple = (1, 2),
                    slots: torch.Tensor | None = None,
                    variant: str | None = None) -> torch.Tensor:
    """`stream_sspmm`'s kernels on CUDA tensors. `passes` (1,) runs pass 1
    alone and returns the slots (into `slots`, from `new_slots`, when
    given); (2,) runs pass 2 alone on `slots` (pass 1's) and returns dx.
    `variant` names a timing variant of pass 1 for utils/stream_sweep.py
    (passes (1,) only, k 20 to 32 and a multiple of 4; wrong slots by
    design): "no_store" (no slot stored), "in_order" (each slot at its own
    edge) or "no_ids" (no id loaded)."""
    out16 = check_sampled(plan, m, ch, out_dtype, "stream_sspmm")
    dev = m.device
    n_src, dim = m.shape
    k = ch.shape[1]
    if passes not in ((1, 2), (1,), (2,)):
        raise ValueError(f"passes must be (1, 2), (1,) or (2,); got {passes}")
    if variant not in VARIANTS_SAMPLED:
        raise ValueError(f"variant must be one of {tuple(VARIANTS_SAMPLED)}; "
                         f"got {variant!r}")
    if variant is not None and (passes != (1,) or k % 4
                                or not 16 < k <= 32):
        raise ValueError(f"variant {variant!r} runs pass 1 alone, at k 20, "
                         f"24, 28 or 32")
    _build.require(ch, "ch", torch.uint8, dev, (plan.num_rows, k))
    _build.require(m, "m", torch.bfloat16, dev, (fwd_plan.num_rows, dim))
    _build.require_aligned(m, "m")
    _require_plan(plan, dev, n_src, None, post)
    _require_plan(fwd_plan, dev, plan.num_rows, None, None)
    if fwd_plan.num_edges != plan.num_edges:
        raise ValueError("stream_sspmm: plan must be fwd_plan's transpose")
    n_edges = plan.num_edges
    if slots is None:
        slots = new_slots(n_edges, k, dev)
    _build.require(slots, "slots", torch.bfloat16, dev, (n_edges, k))
    if slots.untyped_storage().nbytes() - slots.storage_offset() * 2 < (
            n_edges * k * 2 + 16):
        raise ValueError("slots needs 16 bytes past its end (new_slots)")
    lib = _build.library("stream")
    stream = _build.stream_of(m)
    name = "stream_sspmm_bf16_out" if out16 else "stream_sspmm_bf16"
    with torch.cuda.device(dev):
        if 1 in passes:
            perm = plan.transpose_positions(fwd_plan)
            status = lib.sspmm_slots_bf16(
                fwd_plan.indptr.data_ptr(), fwd_plan.indices.data_ptr(),
                fwd_plan.chunk_row0.data_ptr(), perm.data_ptr(),
                m.data_ptr(), ch.data_ptr(), slots.data_ptr(),
                fwd_plan.num_rows, fwd_plan.num_chunks, n_edges,
                fwd_plan.chunk, fwd_plan.warp_chunks, dim, k,
                VARIANTS_SAMPLED[variant], stream)
            _build.check(status, "sspmm_slots_bf16")
            if passes == (1,):
                return slots
        outs = _sampled_outputs(plan, dim, 4 * -(-k // 4), dev, out16)
        if plan.num_rows:
            status = lib.stream_sspmm_bf16(
                plan.indptr.data_ptr(), plan.indices.data_ptr(),
                plan.chunk_row0.data_ptr(), plan.carry_rows.data_ptr(),
                slots.data_ptr(), None, None, ch.data_ptr(), _ptr(post),
                None, *(t.data_ptr() for t in outs), plan.num_rows,
                plan.num_chunks, plan.carry_rows.numel(), n_edges,
                plan.chunk, plan.warp_chunks, dim, k, int(out16), 0,
                stream)
            _build.check(status, name)
            _build.launches[name] += 1
    return outs[0]


def stream_ksample_at(plan, m: torch.Tensor, ch: torch.Tensor,
                      edge_row: torch.Tensor,
                      post: torch.Tensor | None = None, *,
                      out_dtype: torch.dtype | None = None,
                      hot_budget: int | None = None) -> torch.Tensor:
    """The k-channel gather probe (k <= 32): `stream_sspmm`'s sums gathered
    on B3's walk from the messages, lane j loading m[u, ch[v, j]] for each
    edge u -> v (edge_row int32 [E], each edge's row v of the plan), with
    the plan's hot set at the messages' row size. The same bits as
    `stream_sspmm`; for utils/stream_sweep.py's probe, never on the path."""
    out16 = check_sampled(plan, m, ch, out_dtype, "stream_sspmm")
    dev = m.device
    n_src, dim = m.shape
    k = ch.shape[1]
    if _slices(k) != 1:
        raise ValueError("the gather probe is built for k <= 32")
    _build.require(edge_row, "edge_row", torch.int32, dev, (plan.num_edges,))
    _build.require(ch, "ch", torch.uint8, dev, (plan.num_rows, k))
    _build.require(m, "m", torch.bfloat16, dev, (None, dim))
    _require_plan(plan, dev, n_src, None, post)
    outs = _sampled_outputs(plan, dim, 4 * -(-k // 4), dev, out16)
    if plan.num_rows:
        hot = plan.hot_set(2 * dim, hot_budget)
        with torch.cuda.device(dev):
            status = _build.library("stream").stream_sspmm_bf16(
                plan.indptr.data_ptr(), plan.indices.data_ptr(),
                plan.chunk_row0.data_ptr(), plan.carry_rows.data_ptr(), None,
                m.data_ptr(), edge_row.data_ptr(), ch.data_ptr(), _ptr(post),
                _ptr(hot.mask), *(t.data_ptr() for t in outs), plan.num_rows,
                plan.num_chunks, plan.carry_rows.numel(), plan.num_edges,
                plan.chunk, plan.warp_chunks, dim, k, int(out16), 1,
                _build.stream_of(m))
        _build.check(status, "stream_ksample_bf16")
        _build.launches["stream_ksample_bf16"] += 1
    return outs[0]
