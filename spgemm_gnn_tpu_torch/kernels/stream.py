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
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels.spmm import MAX_DIM
from spgemm_gnn_tpu_torch.ops.maxk import packed_channel_words
from spgemm_gnn_tpu_torch.ops.stream import (stream_cbsr_spmm_plain,
                                             stream_spmm_plain)

# stream_cbsr_spmm's channel ids are packed as uint8 (the JAX kernel's limit)
MAX_CBSR_DIM = 256

# The launch shapes the kernels are built for, keyed by float4 slices per
# lane (dim <= 128, 256, 512, 1024) for stream_spmm's rows fetched ahead, and
# by value slots per lane (k <= 32, 64, 128, 256) for stream_cbsr_spmm's
# edges loaded ahead. The first entry is the default: at dim 256 and k 32,
# the best of utils/stream_sweep.py on the ogbn-products stand-in (PERF.md);
# wider rows keep about 8 KB of registers in flight per warp.
DEPTHS = {1: (8, 4, 16), 2: (8, 4, 16), 4: (4,), 8: (2,)}
BATCHES = {1: (8, 4, 16), 2: (8,), 4: (4,), 8: (4,)}


def _slices(n: int) -> int:
    """Per lane: ceil(n / 32) rounded up to a power of two (the kernels'
    template argument)."""
    return 1 if n <= 32 else 2 if n <= 64 else 4 if n <= 128 else 8


def _require_plan(plan, dev: torch.device, n_src: int,
                  pre: torch.Tensor | None, post: torch.Tensor | None) -> None:
    n_rows, n_chunks = plan.num_rows, plan.num_chunks
    _build.require(plan.indptr, "indptr", torch.int32, dev, (n_rows + 1,))
    _build.require(plan.indices, "indices", torch.int32, dev, (None,))
    _build.require(plan.chunk_row0, "chunk_row0", torch.int32, dev,
                   (n_chunks,))
    _build.require(plan.carry_rows, "carry_rows", torch.int32, dev, (None,))
    if pre is not None:
        _build.require(pre, "pre", torch.float32, dev, (n_src,))
    if post is not None:
        _build.require(post, "post", torch.float32, dev, (n_rows,))


def _outputs(plan, dim: int, dev: torch.device
             ) -> tuple[torch.Tensor, torch.Tensor]:
    y = torch.empty((plan.num_rows, dim), dtype=torch.float32, device=dev)
    # per chunk, the partial sum of a row that began in an earlier chunk
    carry = torch.empty((plan.num_chunks, dim), dtype=torch.float32,
                        device=dev)
    return y, carry


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _choose(value: int | None, allowed: tuple, what: str) -> int:
    if value is None:
        return allowed[0]
    if value not in allowed:
        raise ValueError(f"{what} must be one of {allowed} here; got {value}")
    return value


def stream_spmm(plan, x: torch.Tensor, pre: torch.Tensor | None = None,
                post: torch.Tensor | None = None) -> torch.Tensor:
    """y[v] = post[v] · Σ_{u ∈ in(v)} pre[u] · x[u] over the StreamPlan's
    CSR (a None factor is 1); x f32 [S, dim] → y f32 [plan.num_rows, dim].
    Indices are trusted to lie in [0, S): graphs come from `from_edges`."""
    if _build.on_cpu(x):
        return stream_spmm_plain(plan, x, pre, post)
    return stream_spmm_at(plan, x, pre, post)


def stream_spmm_at(plan, x: torch.Tensor, pre: torch.Tensor | None = None,
                   post: torch.Tensor | None = None, *,
                   hot_budget: int | None = None,
                   depth: int | None = None) -> torch.Tensor:
    """`stream_spmm`'s kernel on a CUDA x with the hot set of `hot_budget`
    bytes (None: `stream_tiles.HOT_BUDGET`; 0: none) and `depth` rows
    fetched ahead into registers (None: the default of DEPTHS). Every
    choice gives the same bits."""
    dev = x.device
    _build.require(x, "x", torch.float32, dev, (None, None))
    n_src, dim = x.shape
    if dim % 4 or not 4 <= dim <= MAX_DIM:
        raise ValueError(f"stream_spmm needs dim % 4 == 0 and 4 <= dim <= "
                         f"{MAX_DIM}; got {dim}")
    depth = _choose(depth, DEPTHS[_slices(dim // 4)], "depth")
    _require_plan(plan, dev, n_src, pre, post)
    _build.require_aligned(x, "x")
    y, carry = _outputs(plan, dim, dev)
    if plan.num_rows:
        hot = plan.hot_set(4 * dim, hot_budget)
        with torch.cuda.device(dev):
            status = _build.library("stream").stream_spmm(
                plan.indptr.data_ptr(), plan.indices.data_ptr(),
                x.data_ptr(), _ptr(pre), _ptr(post),
                plan.chunk_row0.data_ptr(), plan.carry_rows.data_ptr(),
                _ptr(hot.mask), y.data_ptr(), carry.data_ptr(),
                plan.num_rows, plan.num_chunks, plan.carry_rows.numel(),
                plan.num_edges, plan.chunk, dim, depth, plan.warp_chunks,
                _build.stream_of(x))
        _build.check(status, "stream_spmm")
        _build.launches["stream_spmm"] += 1
    return y


def _check_cbsr(records: torch.Tensor, k: int, dim: int) -> None:
    if dim > MAX_CBSR_DIM:
        raise ValueError(f"stream_cbsr_spmm supports dim <= {MAX_CBSR_DIM} "
                         f"(uint8 channel ids); got dim={dim}")
    if not 1 <= k < dim:
        raise ValueError(f"stream_cbsr_spmm needs 1 <= k < dim; got k={k}, "
                         f"dim={dim}")
    width = k + packed_channel_words(k, dim)
    if records.dim() != 2 or records.shape[1] != width:
        raise ValueError(f"records has shape {tuple(records.shape)}, expected "
                         f"[S, {width}] (k values and the packed ids)")


def stream_cbsr_spmm(plan, records: torch.Tensor, k: int, dim: int,
                     pre: torch.Tensor | None = None,
                     post: torch.Tensor | None = None) -> torch.Tensor:
    """y = post ⊙ A (pre ⊙ cbsr(values, channels)) over the StreamPlan:
    records int32 [S, k + ceil(k/4)] from `ops.maxk.cbsr_records(values,
    channels, dim)` (channels distinct within a row) → y f32
    [plan.num_rows, dim], equal by value to `stream_spmm` on the densified
    input. Needs 1 <= k < dim <= 256, on the CPU too: the ids are packed as
    uint8, as in the JAX kernel."""
    _check_cbsr(records, k, dim)
    if _build.on_cpu(records):
        return stream_cbsr_spmm_plain(plan, records, k, dim, pre, post)
    return stream_cbsr_spmm_at(plan, records, k, dim, pre, post)


def stream_cbsr_spmm_at(plan, records: torch.Tensor, k: int, dim: int,
                        pre: torch.Tensor | None = None,
                        post: torch.Tensor | None = None, *,
                        hot_budget: int | None = None,
                        batch: int | None = None,
                        scatter: bool = True) -> torch.Tensor:
    """`stream_cbsr_spmm`'s kernel on CUDA records with the hot set of
    `hot_budget` bytes (None: `stream_tiles.HOT_BUDGET`; 0: none), `batch`
    edges loaded ahead into registers (None: the default of BATCHES); every
    choice gives the same bits. `scatter=False` is utils/stream_sweep.py's
    timing variant (values summed in registers, no shared-memory scatter):
    its y is wrong by design."""
    _check_cbsr(records, k, dim)
    dev = records.device
    if dim % 4 or dim < 4:
        raise ValueError(f"stream_cbsr_spmm needs dim % 4 == 0; got {dim}")
    kp = packed_channel_words(k, dim)
    batch = _choose(batch, BATCHES[_slices(k)], "batch")
    if not scatter and _slices(k) != 1:
        raise ValueError("the scatter-free variant is built for k <= 32")
    n_src = records.shape[0]
    _build.require(records, "records", torch.int32, dev, (n_src, k + kp))
    _require_plan(plan, dev, n_src, pre, post)
    y, carry = _outputs(plan, dim, dev)
    if plan.num_rows:
        hot = plan.hot_set(4 * (k + kp), hot_budget)
        with torch.cuda.device(dev):
            status = _build.library("stream").stream_cbsr_spmm(
                plan.indptr.data_ptr(), plan.indices.data_ptr(),
                records.data_ptr(), _ptr(pre), _ptr(post),
                plan.chunk_row0.data_ptr(), plan.carry_rows.data_ptr(),
                _ptr(hot.mask), y.data_ptr(), carry.data_ptr(),
                plan.num_rows, plan.num_chunks, plan.carry_rows.numel(),
                plan.num_edges, plan.chunk, k, kp, dim, batch,
                plan.warp_chunks, int(scatter), _build.stream_of(records))
        _build.check(status, "stream_cbsr_spmm")
        _build.launches["stream_cbsr_spmm"] += 1
    return y
