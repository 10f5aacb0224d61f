"""The stream CUDA kernels over a StreamPlan's edge chunks (source in
`csrc/stream.cu`, plain versions in `ops/stream.py`):
- `stream_spmm`: y = A_w x (counterpart of
  `spgemm_gnn_tpu/kernels/stream_pallas.py::stream_spmm`);
- `stream_cbsr_spmm`: the same product with x given as CBSR values and
  packed channel ids (counterpart of `stream_pallas.py::stream_spmm_cbsr`).
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


def stream_spmm(plan, x: torch.Tensor, pre: torch.Tensor | None = None,
                post: torch.Tensor | None = None) -> torch.Tensor:
    """y[v] = post[v] · Σ_{u ∈ in(v)} pre[u] · x[u] over the StreamPlan's
    CSR (a None factor is 1); x f32 [S, dim] → y f32 [plan.num_rows, dim].
    Indices are trusted to lie in [0, S): graphs come from `from_edges`."""
    if _build.on_cpu(x):
        return stream_spmm_plain(plan, x, pre, post)
    dev = x.device
    _build.require(x, "x", torch.float32, dev, (None, None))
    n_src, dim = x.shape
    if dim % 4 or not 4 <= dim <= MAX_DIM:
        raise ValueError(f"stream_spmm needs dim % 4 == 0 and 4 <= dim <= "
                         f"{MAX_DIM}; got {dim}")
    _require_plan(plan, dev, n_src, pre, post)
    _build.require_aligned(x, "x")
    y, carry = _outputs(plan, dim, dev)
    if plan.num_rows:
        with torch.cuda.device(dev):
            status = _build.library("stream").stream_spmm(
                plan.indptr.data_ptr(), plan.indices.data_ptr(),
                x.data_ptr(), _ptr(pre), _ptr(post),
                plan.chunk_row0.data_ptr(), plan.carry_rows.data_ptr(),
                y.data_ptr(), carry.data_ptr(), plan.num_chunks,
                plan.carry_rows.numel(), plan.num_edges, plan.chunk, dim,
                _build.stream_of(x))
        _build.check(status, "stream_spmm")
        _build.launches["stream_spmm"] += 1
    return y


def stream_cbsr_spmm(plan, values: torch.Tensor, pchannels: torch.Tensor,
                     dim: int, pre: torch.Tensor | None = None,
                     post: torch.Tensor | None = None) -> torch.Tensor:
    """y = post ⊙ A (pre ⊙ cbsr(values, channels)) over the StreamPlan:
    values f32 [S, k], pchannels int32 [S, ceil(k/4)] from
    `ops.maxk.pack_channels(channels, dim)` (channels distinct within a
    row) → y f32 [plan.num_rows, dim], equal by value to `stream_spmm` on the
    densified input. Needs 1 <= k < dim <= 256, on the CPU too: the ids are
    packed as uint8, as in the JAX kernel."""
    n_src, k = values.shape
    if dim > MAX_CBSR_DIM:
        raise ValueError(f"stream_cbsr_spmm supports dim <= {MAX_CBSR_DIM} "
                         f"(uint8 channel ids); got dim={dim}")
    if not 1 <= k < dim:
        raise ValueError(f"stream_cbsr_spmm needs 1 <= k < dim; got k={k}, "
                         f"dim={dim}")
    if _build.on_cpu(values):
        return stream_cbsr_spmm_plain(plan, values, pchannels, dim, pre, post)
    dev = values.device
    if dim % 4 or dim < 4:
        raise ValueError(f"stream_cbsr_spmm needs dim % 4 == 0; got {dim}")
    kp = packed_channel_words(k, dim)
    _build.require(values, "values", torch.float32, dev, (None, None))
    _build.require(pchannels, "pchannels", torch.int32, dev, (n_src, kp))
    _require_plan(plan, dev, n_src, pre, post)
    y, carry = _outputs(plan, dim, dev)
    if plan.num_rows:
        with torch.cuda.device(dev):
            status = _build.library("stream").stream_cbsr_spmm(
                plan.indptr.data_ptr(), plan.indices.data_ptr(),
                values.data_ptr(), pchannels.data_ptr(), _ptr(pre),
                _ptr(post), plan.chunk_row0.data_ptr(),
                plan.carry_rows.data_ptr(), y.data_ptr(), carry.data_ptr(),
                plan.num_chunks, plan.carry_rows.numel(), plan.num_edges,
                plan.chunk, k, kp, dim, _build.stream_of(values))
        _build.check(status, "stream_cbsr_spmm")
        _build.launches["stream_cbsr_spmm"] += 1
    return y
