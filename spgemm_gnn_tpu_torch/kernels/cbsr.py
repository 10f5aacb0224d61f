"""CBSR on its CUDA kernels (counterpart of `spgemm_gnn_tpu/kernels/
maxk_pallas.py::cbsr_compact_pallas` and of `spgemm_pallas.py::densify_rows`,
`densify_transpose` and `sample_channels`; sources in `csrc/cbsr.cu`).

`cbsr_compact`, `cbsr_densify` and `cbsr_sample` launch the kernels on CUDA
tensors and take the plain versions (ops/maxk.py) on CPU tensors.
`CBSRCompact` is the autograd Function of the compaction: the values are x at
distinct channels, so the gradient of x is the densify of the values'
gradient (`maxk_pallas.py:244-253`). The differentiable entry point is
`kernels/api.py::cbsr_compact`.
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.ops.maxk import (cbsr_compact_plain, cbsr_to_dense,
                                           sample_channels)

MAX_DIM = 1024   # cbsr.cu's kMaxDim: a row lives in one warp's registers


def cbsr_compact(x: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values [N, k] in x's dtype, channels int32 [N, k]) of x f32 or bf16
    [N, dim]: the nonzero channels in ascending order, then the lowest zero
    channels. bf16 rows (the 16-bit model) launch `cbsr_compact_bf16`."""
    if _build.on_cpu(x):
        return cbsr_compact_plain(x, k)
    _build.require(x, "x", (torch.float32, torch.bfloat16), x.device,
                   (None, None))
    n, dim = x.shape
    if not 1 <= k <= dim <= MAX_DIM:
        raise ValueError(f"cbsr_compact needs 1 <= k <= dim <= {MAX_DIM}; "
                         f"got k={k}, dim={dim}")
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        _build.require_aligned(x, "x")
    vals = torch.empty((n, k), dtype=x.dtype, device=x.device)
    ch = torch.empty((n, k), dtype=torch.int32, device=x.device)
    if n:
        name = "cbsr_compact_bf16" if bf16 else "cbsr_compact"
        with torch.cuda.device(x.device):
            status = getattr(_build.library("cbsr"), name)(
                x.data_ptr(), vals.data_ptr(), ch.data_ptr(), n, dim, k,
                _build.stream_of(x))
        _build.check(status, name)
        _build.launches[name] += 1
    return vals, ch


def check_densify_shape(k: int, dim: int) -> None:
    """Raise unless the densify kernel takes rows of k values into dim
    channels (float4 stores of whole rows)."""
    if k < 1 or dim % 4 or not 4 <= dim <= MAX_DIM:
        raise ValueError(f"cbsr_densify needs k >= 1, dim % 4 == 0 and "
                         f"4 <= dim <= {MAX_DIM}; got k={k}, dim={dim}")


def cbsr_densify(values: torch.Tensor, channels: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """out f32 [N, dim]: out[n, channels[n, j]] = values[n, j], 0 elsewhere.
    Channels are trusted to be distinct within a row and to lie in
    [0, dim)."""
    if _build.on_cpu(values):
        return cbsr_to_dense(values, channels, dim)
    dev = values.device
    _build.require(values, "values", torch.float32, dev, (None, None))
    n, k = values.shape
    _build.require(channels, "channels", torch.int32, dev, (n, k))
    check_densify_shape(k, dim)
    out = torch.empty((n, dim), dtype=torch.float32, device=dev)
    if n:
        with torch.cuda.device(dev):
            status = _build.library("cbsr").cbsr_densify(
                values.data_ptr(), channels.data_ptr(), out.data_ptr(), n, k,
                dim, _build.stream_of(values))
        _build.check(status, "cbsr_densify")
        _build.launches["cbsr_densify"] += 1
    return out


def cbsr_sample(z: torch.Tensor, channels: torch.Tensor) -> torch.Tensor:
    """out f32 [N, k]: out[n, j] = z[n, channels[n, j]] (z f32 [N, dim]).
    Channels are trusted to lie in [0, dim)."""
    if _build.on_cpu(z):
        return sample_channels(z, channels)
    dev = z.device
    _build.require(z, "z", torch.float32, dev, (None, None))
    n, dim = z.shape
    _build.require(channels, "channels", torch.int32, dev, (n, None))
    k = channels.shape[1]
    if k < 1:
        raise ValueError("cbsr_sample needs k >= 1")
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    if n:
        with torch.cuda.device(dev):
            status = _build.library("cbsr").cbsr_sample(
                z.data_ptr(), channels.data_ptr(), out.data_ptr(), n, k, dim,
                _build.stream_of(z))
        _build.check(status, "cbsr_sample")
        _build.launches["cbsr_sample"] += 1
    return out


class CBSRCompact(torch.autograd.Function):
    """(values, channels) = CBSR(x); dx = densify(dvalues, channels). On a
    CUDA x that needs a gradient, the densify kernel's limits are checked
    here, where the call is made, not first in the backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, k: int):
        if ctx.needs_input_grad[0] and not _build.on_cpu(x):
            check_densify_shape(k, x.shape[1])
            if x.dtype == torch.bfloat16:
                raise NotImplementedError(
                    "the gradient of cbsr_compact on bf16 rows needs the "
                    "bf16 densify kernel, not ported yet (ROADMAP Queue B: "
                    "B4-B6 in bf16)")
        vals, ch = cbsr_compact(x, k)
        ctx.mark_non_differentiable(ch)
        ctx.save_for_backward(ch)
        ctx.dim = x.shape[1]
        return vals, ch

    @staticmethod
    def backward(ctx, g_vals: torch.Tensor, g_ch):
        (ch,) = ctx.saved_tensors
        return cbsr_densify(g_vals.contiguous(), ch, ctx.dim), None
