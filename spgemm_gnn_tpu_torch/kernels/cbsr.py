"""CBSR on its CUDA kernels (counterpart of `spgemm_gnn_tpu/kernels/
maxk_pallas.py::cbsr_compact_pallas` and of `spgemm_pallas.py::densify_rows`,
`densify_transpose` and `sample_channels`; sources in `csrc/cbsr.cu`).

`cbsr_compact`, `cbsr_densify` and `cbsr_sample` launch the kernels on CUDA
tensors and take the plain versions (ops/maxk.py) on CPU tensors. Each takes
f32 or bf16 values (the densify also an f32 or bf16 output), each form
counted in `_build.launches` under its C entry point's name.
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


_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def densify_name(v_dtype: torch.dtype, out_dtype: torch.dtype) -> str:
    """The C entry point (and launch-count key) of a densify form:
    `cbsr_densify` (f32 → f32), `cbsr_densify_bf16` (bf16 → bf16), else
    `cbsr_densify_<values>_<out>`."""
    if v_dtype == out_dtype:
        return ("cbsr_densify" if v_dtype == torch.float32
                else f"cbsr_densify_{_SUFFIX[v_dtype]}")
    return f"cbsr_densify_{_SUFFIX[v_dtype]}_{_SUFFIX[out_dtype]}"


def check_densify_shape(k: int, dim: int,
                        out_dtype: torch.dtype = torch.float32) -> None:
    """Raise unless the densify kernel takes rows of k values into dim
    channels of `out_dtype` (16-byte stores of whole rows: dim % 4 == 0 for
    f32, dim % 8 == 0 for bf16)."""
    per16 = 128 // torch.finfo(out_dtype).bits
    if k < 1 or dim % per16 or not per16 <= dim <= MAX_DIM:
        raise ValueError(f"cbsr_densify needs k >= 1, dim % {per16} == 0 and "
                         f"{per16} <= dim <= {MAX_DIM} for a {out_dtype} "
                         f"output; got k={k}, dim={dim}")


def cbsr_densify(values: torch.Tensor, channels: torch.Tensor, dim: int,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """out [N, dim] of `out_dtype` (f32 or bf16): out[n, channels[n, j]] =
    values[n, j] (f32 or bf16; widened exactly, or rounded to nearest even),
    0 elsewhere. Channels are trusted to be distinct within a row and to lie
    in [0, dim)."""
    if _build.on_cpu(values):
        return cbsr_to_dense(values, channels, dim, out_dtype)
    dev = values.device
    _build.require(values, "values", _DTYPES, dev, (None, None))
    if out_dtype not in _DTYPES:
        raise ValueError(f"cbsr_densify: out_dtype {out_dtype} is not one of "
                         f"{_DTYPES}")
    n, k = values.shape
    _build.require(channels, "channels", torch.int32, dev, (n, k))
    check_densify_shape(k, dim, out_dtype)
    out = torch.empty((n, dim), dtype=out_dtype, device=dev)
    if n:
        name = densify_name(values.dtype, out_dtype)
        with torch.cuda.device(dev):
            status = getattr(_build.library("cbsr"), name)(
                values.data_ptr(), channels.data_ptr(), out.data_ptr(), n, k,
                dim, _build.stream_of(values))
        _build.check(status, name)
        _build.launches[name] += 1
    return out


def cbsr_sample(z: torch.Tensor, channels: torch.Tensor) -> torch.Tensor:
    """out [N, k] in z's dtype: out[n, j] = z[n, channels[n, j]] (z f32 or
    bf16 [N, dim]; bf16 launches `cbsr_sample_bf16`). Channels are trusted
    to lie in [0, dim)."""
    if _build.on_cpu(z):
        return sample_channels(z, channels)
    dev = z.device
    _build.require(z, "z", _DTYPES, dev, (None, None))
    n, dim = z.shape
    _build.require(channels, "channels", torch.int32, dev, (n, None))
    k = channels.shape[1]
    if k < 1:
        raise ValueError("cbsr_sample needs k >= 1")
    out = torch.empty((n, k), dtype=z.dtype, device=dev)
    if n:
        name = ("cbsr_sample_bf16" if z.dtype == torch.bfloat16
                else "cbsr_sample")
        with torch.cuda.device(dev):
            status = getattr(_build.library("cbsr"), name)(
                z.data_ptr(), channels.data_ptr(), out.data_ptr(), n, k, dim,
                _build.stream_of(z))
        _build.check(status, name)
        _build.launches[name] += 1
    return out


class CBSRCompact(torch.autograd.Function):
    """(values, channels) = CBSR(x); dx = densify(dvalues, channels) in x's
    dtype (bf16 rows: `cbsr_densify_bf16`). On a CUDA x that needs a
    gradient, the densify kernel's limits are checked here, where the call
    is made, not first in the backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, k: int):
        if ctx.needs_input_grad[0] and not _build.on_cpu(x):
            check_densify_shape(k, x.shape[1], x.dtype)
        vals, ch = cbsr_compact(x, k)
        ctx.mark_non_differentiable(ch)
        ctx.save_for_backward(ch)
        ctx.dim = x.shape[1]
        return vals, ch

    @staticmethod
    def backward(ctx, g_vals: torch.Tensor, g_ch):
        (ch,) = ctx.saved_tensors
        return cbsr_densify(g_vals.contiguous(), ch, ctx.dim,
                            g_vals.dtype), None
