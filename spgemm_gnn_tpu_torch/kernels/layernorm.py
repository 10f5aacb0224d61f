"""The `layer_norm16` CUDA kernels: layer norm of bf16 rows in flax's f32
arithmetic (source in `csrc/norm.cu`, plain versions in `ops/layernorm.py`),
the 16-bit model's LayerNorm. `layer_norm16_fwd` / `layer_norm16_bwd` launch
them on CUDA tensors and take the plain versions on CPU tensors;
`LayerNorm16` is the autograd Function, which keeps x and the per-row mean
and rstd, not the f32 temporaries autograd would keep of the plain ops.
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.ops.layernorm import (layer_norm16_backward,
                                                layer_norm16_forward)

MAX_DIM = 1024   # norm.cu's kMaxDim: a row lives in one warp's registers


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    dev = x.device
    _build.require(x, "x", torch.bfloat16, dev, (None, None))
    dim = x.shape[1]
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"layer_norm16 needs 1 <= dim <= {MAX_DIM}; got "
                         f"{dim}")
    for t, what in ((weight, "weight"), (bias, "bias")):
        _build.require(t, what, torch.float32, dev, (dim,))
    _build.require_aligned(x, "x")


def layer_norm16_fwd(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y bf16 [N, dim], mean f32 [N], rstd f32 [N]) of x bf16 [N, dim] with
    f32 weight and bias [dim]."""
    if _build.on_cpu(x):
        return layer_norm16_forward(x, weight, bias, eps)
    _check(x, weight, bias)
    n, dim = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(n, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if n:
        with torch.cuda.device(x.device):
            status = _build.library("norm").layer_norm16_fwd(
                x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, dim,
                float(eps), _build.stream_of(x))
        _build.check(status, "layer_norm16_fwd")
        _build.launches["layer_norm16_fwd"] += 1
    return y, mean, rstd


def layer_norm16_bwd(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                     weight: torch.Tensor, g: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx bf16, dweight f32 [dim], dbias f32 [dim]) for the cotangent g
    (bf16 [N, dim]) of `layer_norm16_fwd`'s y; the kernel's per-block sums
    of dweight and dbias are added here, in block order."""
    if _build.on_cpu(x):
        return layer_norm16_backward(x, mean, rstd, weight, g)
    _check(x, weight, weight)
    n, dim = x.shape
    dev = x.device
    for t, what in ((mean, "mean"), (rstd, "rstd")):
        _build.require(t, what, torch.float32, dev, (n,))
    _build.require(g, "g", torch.bfloat16, dev, (n, dim))
    _build.require_aligned(g, "g")
    dx = torch.empty_like(x)
    lib = _build.library("norm")
    parts = torch.zeros((2, lib.layer_norm16_bwd_blocks(), dim),
                        dtype=torch.float32, device=dev)
    if n:
        with torch.cuda.device(dev):
            status = lib.layer_norm16_bwd(
                x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                weight.data_ptr(), dx.data_ptr(), parts[0].data_ptr(),
                parts[1].data_ptr(), n, dim, _build.stream_of(x))
        _build.check(status, "layer_norm16_bwd")
        _build.launches["layer_norm16_bwd"] += 1
    dweight, dbias = parts.sum(1)
    return dx, dweight, dbias


class LayerNorm16(torch.autograd.Function):
    """y = layer norm of bf16 rows x, in f32, rounded to bf16."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = layer_norm16_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, mean, rstd, weight)
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, weight = ctx.saved_tensors
        dx, dweight, dbias = layer_norm16_bwd(x, mean, rstd, weight,
                                              g.contiguous())
        return dx, dweight, dbias, None

