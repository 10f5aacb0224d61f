"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. A missing GPU
raises: nothing quietly drops to the CPU, whose plain kernels would make every
time and every kernel check mean something else.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` by default, else as asked.

    Also pins float32 matrix products and convolutions to exact f32 (TF32
    off): the f32 path is exact, as in the JAX package's HIGHEST-precision
    contract, and TF32 would make it bf16-class without notice. And bf16
    products (the 16-bit model) to an f32 accumulate with one rounding:
    cuBLAS may otherwise reduce split-K partial sums in bf16.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device "
            "cpu) to run the plain PyTorch path on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
