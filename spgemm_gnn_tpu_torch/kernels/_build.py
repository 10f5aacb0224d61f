"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. At first use it is compiled
by `nvcc` for sm_90a into `build/kernels/lib<name>_<hash>.so` at the
repository root (the hash covers the source and the flags, so an edited
source builds anew), one `nvcc` per source, all started together, and loaded
with ctypes. Every C entry point returns `cudaGetLastError()`; `check`
raises on anything but 0.

A missing `nvcc` or a failed build raises with the compiler's output. There
is no fallback: a CUDA tensor reaches its kernel or an error.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from spgemm_gnn_tpu_torch.utils import spans

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# launches of each kernel, counted by its wrapper where it launches
launches: collections.Counter = collections.Counter()

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# source stem -> {C entry point: argtypes}
SIGNATURES = {
    "maxk": {**{name: [_P, _P, _P, _I64, _INT, _INT, _P]
                for name in ("maxk_fwd", "maxk_fwd_bf16")},
             **{name: [_P, _P, _P, _P, _I64, _INT, _INT, _P]
                for name in ("maxk_fwd_ids", "maxk_fwd_bf16_ids")},
             **{name: [_P, _P, _P, _P, _I64, _INT, _P]
                for name in ("maxk_bwd", "maxk_bwd_bf16")}},
    "spmm": {**{name: [_P, _P, _P, _P, _INT, _P, _P, _P, _P, _P, _P, _INT,
                       _P] for name in ("csr_spmm", "csr_spmm_bf16")},
             "csr_cbsr_spmm_bf16": [_P, _P, _P, _P, _INT, _P, _P, _P, _P, _P,
                                    _INT, _INT, _P],
             "csr_cbsr_spmm": [*[_P] * 4, _INT, *[_P] * 6, _INT, _INT, _P],
             "csr_sspmm_bf16": [*[_P] * 4, _INT, *[_P] * 7, *[_INT] * 3,
                                _P],
             "csr_sspmm": [*[_P] * 4, _INT, *[_P] * 8, _INT, _INT, _P]},
    "stream": {"stream_spmm": [*[_P] * 10, *[_I64] * 4, *[_INT] * 4, _P],
               "stream_spmm_bf16": [*[_P] * 10, *[_I64] * 4, *[_INT] * 4,
                                    _P],
               "stream_spmm_bf16_out": [*[_P] * 11, *[_I64] * 4,
                                        *[_INT] * 4, _P],
               "stream_cbsr_spmm": [*[_P] * 10, *[_I64] * 4, *[_INT] * 7,
                                    _P],
               "stream_cbsr_spmm_bf16": [*[_P] * 10, *[_I64] * 4,
                                         *[_INT] * 6, _P],
               "stream_cbsr_spmm_bf16_out": [*[_P] * 11, *[_I64] * 4,
                                             *[_INT] * 6, _P],
               "stream_cbsr16_attrs": [*[_INT] * 5, _P],
               "sspmm_slots_bf16": [*[_P] * 7, *[_I64] * 3, *[_INT] * 5,
                                    _P],
               "stream_sspmm_bf16": [*[_P] * 13, *[_I64] * 4, *[_INT] * 6,
                                     _P],
               "sspmm_slots_f32": [*[_P] * 7, *[_I64] * 3, *[_INT] * 4, _P],
               "stream_sspmm_f32": [*[_P] * 11, *[_I64] * 4, *[_INT] * 4,
                                    _P]},
    "round": {name: [_P, _P, _P, _I64, _INT, _P]
              for name in ("round_rows", "round_out")},
    "norm": {"layer_norm16_fwd": [*[_P] * 6, _I64, _INT, ctypes.c_float,
                                  _P],
             "layer_norm16_bwd": [*[_P] * 8, _I64, _INT, _P],
             "layer_norm16_bwd_blocks": []},
    "cbsr": {name: [_P, _P, _P, _I64, _INT, _INT, _P]
             for name in ("cbsr_compact", "cbsr_compact_bf16", "cbsr_densify",
                          "cbsr_densify_bf16", "cbsr_densify_bf16_f32",
                          "cbsr_densify_f32_bf16", "cbsr_sample",
                          "cbsr_sample_bf16")},
}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of spgemm_gnn_tpu_torch are built at first use and need the "
            "CUDA toolkit")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile the sources not built yet (in parallel) and load every
    library, inside the set-up span `setup.kernels`. Raises RuntimeError
    with the compiler's output on failure."""
    if len(_libs) == len(SIGNATURES):
        return _libs
    with spans.setup("setup.kernels"):
        return _load_all()


def _load_all() -> dict[str, ctypes.CDLL]:
    targets = {name: _target(name) for name in SIGNATURES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for name, target in todo.items():
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, target)
        errors = []
        for name, (proc, tmp, target) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"--- nvcc {name}.cu (exit {proc.returncode})"
                              f"\n{out}")
            else:
                os.replace(tmp, target)   # atomic against a parallel build
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    for name, target in targets.items():
        lib = ctypes.CDLL(str(target))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return _libs


def library(name: str) -> ctypes.CDLL:
    return build_all()[name]


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} "
                           f"(cudaError_t; launch refused or bad arguments)")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, what: str, dtype: torch.dtype | tuple,
            device: torch.device, shape: tuple | None = None) -> None:
    """Raise unless t is a contiguous `dtype` tensor (or one of a tuple of
    dtypes) on `device` of `shape` (None entries in `shape` match any
    size)."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if shape is not None and (t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape))):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{shape}")


def require_sources(plan, n_src: int, what: str) -> None:
    """Raise unless an x of n_src rows holds every source the plan gathers
    (its `max_src`, a host int recorded when the plan was built, so the
    check costs no device sync): a rectangular plan given too few source
    rows would otherwise read past x on the card."""
    if plan.max_src >= n_src:
        raise ValueError(f"{what}: the plan gathers source row "
                         f"{plan.max_src}, but its input has {n_src} rows")


def require_aligned(t: torch.Tensor, what: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned for the kernel's "
                         f"vector loads")


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version); False for CUDA (kernel);
    raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")
