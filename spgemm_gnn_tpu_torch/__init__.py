"""spgemm_gnn_tpu_torch — the PyTorch/CUDA port of `spgemm_gnn_tpu`.

Full-graph GNN training with MaxK sparse activations on one NVIDIA H100
(Hopper, sm_90a). The package mirrors the JAX package's layout
(`graphs/`, `ops/`, `kernels/`, `models/`, `train/`, `utils/`) so each module
has a counterpart of the same name:

- `ops/` holds the plain PyTorch version of every kernel: the CPU path and the
  reference the CUDA kernels are held to;
- `kernels/` holds the hand-written CUDA kernels (sources in `csrc/`), their
  ctypes wrappers and the autograd Functions around them;
- entry points (`train.loop.Trainer`, `python -m spgemm_gnn_tpu_torch.train`)
  run on `cuda` unless the caller asks for the CPU.

The package imports torch and numpy only — never jax, flax, optax or the JAX
package.
"""
