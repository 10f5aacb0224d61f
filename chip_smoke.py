#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (spgemm_gnn_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repository root, on an H100

Phases, each of which raises (exit code != 0, no result line) on failure:
  1. device: a CUDA device must exist; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the port (nvcc, sm_90a);
  3. graph: the synthetic Reddit stand-in at full width (602 features,
     41 classes, N = 232,965, E about 114.6M);
  4. kernels: each kernel at the training path's shapes against its plain
     PyTorch version (MaxK forward/backward bitwise; the CSR product within
     1e-5 of the largest output magnitude of a float64 run of the plain
     version), timed with CUDA events beside its
     plain version, a PyTorch library call computing the same function, and
     the least time the card could take (bytes over 3.35 TB/s or operations
     over 67 TFLOP/s f32, H100 SXM peaks at 700 W);
  5. train: `Trainer` on the Reddit recipe (SAGE, MaxK k=32, hidden 256,
     4 layers, LayerNorm, dropout 0.5, lr 0.01) for 5 epochs; the losses must
     be finite and fall, and every kernel's launch count must match the
     model's structure exactly;
  6. model check: on a small graph (3000 nodes, 2 layers, ReLU, so only the
     aggregation kernel), the model through the kernels against the model
     through the plain versions on the same card.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12   # H100 SXM f32 outside the tensor cores
# the Reddit stand-in at full size, the recipe's epochs, and the seed of the
# graph, the inputs and the weights
SCALE = 1.0
EPOCHS = 5
SEED = 97


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bits_equal(torch, a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|)."""
    err = float((a - b).abs().max())
    return err, err / max(float(b.abs().max()), 1e-30)


def kernel_phase(torch, g, dim: int, k: int, seed: int) -> list[dict]:
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_bwd, maxk_fwd
    from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm
    from spgemm_gnn_tpu_torch.ops.maxk import maxk_backward, maxk_forward
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    from spgemm_gnn_tpu_torch.ops.spmm import csr_spmm_plain

    dev = g.device
    n, e = g.num_nodes, g.num_edges
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, dim), generator=gen, device=dev)
    # rows of repeated values and all-zero rows exercise the tie rule
    x[::97] = x[::97].round()
    x[::1009] = 0.0
    gy = torch.randn((n, dim), generator=gen, device=dev)
    f32 = 4
    out = []

    # K1 maxk_fwd
    y, meta = maxk_fwd(x, k)
    y_p, meta_p = maxk_forward(x, k)
    torch.cuda.synchronize()
    if not (bits_equal(torch, y, y_p) and bits_equal(torch, meta, meta_p)):
        raise AssertionError("maxk_fwd differs from its plain version")
    b, by = bound_ms(2 * n * dim * f32 + n * 2 * 4, n * dim)
    out.append(dict(
        name="maxk_fwd", route="cuda", source="spgemm_gnn_tpu_torch/csrc/maxk.cu",
        replaces="spgemm_gnn_tpu/kernels/maxk_pallas.py:76",
        max_abs_err=float((y - y_p).abs().max()),
        ms=time_ms(torch, lambda: maxk_fwd(x, k), 20),
        plain_ms=time_ms(torch, lambda: maxk_forward(x, k), 3),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.topk(x, k, dim=1), 20)))
    log(f"kernel maxk_fwd: bitwise equal to plain (y and meta), N={n} dim={dim} k={k}")

    # K2 maxk_bwd
    dx = maxk_bwd(x, meta, gy)
    dx_p = maxk_backward(x, meta, gy)
    torch.cuda.synchronize()
    if not bits_equal(torch, dx, dx_p):
        raise AssertionError("maxk_bwd differs from its plain version")
    b, by = bound_ms(3 * n * dim * f32 + n * 2 * 4, n * dim)
    out.append(dict(
        name="maxk_bwd", route="cuda", source="spgemm_gnn_tpu_torch/csrc/maxk.cu",
        replaces="spgemm_gnn_tpu/kernels/maxk_pallas.py:133",
        max_abs_err=float((dx - dx_p).abs().max()),
        ms=time_ms(torch, lambda: maxk_bwd(x, meta, gy), 20),
        plain_ms=time_ms(torch, lambda: maxk_backward(x, meta, gy), 3),
        bound_ms=b, bound_by=by, library_ms=None))
    log("kernel maxk_bwd: bitwise equal to plain")

    # K3 csr_spmm: forward on A (k-sparse input after dropout, mean norm) and
    # the backward's use on the transpose (dense cotangent, factors swapped)
    _, post = node_factors(g, "mean")
    keep = torch.rand((n, dim), generator=gen, device=dev) >= 0.5
    xs = torch.where(keep, y / 0.5, torch.zeros_like(y))
    del x, y, y_p, meta, meta_p, dx, dx_p, keep

    def spmm_entry(indptr, indices, inp, pre_f, post_f, edge_values):
        """Check and time one use; `edge_values` are the same weights per
        edge, for the library's CSR tensor. The reference is the plain
        version in float64, so that the error read is the kernel's own."""
        ref = csr_spmm_plain(indptr, indices, inp.double(), pre_f, post_f)
        got = csr_spmm(indptr, indices, inp, pre_f, post_f)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not rel <= 1e-5:
            raise AssertionError(f"csr_spmm error {rel:.3e} of max |y| > 1e-5")
        # the products this input needs: a multiply-add per nonzero of each
        # gathered row
        gathered = torch.bincount(indices, minlength=n).double()
        ops = 2.0 * float(((inp != 0).sum(1).double() * gathered).sum())
        n_bytes = 2 * n * dim * f32 + (n + 1) * 4 + e * 4 + n * 4
        b_ms, b_by = bound_ms(n_bytes, ops)
        a = torch.sparse_csr_tensor(indptr, indices, edge_values, size=(n, n))
        lib = torch.sparse.mm(a, inp)
        lib_err = rel_err(lib, ref)[1]
        return dict(err=err, rel=rel, ops=ops, bound_ms=b_ms, bound_by=b_by,
                    ms=time_ms(torch, lambda: csr_spmm(
                        indptr, indices, inp, pre_f, post_f), 5),
                    plain_ms=time_ms(torch, lambda: csr_spmm_plain(
                        indptr, indices, inp, pre_f, post_f), 2),
                    library_ms=time_ms(torch, lambda: torch.sparse.mm(a, inp),
                                       5),
                    library_rel_err=lib_err)

    fwd = spmm_entry(g.indptr, g.indices, xs, None, post,
                     post[g.edge_dst.long()])
    log(f"kernel csr_spmm (A, k-sparse x): max abs err {fwd['err']:.3e}, "
        f"{fwd['rel']:.3e} of max |y|; library err {fwd['library_rel_err']:.3e}")
    hub = hub_rows(torch, g.indptr, g.indices, HUB_ROWS)
    hub_ms = time_ms(torch, lambda: csr_spmm(*hub, xs), 5)
    log(f"kernel csr_spmm on the {HUB_ROWS} rows of highest in-degree only "
        f"(max {int(g.in_degrees.max())}, {hub[1].numel() / e:.1%} of the "
        f"edges): {hub_ms:.3f} ms of the whole product's {fwd['ms']:.3f} ms")
    del hub, xs
    bwd = spmm_entry(g.t_indptr, g.t_indices, gy, post, None,
                     post[g.t_indices.long()])
    log(f"kernel csr_spmm (A^T, dense g): max abs err {bwd['err']:.3e}, "
        f"{bwd['rel']:.3e} of max |y|; library err {bwd['library_rel_err']:.3e}")
    out.append(dict(
        name="csr_spmm", route="cuda", source="spgemm_gnn_tpu_torch/csrc/spmm.cu",
        replaces="spgemm_gnn_tpu/kernels/spgemm_pallas.py:97",
        max_abs_err=fwd["err"], ms=fwd["ms"], plain_ms=fwd["plain_ms"],
        bound_ms=fwd["bound_ms"], bound_by=fwd["bound_by"],
        library_ms=fwd["library_ms"],
        transpose_max_abs_err=bwd["err"], transpose_ms=bwd["ms"],
        transpose_plain_ms=bwd["plain_ms"],
        transpose_bound_ms=bwd["bound_ms"], transpose_bound_by=bwd["bound_by"],
        transpose_library_ms=bwd["library_ms"], hub_rows_ms=hub_ms))
    log(f"kernel csr_spmm: gather traffic without reuse (E*dim*4 B) over "
        f"{PEAK_BYTES_S / 1e12} TB/s would take "
        f"{e * dim * f32 / PEAK_BYTES_S * 1e3:.3f} ms")
    return out


HUB_ROWS = 1024   # 128 blocks of 8 warps: one wave on the H100's 132 SMs


def hub_rows(torch, indptr, indices, rows: int):
    """The CSR (indptr, indices) of only the `rows` rows of highest degree:
    timed alone, it shows how much of the product the longest rows' warps
    take by themselves (one warp per row, so they are the launch's tail)."""
    deg = indptr.diff()
    top = torch.topk(deg, min(rows, deg.numel())).indices
    d = deg[top].long()
    sub_indptr = torch.zeros(d.numel() + 1, dtype=torch.long,
                             device=indptr.device)
    torch.cumsum(d, 0, out=sub_indptr[1:])
    total = int(sub_indptr[-1])
    offset = torch.repeat_interleave(indptr[top].long() - sub_indptr[:-1], d,
                                     output_size=total)
    pos = torch.arange(total, device=indptr.device) + offset
    return sub_indptr.int(), indices[pos].contiguous()


def model_check(torch, seed: int) -> None:
    """The model through the kernels against the model through the plain
    versions, on the same card: 3000 nodes, 2 layers, ReLU (so that no top-k
    selection can flip on a last-bit difference of the summation order), so
    only the aggregation kernel is held here at the model level."""
    from spgemm_gnn_tpu_torch.graphs.synthetic import powerlaw_graph
    from spgemm_gnn_tpu_torch.models.models import build_model

    dev = torch.device("cuda")
    g = powerlaw_graph(3000, 60000, seed=seed).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((g.num_nodes, 64), generator=gen, device=dev)
    results = {}
    for impl in ("cuda", "torch"):
        model = build_model("sage", in_dim=64, hidden_dim=256, num_layers=2,
                            out_dim=41, feat_drop=0.0, use_norm=True,
                            nonlinear="relu", impl=impl)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        model.to(dev)
        x = feats.clone().requires_grad_(True)
        logits = model(g, x)
        (logits.square().sum()).backward()
        results[impl] = (logits.detach(), x.grad)
    for name, a, b in (("logits", results["cuda"][0], results["torch"][0]),
                       ("input grad", results["cuda"][1], results["torch"][1])):
        if not (torch.isfinite(a).all() and a.shape == b.shape):
            raise AssertionError(f"model check: {name} not finite or misshaped")
        err, rel = rel_err(a, b)
        if not rel <= 1e-4:
            raise AssertionError(f"model check: {name} error {rel:.3e}")
        log(f"model check ({name}): kernels vs plain, {rel:.3e} of max")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    from spgemm_gnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ds = load_dataset("reddit", allow_synthetic=True, data_path="/nonexistent",
                      synthetic_scale=SCALE, seed=SEED)
    log(f"graph: reddit stand-in scale {SCALE}: N={ds.graph.num_nodes} "
        f"E={ds.graph.num_edges} features={ds.features.shape[1]} "
        f"classes={ds.num_classes}, host build {time.perf_counter() - t0:.1f} s")
    g = ds.graph = ds.graph.to(dev)

    hidden, k, layers = 256, 32, 4
    kernels = kernel_phase(torch, g, hidden, k, SEED)
    torch.cuda.empty_cache()

    cfg = TrainConfig(dataset="reddit", model="sage", nonlinear="maxk",
                      maxk=k, hidden_dim=hidden, hidden_layers=layers,
                      norm=True, dropout=0.5, w_lr=0.01, epochs=EPOCHS,
                      eval_every=1, seed=SEED, device="cuda",
                      impl="auto", synthetic=True,
                      synthetic_scale=SCALE)
    trainer = Trainer(cfg, dataset=ds)
    _build.launches.clear()
    res = trainer.run()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    losses = [r.loss for r in res["history"]]
    log(f"train: losses {losses}")
    log(f"train: val acc {[r.val_acc for r in res['history']]}")
    log(f"train: steady_epoch_s {res['steady_epoch_s']}, wall "
        f"{res['wall_time_s']:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if len(losses) != EPOCHS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train: losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")
    # per epoch: a train step (forward + backward) and an eval forward
    expected = {"maxk_fwd": EPOCHS * 2 * layers,
                "maxk_bwd": EPOCHS * layers,
                "csr_spmm": EPOCHS * 3 * layers}
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    log(f"train: launches {counts} (per train step: maxk_fwd {layers}, "
        f"maxk_bwd {layers}, csr_spmm {2 * layers}; per eval: maxk_fwd "
        f"{layers}, csr_spmm {layers})")
    for entry in kernels:
        entry["launches"] = counts[entry["name"]]
    del trainer, res
    torch.cuda.empty_cache()

    model_check(torch, SEED)

    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
