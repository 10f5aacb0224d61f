"""Checks of the mesh path (counterpart of `spgemm_gnn_tpu/parallel/
dryrun.py`): one full train step over a mesh (`run_dryrun`), every variant
of the sharded exchange against the single-device plain product
(`run_sweep`), and a multi-epoch Trainer run over a mesh against one
without it, with the best-val checkpoint restored (`run_trajectory_match`).
Each raises on a failure and returns its record, under the JAX package's
keys. They run on the card unless the caller asks for the CPU, where the
kernels' impls take their plain versions.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from spgemm_gnn_tpu_torch.graphs.synthetic import powerlaw_graph
from spgemm_gnn_tpu_torch.kernels import planned
from spgemm_gnn_tpu_torch.models.models import build_model
from spgemm_gnn_tpu_torch.ops.maxk import maxk
from spgemm_gnn_tpu_torch.ops.spmm import spmm
from spgemm_gnn_tpu_torch.parallel.mesh import make_mesh
from spgemm_gnn_tpu_torch.parallel.planned_sharded import (
    shard_planned_graph, sharded_planned_aggregate)
from spgemm_gnn_tpu_torch.parallel.sharded import shard_graph
from spgemm_gnn_tpu_torch.train.losses import masked_softmax_ce
from spgemm_gnn_tpu_torch.train.optim import build_optimizer
from spgemm_gnn_tpu_torch.utils.device import resolve_device

# dryrun impls: "torch" (the plain sharded_spmm), "auto" / "cuda" (each
# shard's kernel pairs and the halo exchange; "auto" takes the plain
# versions on the CPU), "both" ("torch", then "auto")
DRYRUN_IMPLS = ("torch", "auto", "cuda", "both")


def run_dryrun(n_devices: int, *, n_nodes: int = 256, n_edges: int = 2048,
               feat: int = 32, hidden: int = 64, classes: int = 8,
               k: int = 8, layers: int = 2, seed: int = 0,
               impl: str = "both", graph=None, device=None) -> float:
    """One optimizer step of a small SAGE MaxK model over a mesh of
    n_devices shards (module docstring for `impl`). Returns the loss
    before the step, which must be finite."""
    if impl not in DRYRUN_IMPLS:
        raise ValueError(f"impl must be one of {DRYRUN_IMPLS}; got {impl!r}")
    kw = dict(n_nodes=n_nodes, n_edges=n_edges, feat=feat, hidden=hidden,
              classes=classes, k=k, layers=layers, seed=seed, graph=graph,
              device=device)
    if impl == "both":
        loss = run_dryrun(n_devices, impl="torch", **kw)
        run_dryrun(n_devices, impl="auto", **kw)
        return loss
    mesh = make_mesh(n_devices, device)
    g = graph if graph is not None else powerlaw_graph(n_nodes, n_edges,
                                                       seed=seed)
    if impl == "torch":
        sg = shard_graph(g, mesh)
    else:
        sg = shard_planned_graph(g, mesh, src_block=128, dst_block=128)
    n_pad = sg.padded_nodes
    rng = np.random.default_rng(seed)
    feats = np.zeros((n_pad, feat), np.float32)
    feats[:g.num_nodes] = rng.standard_normal((g.num_nodes, feat))
    labels = np.zeros(n_pad, np.int64)
    labels[:g.num_nodes] = rng.integers(0, classes, g.num_nodes)
    mask = np.zeros(n_pad, bool)
    mask[:g.num_nodes] = rng.random(g.num_nodes) < 0.7
    x, y, m = (torch.from_numpy(a).to(mesh.device)
               for a in (feats, labels, mask))
    model = build_model("sage", in_dim=feat, hidden_dim=hidden,
                        num_layers=layers, out_dim=classes, maxk=k,
                        feat_drop=0.0, use_norm=False, nonlinear="maxk",
                        impl=impl, dtype="float32")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(mesh.device)
    opt = build_optimizer(model.parameters(), 0.01, 0.0, False)
    loss = masked_softmax_ce(model(sg, x), y, m)
    loss.backward()
    opt.step()
    value = float(loss.detach())
    if not np.isfinite(value):
        raise AssertionError(f"dryrun ({impl}, {n_devices} shards): "
                             f"non-finite loss {value}")
    return value


# (name, degree regime -> plan kind, exchange k, stream, norm, dim override)
SWEEP_CONFIGS = (
    ("windowed_dense_f32_sum",   "dense",  None, "f32",    "sum",  None),
    ("windowed_cbsr_f32_mean",   "dense",  8,    "f32",    "mean", None),
    ("windowed_cbsr_bf16_gcn",   "dense",  8,    "bf16x2", "gcn",  None),
    ("stream_dense_f32_mean",    "sparse", None, "f32",    "mean", None),
    ("stream_cbsr_bf16_sum",     "sparse", 8,    "bf16x2", "sum",  None),
    ("stream_cbsr_f32_gcn",      "sparse", 8,    "f32",    "gcn",  None),
    # yelp-shaped: hidden 384 > 256 takes the uint16×2 channel pack
    ("windowed_cbsr_wide384",    "dense",  8,    "f32",    "mean", 384),
    # the CBSR values in bf16 on the wire, at the bf16 tolerance
    ("windowed_cbsr_halo_bf16",  "dense",  8,    "f32",    "mean", None),
)


def run_sweep(n_devices: int, *, dim: int = 64, seed: int = 0,
              device=None) -> list[dict]:
    """Every SWEEP_CONFIGS variant of the sharded exchange on a mesh of
    n_devices shards: the forward and the input gradient against the
    plain single-device product (`ops/spmm.py::spmm` and its autograd),
    relative to the oracle's largest value, within 1e-4 (3e-2 for the
    bf16x2 stream or a bf16 halo), and each config's `comm_stats`. Raises
    on any failure; returns one record per config."""
    mesh = make_mesh(n_devices, device)
    rng = np.random.default_rng(seed)
    graphs = {
        # average degree ~24 on 128-row shards: windowed shard plans;
        # degree ~1 with a narrow window: stream shard plans
        "dense": (powerlaw_graph(512, 6144, seed=seed),
                  dict(src_block=128, dst_block=128), "windowed"),
        "sparse": (powerlaw_graph(4096, 2048, seed=seed + 1),
                   dict(src_block=128, dst_block=128, window=16),
                   "stream"),
    }
    records = []
    for name, regime, k, stream, norm, dim_over in SWEEP_CONFIGS:
        cdim = dim_over or dim
        g, shard_kw, want_kind = graphs[regime]
        sg = shard_planned_graph(g, mesh, **shard_kw)
        kinds = sorted(set(sg.kinds.values()))
        if want_kind not in kinds:
            raise AssertionError(f"{name}: expected {want_kind} shard plans, "
                                 f"got {kinds}")
        x0 = torch.from_numpy(rng.standard_normal(
            (g.num_nodes, cdim)).astype(np.float32))
        x0 = maxk(x0, k) if k else x0
        ct = torch.from_numpy(rng.standard_normal(
            (g.num_nodes, cdim)).astype(np.float32))
        n_pad = sg.padded_nodes
        xp = torch.zeros((n_pad, cdim)).to(mesh.device)
        xp[:g.num_nodes] = x0.to(mesh.device)
        xp.requires_grad_()
        ctp = torch.zeros((n_pad, cdim), device=mesh.device)
        ctp[:g.num_nodes] = ct.to(mesh.device)
        halo_dt = torch.bfloat16 if name.endswith("halo_bf16") else None
        old = planned.DEFAULT_STREAM
        try:
            planned.DEFAULT_STREAM = stream
            y = sharded_planned_aggregate(sg, xp, norm, k=k,
                                          halo_dtype=halo_dt)
            (y * ctp).sum().backward()
        finally:
            planned.DEFAULT_STREAM = old
        y = y.detach()[:g.num_nodes].cpu()
        gx = xp.grad[:g.num_nodes].cpu()
        xr = x0.clone().requires_grad_()
        y_ref = spmm(g, xr, norm)
        (y_ref * ct).sum().backward()
        g_ref = xr.grad
        if k:   # gradients compared on the MaxK support
            sup = x0 != 0
            gx, g_ref = gx * sup, g_ref * sup
        tol = 3e-2 if (stream == "bf16x2" or halo_dt is not None) else 1e-4
        err_f = float((y - y_ref.detach()).abs().max()
                      / (1e-6 + y_ref.detach().abs().max()))
        err_b = float((gx - g_ref).abs().max() / (1e-6 + g_ref.abs().max()))
        ok = err_f < tol and err_b < tol
        rec = {"config": name, "n_devices": n_devices, "plan_kinds": kinds,
               "k": k, "dim": cdim, "stream": stream, "norm": norm,
               "halo_dtype": "bf16" if halo_dt is not None else "f32",
               # the compaction of the exchange: the port's B7 kernel
               "compact": "cbsr_compact" if k else None,
               "fwd_relerr": err_f, "bwd_relerr": err_b, "ok": ok,
               **sg.comm_stats(cdim, k,
                               value_bytes=2 if halo_dt is not None else 4)}
        records.append(rec)
        if not ok:
            raise AssertionError(f"sweep config {name} failed: {rec}")
    return records


def run_trajectory_match(n_devices: int, *, epochs: int = 8, hidden: int = 32,
                         k: int = 4, seed: int = 0, device=None) -> dict:
    """The same Trainer config (SAGE MaxK through the kernels' impl, an
    evaluation every epoch, periodic and best-val checkpoints) on a mesh of
    n_devices shards and on one device: the loss and val-accuracy
    trajectories within 2e-4 and 5e-3 epoch by epoch, and the sharded
    run's best-val checkpoint restored to its recorded val accuracy
    within 1e-6. Raises on a mismatch; returns the record."""
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer

    dev = str(resolve_device(device))
    base = dict(dataset="flickr", model="sage", nonlinear="maxk", maxk=k,
                hidden_dim=hidden, hidden_layers=2, dropout=0.0, w_lr=0.01,
                epochs=epochs, eval_every=1, log_every=0, synthetic=True,
                synthetic_scale=0.002, seed=seed, impl="auto", device=dev,
                checkpoint_every=max(epochs // 2, 1))
    runs, dirs = {}, []
    try:
        for name, mesh in (("single", 1), ("sharded", n_devices)):
            path = tempfile.mkdtemp(prefix=f"trajmatch_{name}_")
            dirs.append(path)
            tr = Trainer(TrainConfig(mesh_shape=mesh, path=path, **base))
            runs[name] = (tr, tr.run())
        h1 = runs["single"][1]["history"]
        h2 = runs["sharded"][1]["history"]
        if not len(h1) == len(h2) == epochs:
            raise AssertionError(f"trajectory match: {len(h1)} and "
                                 f"{len(h2)} epochs, expected {epochs}")
        loss_diff = max(abs(a.loss - b.loss) for a, b in zip(h1, h2))
        val_diff = max(abs(a.val_acc - b.val_acc) for a, b in zip(h1, h2))
        ok = loss_diff < 2e-4 and val_diff < 5e-3
        tr2, res2 = runs["sharded"]
        best_dir = os.path.join(dirs[1], "checkpoints", "best")
        ck = best_dir if os.path.isdir(best_dir) else dirs[1]
        _, va, _ = tr2.evaluate_checkpoint(ck)
        ckpt_diff = abs(va - res2["best_val_accuracy"])
        ok = ok and ckpt_diff < 1e-6
        rec = {"trajectory_match": True, "n_devices": n_devices,
               "epochs": epochs,
               "max_loss_diff": float(loss_diff),
               "max_val_acc_diff": float(val_diff),
               "best_epoch_single": runs["single"][1]["best_epoch"],
               "best_epoch_sharded": res2["best_epoch"],
               "ckpt_restore_val_diff": float(ckpt_diff), "ok": ok}
        if not ok:
            raise AssertionError(f"trajectory match failed: {rec}")
        return rec
    finally:
        for p in dirs:
            shutil.rmtree(p, ignore_errors=True)
