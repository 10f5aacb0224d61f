#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (spgemm_gnn_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repository root, on an H100

Phases, each of which raises (exit code != 0, no result line) on failure:
  1. device: a CUDA device must exist; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the port (nvcc, sm_90a, one nvcc per
     source, all started together);
  3. graph: the synthetic Reddit stand-in at full width (602 features,
     41 classes, N = 232,965, E about 113.3M); the plan rule must pick the
     "windowed" kind (csr_spmm);
  4. kernels: each kernel of the Reddit path at its shapes against its plain
     PyTorch version (MaxK forward/backward bitwise; the CSR product within
     1e-5 of the largest output magnitude of a float64 run of the plain
     version, and bitwise equal across two runs), timed with CUDA events
     beside its plain version, a PyTorch library call computing the same
     function, and the least time the card could take (bytes over 3.35 TB/s
     or operations over 67 TFLOP/s f32, H100 SXM peaks at 700 W); for
     csr_spmm also its schedule (source blocks, segment size, segments,
     split runs, bytes beyond the CSR) and the same product with one source
     block (the row split alone, also within 1e-5), timed; the stream kernel
     on the same graph, checked the same way (it only measures: the rule
     keeps Reddit on csr_spmm);
  5. train: the Reddit recipe (SAGE, MaxK k=32, hidden 256, 4 layers,
     LayerNorm, dropout 0.5, lr 0.01): its first two train steps through the
     kernels within 1e-4 relative of the plain path's (same weights and
     dropout seed), then `Trainer` for 5 epochs; the losses must be finite
     and fall, and every kernel's launch count must match the model's
     structure exactly;
  6. model check: on a small graph (3000 nodes, 2 layers, ReLU, so only the
     aggregation kernel), every model family (SAGE, GCN, GIN, GNNRes and the
     three integrated MaxK models) through the kernels against the same
     model through the plain versions on the same card, on a windowed plan
     and on a stream plan; then each family with MaxK on the stream plan,
     STREAM_CBSR_FORWARD set against unset, logits and input gradient equal
     by value;
  7. graph 2: the synthetic ogbn-products stand-in at full size (N =
     2,449,029, E about 123.7M, 100 features, 47 classes); the plan rule must
     pick the "stream" kind (stream_spmm);
  8. kernels on products: stream_spmm on A and Aᵀ, and csr_spmm on A, checked
     as in phase 4 (the rule must give csr_spmm one source block here); then
     stream_cbsr_spmm (the CBSR edge-gather forward, on one record per node)
     on A at dim 256, k 32, under the mean and the gcn factors: within 1e-5
     of the plain version in float64, equal by value to stream_spmm on the
     same masked input, bitwise equal across two runs, and timed beside
     stream_spmm, its plain version, torch.sparse.mm on the dense input, and
     cbsr_compact + cbsr_records with it. Each stream kernel (and stream_spmm
     on Reddit in phase 4) also runs with no hot set (budget 0): bitwise
     equal to the default run, and timed, so that the hot set's share of
     the time is on record;
  9. CBSR: cbsr_compact, cbsr_densify and cbsr_sample at the products shapes
     (dim 256, k 32), bitwise against their plain versions and timed; then
     `aggregate_cbsr` forward and backward through the kernels, with its
     launches counted, against the dense path, with STREAM_CBSR_FORWARD
     unset and then set (no densify in the forward);
 10. train 2: the products recipe (SAGE, MaxK k=32, hidden 256, 3 layers,
     LayerNorm, dropout 0.5, lr 0.003): its first two train steps through the
     kernels within 1e-4 relative of the plain path's (same weights and
     dropout seed), then 5 epochs with finite losses and exact launch counts;
     then 5 epochs more with STREAM_CBSR_FORWARD set, their losses within
     1e-6 relative of the flag-off run's;
 11. train 3: the products recipe with GCN and self-loops (`--model gcn
     --selfloop`) and STREAM_CBSR_FORWARD set: its first two train steps
     within 1e-4 relative of the plain path's, then 5 epochs with finite
     losses and exact launch counts (stream_cbsr_spmm forward, stream_spmm
     backward).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12   # H100 SXM f32 outside the tensor cores
# the stand-ins at full size, the recipes' epochs, and the seed of the
# graphs, the inputs and the weights
SCALE = 1.0
EPOCHS = 5
SEED = 97
HIDDEN, K = 256, 32
HUB_ROWS = 1024   # 128 blocks of 8 warps: one wave on the H100's 132 SMs


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


def sparse_input(torch, n: int, dim: int, k: int, gen):
    """MaxK of random rows, then dropout 0.5: the aggregation's input on the
    training path (k-sparse, some rows shorter)."""
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_fwd
    x = torch.randn((n, dim), generator=gen, device="cuda")
    y, _ = maxk_fwd(x, k)
    keep = torch.rand((n, dim), generator=gen, device="cuda") >= 0.5
    return torch.where(keep, y / 0.5, torch.zeros_like(y))


def hub_rows(torch, indptr, indices, rows: int):
    """The CSR (indptr, indices) of only the `rows` rows of highest degree:
    timed alone, it shows how much of the product the longest rows take by
    themselves."""
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


def product_check(torch, kernel: str, g, inp, pre_f, post_f,
                  transpose: bool = False) -> dict:
    """Check and time one use of an aggregation kernel ("csr_spmm" or
    "stream_spmm") on the graph's CSR (or its transpose). The reference is
    the plain version in float64, so that the error read is the kernel's own;
    two runs must give the same bits. Also times the kernel on the HUB_ROWS
    rows of highest degree alone (for csr_spmm under the product's number of
    source blocks), the plain version, and `torch.sparse.mm` on a CSR tensor
    of the same weights."""
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
    from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
    from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm
    from spgemm_gnn_tpu_torch.kernels.stream import stream_spmm, stream_spmm_at
    from spgemm_gnn_tpu_torch.ops.spmm import csr_spmm_plain
    from spgemm_gnn_tpu_torch.ops.stream import stream_spmm_plain

    indptr = g.t_indptr if transpose else g.indptr
    indices = g.t_indices if transpose else g.indices
    rows = g.t_edge_dst if transpose else g.edge_dst
    n, e, dim = g.num_nodes, g.num_edges, inp.shape[1]
    if kernel == "stream_spmm":
        plan = build_stream_plan(indptr, indices)
        hub_ip, hub_ix = hub_rows(torch, indptr, indices, HUB_ROWS)
        hub_plan = build_stream_plan(hub_ip, hub_ix)
        hub_edges = hub_ix.numel()
        plan_bytes = (plan.num_chunks + plan.carry_rows.numel()) * 4

        def run(x):
            return stream_spmm(plan, x, pre_f, post_f)

        def run_plain(x):
            return stream_spmm_plain(plan, x, pre_f, post_f)

        def run_hub():
            return stream_spmm(hub_plan, inp)
    else:
        plan = CSRPlan(indptr, indices)
        hub_plan = CSRPlan(*hub_rows(torch, indptr, indices, HUB_ROWS),
                           src_blocks=plan.schedule(n, dim).nb)
        hub_edges = hub_plan.indices.numel()
        plan_bytes = 0

        def run(x, p=plan):
            return csr_spmm(p, x, pre_f, post_f)

        def run_plain(x):
            return csr_spmm_plain(indptr, indices, x, pre_f, post_f)

        def run_hub():
            return csr_spmm(hub_plan, inp)

    ref = run_plain(inp.double())
    got, again = run(inp), run(inp)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    if not rel <= 1e-5:
        raise AssertionError(f"{kernel} error {rel:.3e} of max |y| > 1e-5")
    if not bits_equal(torch, got, again):
        raise AssertionError(f"{kernel}: two runs differ")
    extra = {}
    if kernel == "stream_spmm":
        # the same product with no hot set: the same bits, and its time
        def run_hot0():
            return stream_spmm_at(plan, inp, pre_f, post_f, hot_budget=0)
        if not bits_equal(torch, got, run_hot0()):
            raise AssertionError("stream_spmm: hot budget 0 differs from the "
                                 "default")
        extra = hot_keys(plan.hot_set(4 * dim))
        extra["hot0_ms"] = time_ms(torch, run_hot0, 5)
    if kernel == "csr_spmm":
        # the same product with one source block (the row split alone)
        one = CSRPlan(indptr, indices, src_blocks=1)
        single = run(inp, p=one)
        torch.cuda.synchronize()
        single_rel = rel_err(single, ref)[1]
        if not single_rel <= 1e-5:
            raise AssertionError(f"csr_spmm, one block: error "
                                 f"{single_rel:.3e} of max |y| > 1e-5")
        del single
        sched = plan.schedule(n, dim)
        extra = dict(
            nb=sched.nb, block_rows=sched.block_rows, segment=sched.segment,
            segments=sched.num_segments, split_runs=sched.num_split_runs,
            slots=sched.n_slots, plan_extra_bytes=sched.extra_bytes(indices),
            nb1_rel=single_rel,
            nb1_ms=time_ms(torch, lambda: run(inp, p=one), 5))
    w = torch.ones(e, device=inp.device)
    if pre_f is not None:
        w = w * pre_f[indices.long()]
    if post_f is not None:
        w = w * post_f[rows.long()]
    a = torch.sparse_csr_tensor(indptr, indices, w, size=(n, n))
    lib_rel = rel_err(torch.sparse.mm(a, inp), ref)[1]
    del ref, again
    # the products this input needs: a multiply-add per nonzero of each
    # gathered row
    gathered = torch.bincount(indices, minlength=n).double()
    ops = 2.0 * float(((inp != 0).sum(1).double() * gathered).sum())
    n_bytes = (2 * n * dim * 4 + (n + 1) * 4 + e * 4 + plan_bytes
               + 4 * n * ((pre_f is not None) + (post_f is not None)))
    b_ms, b_by = bound_ms(n_bytes, ops)
    ms = time_ms(torch, lambda: run(inp), 5)
    hub_ms = time_ms(torch, run_hub, 5)
    return dict(err=err, rel=rel, bound_ms=b_ms, bound_by=b_by, ms=ms,
                plain_ms=time_ms(torch, lambda: run_plain(inp), 2),
                library_ms=time_ms(torch, lambda: torch.sparse.mm(a, inp), 5),
                library_rel=lib_rel, hub_ms=hub_ms,
                hub_edge_share=hub_edges / e,
                gather_ms=e * dim * 4 / PEAK_BYTES_S * 1e3, **extra)


HOT_KEYS = ("hot_rows", "hot_edge_share", "hot_budget_bytes", "hot0_ms")


def hot_keys(hot) -> dict:
    """A stream kernel's hot set, for its log line and kernels-line entry."""
    return dict(hot_rows=hot.rows, hot_edge_share=hot.edge_share,
                hot_budget_bytes=hot.budget)


def log_hot(what: str, r: dict) -> None:
    log(f"  hot set ({what}): {r['hot_rows']} rows, "
        f"{r['hot_edge_share']:.2%} of the edges, budget "
        f"{r['hot_budget_bytes'] / 2**20:.0f} MiB; with no hot set "
        f"{r['hot0_ms']:.3f} ms (bitwise equal), with it {r['ms']:.3f} ms")


def log_product(kernel: str, what: str, r: dict) -> None:
    log(f"kernel {kernel} ({what}): max abs err {r['err']:.3e}, "
        f"{r['rel']:.3e} of max |y| (cuSPARSE {r['library_rel']:.3e}); "
        f"bitwise equal across two runs; {r['ms']:.3f} ms "
        f"(plain {r['plain_ms']:.3f}, torch.sparse.mm {r['library_ms']:.3f}, "
        f"bound {r['bound_ms']:.3f} by {r['bound_by']}, no-reuse gather "
        f"{r['gather_ms']:.3f}); the {HUB_ROWS} rows of highest degree "
        f"({r['hub_edge_share']:.1%} of the edges) alone {r['hub_ms']:.3f} ms "
        f"({r['hub_ms'] / r['ms']:.1%})")
    if "hot0_ms" in r:
        log_hot(what, r)
    if "nb" in r:
        log(f"  schedule ({what}): {r['nb']} source blocks of "
            f"{r['block_rows']} rows, segments of at most {r['segment']} "
            f"edges: {r['segments']} segments, {r['split_runs']} split runs, "
            f"{r['slots']} scratch slots, {r['plan_extra_bytes'] / 2**20:.1f} "
            f"MiB beyond the CSR; one source block (the row split alone) "
            f"{r['nb1_ms']:.3f} ms ({r['nb1_rel']:.3e} of max |y|)")


def maxk_phase(torch, g, dim: int, k: int, seed: int) -> list[dict]:
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_bwd, maxk_fwd
    from spgemm_gnn_tpu_torch.ops.maxk import maxk_backward, maxk_forward

    dev = g.device
    n = g.num_nodes
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
    return out


def product_entry(name: str, a: dict, t: dict | None = None, **other) -> dict:
    """The kernels-line entry of an aggregation kernel: A (`a`), and Aᵀ and
    other graphs' uses under prefixed keys."""
    source = {"csr_spmm": "spgemm_gnn_tpu_torch/csrc/spmm.cu",
              "stream_spmm": "spgemm_gnn_tpu_torch/csrc/stream.cu"}[name]
    replaces = {"csr_spmm": "spgemm_gnn_tpu/kernels/spgemm_pallas.py:97",
                "stream_spmm": "spgemm_gnn_tpu/kernels/stream_pallas.py:37"}
    names = {"err": "max_abs_err", "hub_ms": "hub_rows_ms",
             "gather_ms": "no_reuse_gather_ms"}
    keys = ("err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "hub_ms", "gather_ms", "nb", "segments", "split_runs", "nb1_ms",
            *HOT_KEYS)
    entry = dict(name=name, route="cuda", source=source,
                 replaces=replaces[name])
    for prefix, r in (("", a), ("transpose_", t), *other.items()):
        if r is not None:
            entry.update({prefix + names.get(key, key): r[key]
                          for key in keys if key in r})
    return entry


def _model_run(torch, name: str, g, feats, seed: int, nonlinear: str,
               impl: str):
    """(logits, input gradient) of a 2-layer, hidden-256 model of family
    `name` (LayerNorm or BatchNorm on, dropout off) on the graph."""
    from spgemm_gnn_tpu_torch.models.models import build_model
    model = build_model(name, in_dim=feats.shape[1], hidden_dim=HIDDEN,
                        num_layers=2, out_dim=41, maxk=K, feat_drop=0.0,
                        use_norm=True, nonlinear=nonlinear, impl=impl)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(feats.device)
    x = feats.clone().requires_grad_(True)
    logits = model(g, x)
    (logits.square().sum()).backward()
    return logits.detach(), x.grad


class ReluPattern:
    """Stands in for `torch.relu` in the model check: on the first run it
    records each call's mask (x > 0); on the second (after `replay()`) it
    applies the recorded masks in the same order, so that both runs take the
    same ReLU pattern, and counts the units whose sign differs. A ReLU after
    an aggregation (every family has one from its second layer on) can see a
    pre-activation within f32 rounding of 0, and the plain path adds with
    atomics, in an order that changes from run to run: without the replay
    one such unit flips its derivative in some runs, and its gradient
    reaches every neighbour's input row."""

    def __init__(self, torch):
        self.relu = torch.relu
        self.masks: list = []
        self.pos = None
        self.flips = 0

    def replay(self) -> None:
        self.pos = 0

    def __call__(self, x):
        if self.pos is None:
            self.masks.append(x > 0)
            return self.relu(x)
        mask = self.masks[self.pos]
        self.pos += 1
        self.flips += int(((x > 0) != mask).sum())
        return x * mask


def model_check(torch, seed: int, kind: str) -> None:
    """Every family through the kernels against the same family through the
    plain versions, on the same card: 3000 nodes, 2 layers, ReLU (so that no
    top-k selection can flip on a last-bit difference of the summation
    order), so only the aggregation kernel is held here at the model level:
    logits and input gradient within 1e-4 of their largest magnitude, the
    plain run taking the kernel run's ReLU pattern (`ReluPattern`).
    On the stream plan, each family with MaxK also runs with
    STREAM_CBSR_FORWARD set and unset: the logits and input gradients must
    be equal by value, and the flag-on run must launch stream_cbsr_spmm once
    per layer of a family that aggregates a k-sparse input."""
    from spgemm_gnn_tpu_torch.graphs.synthetic import powerlaw_graph
    from spgemm_gnn_tpu_torch.kernels import _build, planned
    from spgemm_gnn_tpu_torch.models.models import MODELS

    dev = torch.device("cuda")
    g = planned.plan_graph(powerlaw_graph(3000, 60000, seed=seed).to(dev),
                           kind=kind)
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((g.num_nodes, 64), generator=gen, device=dev)
    for name in MODELS:
        pattern = ReluPattern(torch)
        torch.relu = pattern
        try:
            got = _model_run(torch, name, g, feats, seed, "relu", "cuda")
            pattern.replay()
            want = _model_run(torch, name, g, feats, seed, "relu", "torch")
        finally:
            torch.relu = pattern.relu
        rels = []
        for what, a, b in zip(("logits", "input grad"), got, want):
            if not (torch.isfinite(a).all() and a.shape == b.shape):
                raise AssertionError(f"model check ({name}): {what} not "
                                     f"finite or misshaped")
            rels.append(rel_err(a, b)[1])
            if not rels[-1] <= 1e-4:
                raise AssertionError(f"model check ({kind}, {name}): {what} "
                                     f"error {rels[-1]:.3e}")
        log(f"model check ({kind} plan, {name}, ReLU): kernels vs plain, "
            f"logits {rels[0]:.3e}, input grad {rels[1]:.3e} of max; "
            f"{pattern.flips} ReLU units of the plain run on the other side "
            f"of 0")
    if kind != "stream":
        return
    for name in MODELS:
        runs = {}
        for flag in (True, False):
            planned.STREAM_CBSR_FORWARD = flag
            _build.launches.clear()
            runs[flag] = (_model_run(torch, name, g, feats, seed, "maxk",
                                     "cuda"), dict(_build.launches))
        planned.STREAM_CBSR_FORWARD = False
        (on, counts), (off, _) = runs[True], runs[False]
        if not all(torch.equal(a, b) for a, b in zip(on, off)):
            raise AssertionError(f"model check ({name}, MaxK): the flag-on "
                                 f"model differs from the flag-off one")
        want = 0 if name == "gnn_res" else 2      # gnn_res is ReLU-only
        if counts.get("stream_cbsr_spmm", 0) != want:
            raise AssertionError(f"model check ({name}, MaxK): launches "
                                 f"{counts}, expected stream_cbsr_spmm "
                                 f"{want}")
    log(f"model check (stream plan, {len(MODELS)} families, MaxK k={K}): "
        f"STREAM_CBSR_FORWARD on and off give equal logits and input "
        f"gradients; stream_cbsr_spmm launched once per layer")


def stream_cbsr_check(torch, g, dim: int, k: int, seed: int) -> dict:
    """stream_cbsr_spmm on A of the graph at (dim, k), under the mean (post
    only) and gcn (pre and post) factors: within 1e-5 of max |y| of the
    plain version in float64 (on the same masked input, which the records
    hold), equal by value to stream_spmm on that input, bitwise equal across
    two runs and to a run with no hot set. Timed beside stream_spmm on that
    input, the plain version, torch.sparse.mm on the dense input, the run
    with no hot set, and cbsr_compact + cbsr_records + stream_cbsr_spmm (the
    forward of the flag-on path). Returns the kernels-line entry (mean
    factors; gcn under prefixed keys)."""
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
    from spgemm_gnn_tpu_torch.kernels.cbsr import cbsr_compact
    from spgemm_gnn_tpu_torch.kernels.stream import (stream_cbsr_spmm,
                                                     stream_cbsr_spmm_at,
                                                     stream_spmm)
    from spgemm_gnn_tpu_torch.ops.maxk import (cbsr_records,
                                               packed_channel_words)
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    from spgemm_gnn_tpu_torch.ops.stream import (stream_cbsr_spmm_plain,
                                                 stream_spmm_plain)

    n, e = g.num_nodes, g.num_edges
    plan = build_stream_plan(g.indptr, g.indices)
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    xs = sparse_input(torch, n, dim, k, gen)
    vals, ch = cbsr_compact(xs, k)
    rec = cbsr_records(vals, ch, dim)
    del vals, ch
    kp = packed_channel_words(k, dim)
    hot = hot_keys(plan.hot_set(4 * (k + kp)))
    gathered = torch.bincount(g.indices, minlength=n).double()
    ops = 2.0 * float(((xs != 0).sum(1).double() * gathered).sum())
    entry = dict(name="stream_cbsr_spmm", route="cuda",
                 source="spgemm_gnn_tpu_torch/csrc/stream.cu",
                 replaces="spgemm_gnn_tpu/kernels/stream_pallas.py:90")
    for norm in ("mean", "gcn"):
        pre, post = node_factors(g, norm)

        def run():
            return stream_cbsr_spmm(plan, rec, k, dim, pre, post)

        def run_hot0():
            return stream_cbsr_spmm_at(plan, rec, k, dim, pre, post,
                                       hot_budget=0)

        def run_with_compact():
            v, c = cbsr_compact(xs, k)
            return stream_cbsr_spmm(plan, cbsr_records(v, c, dim), k, dim,
                                    pre, post)

        got, again = run(), run()
        ref = stream_spmm_plain(plan, xs.double(), pre, post)
        dense = stream_spmm(plan, xs, pre, post)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not rel <= 1e-5:
            raise AssertionError(f"stream_cbsr_spmm ({norm}) error {rel:.3e} "
                                 f"of max |y| > 1e-5")
        if not torch.equal(got, dense):
            raise AssertionError(f"stream_cbsr_spmm ({norm}) differs from "
                                 f"stream_spmm on the same input")
        if not bits_equal(torch, got, again):
            raise AssertionError(f"stream_cbsr_spmm ({norm}): two runs differ")
        if not bits_equal(torch, got, run_hot0()):
            raise AssertionError(f"stream_cbsr_spmm ({norm}): hot budget 0 "
                                 f"differs from the default")
        del ref, again, dense
        w = torch.ones(e, device="cuda")
        if pre is not None:
            w = w * pre[g.indices.long()]
        w = w * post[g.edge_dst.long()]
        a = torch.sparse_csr_tensor(g.indptr, g.indices, w, size=(n, n))
        n_bytes = (n * k * 4 + n * kp * 4 + e * 4 + (n + 1) * 4
                   + n * dim * 4 + (plan.num_chunks + plan.carry_rows.numel())
                   * 4 + 4 * n * ((pre is not None) + (post is not None)))
        b_ms, b_by = bound_ms(n_bytes, ops)
        gather_ms = e * (k * 4 + kp * 4 + 4) / PEAK_BYTES_S * 1e3
        r = dict(max_abs_err=err, rel=rel, ms=time_ms(torch, run, 10),
                 stream_spmm_ms=time_ms(
                     torch, lambda: stream_spmm(plan, xs, pre, post), 5),
                 plain_ms=time_ms(torch, lambda: stream_cbsr_spmm_plain(
                     plan, rec, k, dim, pre, post), 2),
                 library_ms=time_ms(torch, lambda: torch.sparse.mm(a, xs), 5),
                 compact_and_ms=time_ms(torch, run_with_compact, 10),
                 hot0_ms=time_ms(torch, run_hot0, 10), **hot,
                 bound_ms=b_ms, bound_by=b_by, no_reuse_gather_ms=gather_ms)
        del a, w
        log(f"kernel stream_cbsr_spmm (products, A, {norm} factors, dim "
            f"{dim}, k {k}): max abs err {err:.3e}, {rel:.3e} of max |y|; "
            f"equal by value to stream_spmm; bitwise equal across two runs; "
            f"{r['ms']:.3f} ms (stream_spmm on the same input "
            f"{r['stream_spmm_ms']:.3f}, plain {r['plain_ms']:.3f}, "
            f"torch.sparse.mm {r['library_ms']:.3f}, bound {b_ms:.3f} by "
            f"{b_by}, no-reuse gather {gather_ms:.3f}; "
            f"cbsr_compact + records + stream_cbsr_spmm "
            f"{r['compact_and_ms']:.3f})")
        log_hot(f"stream_cbsr_spmm, {norm} factors", r)
        if norm == "mean":
            entry.update({key: r[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "stream_spmm_ms", "compact_and_ms",
                "no_reuse_gather_ms", *HOT_KEYS)})
        else:
            entry.update({f"gcn_{key}": r[key] for key in (
                "max_abs_err", "ms", "bound_ms", "stream_spmm_ms",
                "library_ms", "hot0_ms")})
    return entry


def run_training(torch, trainer, expected: dict, what: str) -> dict:
    """Trainer.run from zeroed launch counts; checks finite losses and the
    exact counts. Returns the run's result and counts."""
    from spgemm_gnn_tpu_torch.kernels import _build
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    res = trainer.run()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    losses = [r.loss for r in res["history"]]
    log(f"{what}: losses {losses}")
    log(f"{what}: val acc {[r.val_acc for r in res['history']]}")
    log(f"{what}: steady_epoch_s {res['steady_epoch_s']}, wall "
        f"{res['wall_time_s']:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, allocator "
        f"retries {torch.cuda.memory_stats()['num_alloc_retries']}")
    if len(losses) != EPOCHS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{what}: losses not finite: {losses}")
    if counts != expected:
        raise AssertionError(f"{what}: launch counts {counts} != expected "
                             f"{expected}")
    log(f"{what}: launches {counts}")
    return dict(res=res, losses=losses, counts=counts)


def first_steps(torch, cfg, ds, what: str) -> None:
    """The first two train steps through the kernels (impl auto, with
    STREAM_CBSR_FORWARD as the caller set it) against the plain ops (impl
    torch): the same weights and dropout seed, losses within 1e-4
    relative."""
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    first = {}
    for impl in ("auto", "torch"):     # the kernels, then the plain ops
        tr = Trainer(cfg.replace(impl=impl), dataset=ds)
        state = tr.init_state()
        drop = torch.Generator(device=tr.device).manual_seed(SEED + 1)
        first[impl] = [float(tr.train_step(state, drop)) for _ in range(2)]
        del tr, state
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(first["auto"], first["torch"])]
    if not max(rel) <= 1e-4:
        raise AssertionError(f"{what}: first steps {first['auto']} vs plain "
                             f"{first['torch']} ({rel})")
    log(f"{what}: first two steps through the kernels {first['auto']}, "
        f"plain {first['torch']}, relative {rel}")


def cbsr_phase(torch, pg, dim: int, k: int, seed: int) -> list[dict]:
    """K5-K7 at the graph's node count, bitwise against their plain versions
    and timed; then the explicit CBSR path (compact → aggregate_cbsr forward
    and backward) through the kernels with its launches counted, held to the
    dense path."""
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.kernels import api
    from spgemm_gnn_tpu_torch.kernels.cbsr import (cbsr_compact, cbsr_densify,
                                                   cbsr_sample)
    from spgemm_gnn_tpu_torch.ops import maxk as plain

    n = pg.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = sparse_input(torch, n, dim, k, gen)
    z = torch.randn((n, dim), generator=gen, device="cuda")
    out = []

    vals, ch = cbsr_compact(xs, k)
    vals_p, ch_p = plain.cbsr_compact_plain(xs, k)
    dense = cbsr_densify(vals, ch, dim)
    sampled = cbsr_sample(z, ch)
    torch.cuda.synchronize()
    checks = (("cbsr_compact", (vals, ch), (vals_p, ch_p)),
              ("cbsr_densify", (dense,), (plain.cbsr_to_dense(vals, ch, dim),)),
              ("cbsr_sample", (sampled,), (plain.sample_channels(z, ch),)))
    errs = {}
    for name, got, want in checks:
        if not all(bits_equal(torch, a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version")
        # the channels' difference counts too (as ids, for cbsr_compact)
        errs[name] = max(float((a - b).abs().max()) for a, b in zip(got, want))
        log(f"kernel {name}: bitwise equal to plain, N={n} dim={dim} k={k}, "
            f"max abs err {errs[name]}")
    del vals_p, ch_p, checks
    ch_long = ch.long()
    nk = n * k * 4
    timings = (
        ("cbsr_compact", "spgemm_gnn_tpu/kernels/maxk_pallas.py:166",
         lambda: cbsr_compact(xs, k), lambda: plain.cbsr_compact_plain(xs, k),
         None, n * dim * 4 + 2 * nk),
        ("cbsr_densify", "spgemm_gnn_tpu/kernels/spgemm_pallas.py:340",
         lambda: cbsr_densify(vals, ch, dim),
         lambda: plain.cbsr_to_dense(vals, ch, dim),
         lambda: torch.zeros((n, dim), device="cuda").scatter_(1, ch_long,
                                                                vals),
         2 * nk + n * dim * 4),
        ("cbsr_sample", "spgemm_gnn_tpu/kernels/spgemm_pallas.py:385",
         lambda: cbsr_sample(z, ch), lambda: plain.sample_channels(z, ch),
         lambda: torch.gather(z, 1, ch_long), 3 * nk))
    for name, replaces, fn, fn_plain, fn_lib, n_bytes in timings:
        b, by = bound_ms(n_bytes, 0.0)
        out.append(dict(
            name=name, route="cuda", source="spgemm_gnn_tpu_torch/csrc/cbsr.cu",
            replaces=replaces, max_abs_err=errs[name],
            ms=time_ms(torch, fn, 10),
            plain_ms=time_ms(torch, fn_plain, 3), bound_ms=b, bound_by=by,
            library_ms=None if fn_lib is None else time_ms(torch, fn_lib, 10)))
        log(f"kernel {name}: {out[-1]['ms']:.3f} ms (plain "
            f"{out[-1]['plain_ms']:.3f}, library {out[-1]['library_ms']}, "
            f"bound {b:.3f} by {by})")
    out[1]["also_replaces"] = "spgemm_gnn_tpu/kernels/spgemm_pallas.py:285"
    del dense, sampled, z, ch_long

    # the explicit CBSR path, through the entry points a user calls
    ct = torch.randn((n, dim), generator=gen, device="cuda")
    x_in = xs.clone().requires_grad_(True)
    _build.launches.clear()
    v, c = api.cbsr_compact(x_in, k, impl="cuda")
    v.retain_grad()
    y = api.aggregate_cbsr(pg, v, c, dim, "mean", impl="cuda")
    (y * ct).sum().backward()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    expected = {"cbsr_compact": 1, "cbsr_densify": 2, "cbsr_sample": 1,
                f"{'stream' if pg.kind == 'stream' else 'csr'}_spmm": 2}
    if counts != expected:
        raise AssertionError(f"CBSR path: launch counts {counts} != "
                             f"{expected}")
    log(f"CBSR path (cbsr_compact → aggregate_cbsr → backward): launches "
        f"{counts}")
    for entry in out:
        entry["launches"] = counts[entry["name"]]
        entry["launches_path"] = "cbsr"
    if not bits_equal(torch, x_in.grad, plain.cbsr_to_dense(v.grad, c, dim)):
        raise AssertionError("CBSR path: dx is not the densify of dvalues")
    xd = plain.cbsr_to_dense(v.detach(), c, dim).requires_grad_(True)
    y_ref = api.aggregate(pg, xd, "mean", impl="torch")
    (y_ref * ct).sum().backward()
    _, rel_y = rel_err(y.detach(), y_ref.detach())
    _, rel_dv = rel_err(v.grad, plain.sample_channels(xd.grad, c))
    if not (rel_y <= 1e-5 and rel_dv <= 1e-5):
        raise AssertionError(f"CBSR path against the dense path: y "
                             f"{rel_y:.3e}, dvalues {rel_dv:.3e} of max > 1e-5")
    log(f"CBSR path against the dense plain path: y {rel_y:.3e}, dvalues "
        f"{rel_dv:.3e} of max")
    del xd, y_ref

    # the same path with STREAM_CBSR_FORWARD set: the forward takes
    # stream_cbsr_spmm on (values, channels) and densifies nothing
    from spgemm_gnn_tpu_torch.kernels import planned
    planned.STREAM_CBSR_FORWARD = True
    x_on = xs.clone().requires_grad_(True)
    _build.launches.clear()
    v_on, c_on = api.cbsr_compact(x_on, k, impl="cuda")
    v_on.retain_grad()
    y_on = api.aggregate_cbsr(pg, v_on, c_on, dim, "mean", impl="cuda")
    (y_on * ct).sum().backward()
    torch.cuda.synchronize()
    planned.STREAM_CBSR_FORWARD = False
    counts = dict(_build.launches)
    expected = {"cbsr_compact": 1, "stream_cbsr_spmm": 1, "stream_spmm": 1,
                "cbsr_sample": 1, "cbsr_densify": 1}
    if counts != expected:
        raise AssertionError(f"CBSR path, STREAM_CBSR_FORWARD: launch counts "
                             f"{counts} != {expected}")
    if not (torch.equal(y_on, y) and bits_equal(torch, v_on.grad, v.grad)
            and bits_equal(torch, x_on.grad, x_in.grad)):
        raise AssertionError("CBSR path, STREAM_CBSR_FORWARD: y or the "
                             "gradients differ from the flag-off path's")
    log(f"CBSR path with STREAM_CBSR_FORWARD: launches {counts} (the "
        f"forward densifies nothing); y equal by value, dvalues and dx "
        f"bitwise equal to the flag-off path's, so within {rel_y:.3e} and "
        f"{rel_dv:.3e} of the dense plain path")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    from spgemm_gnn_tpu_torch.graphs.csr import add_self_loops
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    from spgemm_gnn_tpu_torch.kernels import _build, planned
    from spgemm_gnn_tpu_torch.kernels.planned import plan_graph
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
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

    # ---- Reddit: the windowed kind -----------------------------------------
    t0 = time.perf_counter()
    ds = load_dataset("reddit", allow_synthetic=True, data_path="/nonexistent",
                      synthetic_scale=SCALE, seed=SEED)
    log(f"graph: reddit stand-in scale {SCALE}: N={ds.graph.num_nodes} "
        f"E={ds.graph.num_edges} features={ds.features.shape[1]} "
        f"classes={ds.num_classes}, host build {time.perf_counter() - t0:.1f} s")
    g = ds.graph = ds.graph.to(dev)
    if plan_graph(g).kind != "windowed":
        raise AssertionError("plan rule: reddit must take the windowed kind")
    log("plan: reddit takes the windowed kind (csr_spmm)")

    layers = 4
    kernels = maxk_phase(torch, g, HIDDEN, K, SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = sparse_input(torch, g.num_nodes, HIDDEN, K, gen)
    gy = torch.randn((g.num_nodes, HIDDEN), generator=gen, device=dev)
    _, post = node_factors(g, "mean")
    csr_a = product_check(torch, "csr_spmm", g, xs, None, post)
    log_product("csr_spmm", "reddit, A, k-sparse x", csr_a)
    csr_t = product_check(torch, "csr_spmm", g, gy, post, None, transpose=True)
    log_product("csr_spmm", "reddit, A^T, dense g", csr_t)
    if not csr_a["nb"] > 1:
        raise AssertionError("csr_spmm on reddit: the rule gave one source "
                             "block")
    stream_reddit = product_check(torch, "stream_spmm", g, xs, None, post)
    log_product("stream_spmm", "reddit, A, k-sparse x; measure only",
                stream_reddit)
    del xs, gy
    torch.cuda.empty_cache()

    cfg = TrainConfig(dataset="reddit", model="sage", nonlinear="maxk",
                      maxk=K, hidden_dim=HIDDEN, hidden_layers=layers,
                      norm=True, dropout=0.5, w_lr=0.01, epochs=EPOCHS,
                      eval_every=1, seed=SEED, device="cuda",
                      impl="auto", synthetic=True,
                      synthetic_scale=SCALE)
    first_steps(torch, cfg, ds, "train reddit")
    # per epoch: a train step (forward + backward) and an eval forward
    reddit = run_training(torch, Trainer(cfg, dataset=ds), {
        "maxk_fwd": EPOCHS * 2 * layers, "maxk_bwd": EPOCHS * layers,
        "csr_spmm": EPOCHS * 3 * layers}, "train reddit")
    if not reddit["losses"][-1] < reddit["losses"][0]:
        raise AssertionError(f"train reddit: loss did not fall: "
                             f"{reddit['losses']}")
    reddit_counts = reddit["counts"]
    for entry in kernels:
        entry["launches"] = reddit_counts[entry["name"]]
        entry["launches_path"] = "train reddit"
    del ds, g, reddit
    torch.cuda.empty_cache()

    for kind in ("windowed", "stream"):
        model_check(torch, SEED, kind)

    # ---- ogbn-products: the stream kind ------------------------------------
    t0 = time.perf_counter()
    ds2 = load_dataset("ogbn-products", allow_synthetic=True,
                       data_path="/nonexistent", synthetic_scale=SCALE,
                       seed=SEED)
    g2 = ds2.graph
    deg = g2.in_degrees
    log(f"graph 2: ogbn-products stand-in scale {SCALE}: N={g2.num_nodes} "
        f"E={g2.num_edges} features={ds2.features.shape[1]} "
        f"classes={ds2.num_classes}, median in-degree "
        f"{int(deg.median())}, max {int(deg.max())}, rows without in-edges "
        f"{int((deg == 0).sum())}, host build {time.perf_counter() - t0:.1f} s")
    g2 = ds2.graph = g2.to(dev)
    pg2 = plan_graph(g2)
    if pg2.kind != "stream":
        raise AssertionError("plan rule: ogbn-products must take the stream "
                             "kind")
    log(f"plan: ogbn-products takes the stream kind (stream_spmm): "
        f"{pg2.fwd_plan.num_chunks} chunks of {pg2.fwd_plan.chunk} edges, "
        f"{pg2.fwd_plan.carry_rows.numel()} carry rows")

    xs = sparse_input(torch, g2.num_nodes, HIDDEN, K, gen)
    gy = torch.randn((g2.num_nodes, HIDDEN), generator=gen, device=dev)
    _, post = node_factors(g2, "mean")
    stream_a = product_check(torch, "stream_spmm", g2, xs, None, post)
    log_product("stream_spmm", "products, A, k-sparse x", stream_a)
    stream_t = product_check(torch, "stream_spmm", g2, gy, post, None,
                             transpose=True)
    log_product("stream_spmm", "products, A^T, dense g", stream_t)
    csr_products = product_check(torch, "csr_spmm", g2, xs, None, post)
    if csr_products["nb"] != 1:
        raise AssertionError(f"csr_spmm on products: the rule gave "
                             f"{csr_products['nb']} source blocks, not 1")
    log_product("csr_spmm", "products, A, k-sparse x; measure only",
                csr_products)
    del xs, gy
    torch.cuda.empty_cache()
    cbsr_entry = stream_cbsr_check(torch, g2, HIDDEN, K, SEED)
    torch.cuda.empty_cache()

    kernels.append(product_entry("csr_spmm", csr_a, csr_t,
                                 products_=csr_products))
    kernels[-1].update(launches=reddit_counts["csr_spmm"],
                       launches_path="train reddit")
    kernels += cbsr_phase(torch, pg2, HIDDEN, K, SEED)
    torch.cuda.empty_cache()

    layers2 = 3
    cfg2 = TrainConfig(dataset="ogbn-products", model="sage",
                       nonlinear="maxk", maxk=K, hidden_dim=HIDDEN,
                       hidden_layers=layers2, norm=True, dropout=0.5,
                       w_lr=0.003, epochs=EPOCHS, eval_every=1, seed=SEED,
                       device="cuda", impl="auto", synthetic=True,
                       synthetic_scale=SCALE)
    first_steps(torch, cfg2, ds2, "train products")
    products = run_training(torch, Trainer(cfg2, dataset=ds2), {
        "maxk_fwd": EPOCHS * 2 * layers2, "maxk_bwd": EPOCHS * layers2,
        "stream_spmm": EPOCHS * 3 * layers2}, "train products")
    fell = products["losses"][-1] < products["losses"][0]
    log(f"train products: the loss {'fell' if fell else 'did not fall'} "
        f"over {EPOCHS} epochs at lr {cfg2.w_lr}")
    stream_entry = product_entry("stream_spmm", stream_a, stream_t,
                                 reddit_=stream_reddit)
    stream_entry.update(launches=products["counts"]["stream_spmm"],
                        launches_path="train products")
    kernels.insert(3, stream_entry)
    torch.cuda.empty_cache()

    # the same recipe with the CBSR stream forward: the same losses
    flag_on = {"maxk_fwd": EPOCHS * 2 * layers2, "maxk_bwd": EPOCHS * layers2,
               "cbsr_compact": EPOCHS * 2 * layers2,
               "stream_cbsr_spmm": EPOCHS * 2 * layers2,
               "stream_spmm": EPOCHS * layers2}
    planned.STREAM_CBSR_FORWARD = True
    products_on = run_training(torch, Trainer(cfg2, dataset=ds2), flag_on,
                               "train products, STREAM_CBSR_FORWARD")
    planned.STREAM_CBSR_FORWARD = False
    rel = max(abs(a - b) / abs(b) for a, b in zip(products_on["losses"],
                                                   products["losses"]))
    if not rel <= 1e-6:
        raise AssertionError(f"train products: flag-on losses "
                             f"{products_on['losses']} vs flag-off "
                             f"{products['losses']} ({rel:.3e})")
    same = products_on["losses"] == products["losses"]
    log(f"train products: STREAM_CBSR_FORWARD on against off: losses "
        f"{'bit-equal' if same else f'within {rel:.3e} relative'}; steady "
        f"epoch {products_on['res']['steady_epoch_s']} s on, "
        f"{products['res']['steady_epoch_s']} s off")
    del products, products_on
    torch.cuda.empty_cache()

    # ---- train 3: the products recipe with GCN and self-loops, flag set --
    t0 = time.perf_counter()
    ds3 = dataclasses.replace(ds2, graph=add_self_loops(g2))
    log(f"graph 3: ogbn-products stand-in with self-loops: "
        f"E={ds3.graph.num_edges}, host build {time.perf_counter() - t0:.1f} s")
    if plan_graph(ds3.graph).kind != "stream":
        raise AssertionError("plan rule: ogbn-products with self-loops must "
                             "take the stream kind")
    cfg3 = cfg2.replace(model="gcn", selfloop=True)
    planned.STREAM_CBSR_FORWARD = True
    first_steps(torch, cfg3, ds3, "train 3 (GCN)")
    gcn = run_training(torch, Trainer(cfg3, dataset=ds3), flag_on,
                       "train 3 (GCN, products, self-loops, "
                       "STREAM_CBSR_FORWARD)")
    planned.STREAM_CBSR_FORWARD = False
    cbsr_entry.update(launches=gcn["counts"]["stream_cbsr_spmm"],
                      launches_path="train 3 (GCN)")
    kernels.insert(4, cbsr_entry)
    del gcn, ds3
    torch.cuda.empty_cache()

    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
