"""Benchmark primitives (counterpart of `spgemm_gnn_tpu/bench/harness.py`).

Timing: `time_chained` applies a step `iters` times, each on the previous
step's output (never on x0 again), after a warm-up step that also builds
the kernels and the plans' schedules at first use. On the card the time is
read between two CUDA events around the chain (the device's wall time for
it, launch gaps included); on the CPU with `time.perf_counter`.

Implementations (`bench_impl`'s `impl`), the JAX package's roles renamed:
  "cuda"  — the port's path (its "pallas"): `aggregate` through the plan's
            kernels on CUDA tensors, their plain versions on CPU tensors;
  "torch" — the plain gather/scatter product (ops/spmm.py; its "xla"
            baseline, the cuSPARSE role);
  "ell"   — the neighbor-group baseline (ops/ell.py; GNNAdvisor's role).

The chained steps keep x k-sparse: a step multiplies x by (1 + 1e-9 · y),
where the JAX package adds 1e-9 · y. An input that lost MaxK's sparsity
would mislead the port's k-sparse forwards, which compact x to its k
channels (kernels/planned.py::cbsr_forward).
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.synthetic import (powerlaw_graph, rmat_graph,
                                                   sbm_graph)
from spgemm_gnn_tpu_torch.kernels import planned
from spgemm_gnn_tpu_torch.kernels.api import aggregate, maxk_op
from spgemm_gnn_tpu_torch.kernels.planned import plan_graph
from spgemm_gnn_tpu_torch.ops.ell import ell_graph

# disk cache of the synthetic graphs, beside (not inside) the JAX package's
# `.bench_cache/` files
BENCH_CACHE = Path(__file__).resolve().parents[2] / ".bench_cache" / "torch"

GENERATORS = {"powerlaw": powerlaw_graph, "sbm": sbm_graph,
              "rmat": rmat_graph}
IMPLS = ("torch", "ell", "cuda")
# the impl `aggregate` / `aggregate_cbsr` take for each bench impl
API_IMPL = {"cuda": "auto", "torch": "torch", "ell": "ell"}

# The baselines' edge cap (the JAX package's XLA_BASELINE_EDGE_CAP): above
# it "torch" and "ell" are measured on a graph of the same generator cut to
# this many edges, and reported per edge (both are linear in E). The ELL
# gather alone is G × width × dim floats (about 15 GB at 14.3M edges).
BASELINE_EDGE_CAP = 6_000_000
BASELINES = ("torch", "ell")
# H100 SXM's memory rate (NVIDIA's data sheet), for the floors in bytes
PEAK_BYTES_S = 3.35e12


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _leaf(x: Any) -> torch.Tensor | None:
    """The first tensor in x (a tensor, a module's parameters, or a dict,
    list or tuple of those)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, torch.nn.Module):
        return next(x.parameters(), None)
    items = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (list, tuple)) else ())
    for item in items:
        t = _leaf(item)
        if t is not None:
            return t
    return None


def time_chained(step: Callable[[Any], Any], x0: Any, iters: int = 8,
                 max_seconds: float = 20.0) -> float:
    """Seconds per application of `step` (x -> x-like), each on the
    previous one's output. If one step takes more than max_seconds / iters,
    fewer are timed. A step that returns its input unchanged times
    independent calls on the same inputs."""
    leaf = _leaf(x0)
    if leaf is None:
        raise ValueError("time_chained: x0 holds no tensor to place it on a "
                         "device")
    dev = leaf.device

    def run(x, n: int):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                x = step(x)
            end.record()
            end.synchronize()
            return x, start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            x = step(x)
        return x, time.perf_counter() - t0

    x, _ = run(x0, 1)            # warm: kernel builds, schedules
    x, t1 = run(x, 1)
    if t1 * iters > max_seconds:
        iters = max(int(max_seconds / max(t1, 1e-9)), 1)
    _, t = run(x, iters)
    return t / iters


def _cached_graph(generator: str, n_nodes: int, n_edges: int, seed: int,
                  cache_dir: str | Path | None = None, **genkw):
    """A synthetic graph of `generator` ("powerlaw", "sbm" or "rmat";
    graphs/synthetic.py), built once and kept on disk as its edge list
    under `cache_dir` (default BENCH_CACHE), so that later runs skip the
    host build."""
    if generator not in GENERATORS:
        raise ValueError(f"unknown generator {generator!r}; expected one of "
                         f"{tuple(GENERATORS)}")
    tag = "pl" if generator == "powerlaw" else generator + "_".join(
        f"{k}{v}" for k, v in sorted(genkw.items()))
    name = f"{tag}_{n_nodes}_{n_edges}_{seed}.npz"
    path = Path(cache_dir or BENCH_CACHE) / name
    if path.exists():
        z = np.load(path)
        return from_edges(z["src"], z["dst"], int(z["n"]), symmetric=True)
    g = GENERATORS[generator](n_nodes, n_edges, seed=seed, **genkw)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, src=g.indices.numpy(), dst=g.edge_dst.numpy(),
             n=g.num_nodes)
    os.replace(tmp, path)
    return g


def _bench_inputs(n_nodes: int, n_edges: int, dim: int, k: int, seed: int,
                  plan_kw: dict | None, device, plan: bool = True,
                  generator: str = "powerlaw"):
    """(graph, planned graph or None, MaxK'd features xk, cotangent ct) on
    `device`: the graph from `_cached_graph` (n_edges directed draws before
    symmetrising), the features drawn on the device from `seed`."""
    device = torch.device(device)
    g = _cached_graph(generator, n_nodes, n_edges // 2, seed).to(device)
    pg = plan_graph(g, dim=dim, **(plan_kw or {})) if plan else None
    gen = torch.Generator(device=device).manual_seed(seed)
    x0 = torch.randn((g.num_nodes, dim), generator=gen, device=device)
    xk = maxk_op(x0, k, "auto")   # the masked activations the models carry
    ct = torch.randn((g.num_nodes, dim), generator=gen, device=device)
    return g, pg, xk, ct


def _step_fns(graph, xk, ct, dim: int, k: int, norm: str, impl: str):
    """(forward step, backward step, backward's initial state) of one impl,
    each x -> x-like and k-sparsity preserving. The backward step is the
    backward alone: autograd.grad through one retained forward graph with
    the chained cotangent."""
    api = API_IMPL[impl]
    ids = None
    if (impl == "cuda" and isinstance(graph, planned.PlannedGraph)
            and planned.sampled_backward(graph.bwd_plan, k, dim, xk.dtype)):
        # MaxK's kept channels, as the models pass them (`wants_channel_ids`)
        ids = maxk_op(xk, k, api, with_ids=True)[1]

    @torch.no_grad()
    def fwd_step(xv):
        return torch.addcmul(xv, xv, aggregate(graph, xv, norm, k, api),
                             value=1e-9)

    xv = xk.detach().requires_grad_()
    y = aggregate(graph, xv, norm, k, api, ids=ids)

    def bwd_step(c):
        (gx,) = torch.autograd.grad(y, xv, c, retain_graph=True)
        return torch.addcmul(c, c, gx, value=1e-9)

    return fwd_step, bwd_step, ct


def bench_impl(g, pg, xk, ct, dim: int, k: int, norm: str, impl: str,
               iters: int = 8, graph_override=None) -> dict[str, float]:
    """Time the forward and the backward of the model-level `aggregate` for
    one implementation: {fwd_s, bwd_s, fwd_gedges, bwd_gedges}.
    graph_override supplies a prepared structure (an ELLGraph for "ell",
    built from g when not given)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown bench impl {impl!r}; expected one of "
                         f"{IMPLS}")
    graph = graph_override
    if graph is None:
        graph = {"cuda": pg, "ell": None, "torch": g}[impl]
        if impl == "ell":
            graph = ell_graph(g)
    fwd_step, bwd_step, c0 = _step_fns(graph, xk, ct, dim, k, norm, impl)
    t_fwd = time_chained(fwd_step, xk, iters)
    t_bwd = time_chained(bwd_step, c0, iters)
    return {"fwd_s": t_fwd, "bwd_s": t_bwd,
            "fwd_gedges": g.num_edges / t_fwd / 1e9,
            "bwd_gedges": g.num_edges / t_bwd / 1e9}


def _relerr(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (1e-6 + b.abs().max()))


def validate_numerics(g, pg, xk, ct, dim: int, k: int,
                      norm: str = "mean") -> dict:
    """The port's path (f32 and bf16x2 streams) against the plain oracle
    ("torch"), forward and gradient, on the benchmarked inputs. Gradients
    are compared on MaxK's support: the planned path returns the unmasked
    cotangent, which MaxK's own backward masks next. Passes within the JAX
    package's thresholds (1e-3, 1e-3, 2e-2)."""

    def fwd(impl, graph):
        with torch.no_grad():
            return aggregate(graph, xk, norm, k, impl)

    def bwd(impl, graph):
        xv = xk.detach().requires_grad_()
        return torch.autograd.grad(aggregate(graph, xv, norm, k, impl), xv,
                                   ct)[0]

    support = xk != 0
    old = planned.DEFAULT_STREAM
    try:
        y_x = fwd("torch", g)
        g_x = bwd("torch", g) * support
        planned.DEFAULT_STREAM = "f32"
        y_p32 = fwd("auto", pg)
        g_p32 = bwd("auto", pg) * support
        planned.DEFAULT_STREAM = "bf16x2"
        y_p16 = fwd("auto", pg)
    finally:
        planned.DEFAULT_STREAM = old
    dev = xk.device
    out = {
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "num_edges": g.num_edges, "dim": dim, "k": k,
        "plan_kind": pg.kind,
        "fwd_f32_relerr_vs_oracle": _relerr(y_p32, y_x),
        "bwd_f32_relerr_vs_oracle": _relerr(g_p32, g_x),
        "fwd_bf16x2_relerr_vs_f32": _relerr(y_p16, y_p32),
        "recorded": time.strftime("%F %T"),
    }
    out["pass"] = (out["fwd_f32_relerr_vs_oracle"] < 1e-3
                   and out["bwd_f32_relerr_vs_oracle"] < 1e-3
                   and out["fwd_bf16x2_relerr_vs_f32"] < 2e-2)
    return out


def baseline_inputs(n_nodes: int, n_edges: int, dim: int, k: int,
                    seed: int, device):
    """The baselines' inputs above BASELINE_EDGE_CAP: the same generator at
    the cap's share of the nodes (at least 1024), without a plan."""
    scale = BASELINE_EDGE_CAP / n_edges
    return _bench_inputs(max(int(n_nodes * scale), 1024), BASELINE_EDGE_CAP,
                         dim, k, seed, None, device, plan=False)


def bench_aggregation(n_nodes: int, n_edges: int, dim: int, k: int,
                      impls=("torch", "cuda"), norm: str = "mean",
                      iters: int = 8, seed: int = 0,
                      plan_kw: dict | None = None,
                      device="cuda") -> dict[str, Any]:
    """Forward and backward aggregation timed on a synthetic power-law
    graph: {impl: {fwd_s, bwd_s, fwd_gedges, bwd_gedges[,
    subsampled_edges]}, plus the graph's size and plan kind}. The
    baselines above BASELINE_EDGE_CAP run on a cut graph (a line on stderr
    says so) and report per edge: their times are scaled to the full edge
    count."""
    g, pg, xk, ct = _bench_inputs(n_nodes, n_edges, dim, k, seed, plan_kw,
                                  device)
    out: dict[str, Any] = {"num_nodes": g.num_nodes,
                           "num_edges": g.num_edges, "dim": dim, "k": k,
                           "plan_kind": pg.kind}
    base = None
    for impl in impls:
        if impl in BASELINES and g.num_edges > BASELINE_EDGE_CAP:
            if base is None:
                base = baseline_inputs(n_nodes, n_edges, dim, k, seed,
                                       device)
                log(f"baselines on a cut graph: E={base[0].num_edges} of "
                    f"{g.num_edges} (above BASELINE_EDGE_CAP "
                    f"{BASELINE_EDGE_CAP}); per-edge rates")
            r = bench_impl(*base, dim, k, norm, impl, iters)
            ratio = g.num_edges / base[0].num_edges
            out[impl] = {"fwd_s": r["fwd_s"] * ratio,
                         "bwd_s": r["bwd_s"] * ratio,
                         "fwd_gedges": r["fwd_gedges"],
                         "bwd_gedges": r["bwd_gedges"],
                         "subsampled_edges": base[0].num_edges}
        else:
            out[impl] = bench_impl(g, pg, xk, ct, dim, k, norm, impl, iters)
    return out


def bench_training_step(dataset, config, iters: int = 4) -> dict[str, Any]:
    """Time per full training step (forward, backward, update) of a
    Trainer config, on a fresh state and dropout generator."""
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    tr = Trainer(config, dataset)
    state = tr.init_state()
    gen = torch.Generator(device=tr.device).manual_seed(config.seed + 1)

    def step(s):
        tr.train_step(s, gen)
        return s

    per = time_chained(step, state, iters)
    return {"step_s": per, "epochs_per_s": 1.0 / per,
            "edges_per_s": tr.g.num_edges / per}


def card(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them; "cpu" for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    import subprocess
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def copy_rate(device, nbytes: int = 1 << 30, iters: int = 10) -> float:
    """GB/s of one device-to-device copy of `nbytes` (at least 1 GiB by
    default), counting the bytes read and the bytes written."""
    a = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    b = torch.empty_like(a)

    def step(x):
        b.copy_(x)
        return x

    return 2 * nbytes / time_chained(step, a, iters) / 1e9


def gather_rate(device, rows: int = 1 << 20, row_bytes: int = 1024,
                gathers: int = 1 << 20, iters: int = 10,
                seed: int = 0) -> float:
    """GB/s of gathering `gathers` random rows of `row_bytes` (1 KB, an
    f32 row of 256) from a table of `rows` (1 GiB by default) into a dense
    output, counting the row bytes read and written."""
    src = torch.empty((rows, row_bytes // 4), dtype=torch.float32,
                      device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, rows, (gathers,), generator=gen, device=device)
    out = torch.empty((gathers, row_bytes // 4), dtype=torch.float32,
                      device=device)

    def step(i):
        torch.index_select(src, 0, i, out=out)
        return i

    return 2 * gathers * row_bytes / time_chained(step, idx, iters) / 1e9
