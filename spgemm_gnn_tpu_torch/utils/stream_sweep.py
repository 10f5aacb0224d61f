"""Time the stream kernels over hot-set budgets and launch shapes on a
recipe's graph, on the GPU (the measurements behind
`graphs/stream_tiles.py::HOT_BUDGET` and `kernels/stream.py`'s DEPTHS,
BATCHES).

    python -m spgemm_gnn_tpu_torch.utils.stream_sweep \
        [--dataset ogbn-products] [--budgets 0,10,20,30,40] \
        [--depths 4,8,16] [--batches 4,8,16] [--iters 5]

On the synthetic stand-in at full size (seed 97): `stream_spmm` on A (the
input MaxK at k 32 then dropout 0.5, under the mean factors, as on the
training path) and on Aᵀ (a dense cotangent, the mean factor as pre) at each
budget (MiB of L2), fetch depth and chunks per warp; `stream_cbsr_spmm` on A
(the records of the same input) at each budget, batch of edges loaded ahead
and chunks per warp, and its scatter-free variant (values summed in
registers, no shared-memory scatter: a wrong y by design, timed to measure
what the scatter costs) at each batch. Every other configuration must give
the bits of the kernel's defaults. One line per configuration: the time
over `--iters` launches (CUDA events) and the hot set's rows and edge share.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import itertools
import subprocess

import torch


def time_ms(fn, iters: int) -> float:
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


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def sweep(dataset: str, budgets: list[int], depths: list[int],
          batches: list[int], dim: int, k: int, iters: int,
          seed: int) -> None:
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
    from spgemm_gnn_tpu_torch.kernels.cbsr import cbsr_compact
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_fwd
    from spgemm_gnn_tpu_torch.kernels.stream import (stream_cbsr_spmm,
                                                     stream_cbsr_spmm_at,
                                                     stream_spmm,
                                                     stream_spmm_at)
    from spgemm_gnn_tpu_torch.ops.maxk import cbsr_records
    from spgemm_gnn_tpu_torch.ops.norms import node_factors

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    ds = load_dataset(dataset, allow_synthetic=True, data_path="/nonexistent",
                      synthetic_scale=1.0, seed=seed)
    g = ds.graph.to("cuda")
    del ds
    n, e = g.num_nodes, g.num_edges
    print(f"{dataset}: N={n} E={e} dim={dim} k={k}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    y, _ = maxk_fwd(torch.randn((n, dim), generator=gen, device="cuda"), k)
    keep = torch.rand((n, dim), generator=gen, device="cuda") >= 0.5
    xs = torch.where(keep, y / 0.5, torch.zeros_like(y))
    del y, keep
    gy = torch.randn((n, dim), generator=gen, device="cuda")
    _, post = node_factors(g, "mean")

    def line(what: str, ms: float, hot) -> None:
        print(f"{what}: {ms:.3f} ms; hot set {hot.rows} rows, "
              f"{hot.edge_share:.2%} of the edges", flush=True)

    for what, indptr, indices, x, pre, pst in (
            ("A", g.indptr, g.indices, xs, None, post),
            ("A^T", g.t_indptr, g.t_indices, gy, post, None)):
        plan = build_stream_plan(indptr, indices)
        want = stream_spmm(plan, x, pre, pst)
        for mib, depth in itertools.product(budgets, depths):
            def run():
                return stream_spmm_at(plan, x, pre, pst, hot_budget=mib << 20,
                                      depth=depth)
            if not _same_bits(run(), want):
                raise AssertionError(f"stream_spmm {what} budget {mib} depth "
                                     f"{depth}: bits differ")
            line(f"stream_spmm {what} budget {mib} MiB depth {depth}",
                 time_ms(run, iters),
                 plan.hot_set(4 * dim, mib << 20))
        del want, plan
        torch.cuda.empty_cache()

    plan = build_stream_plan(g.indptr, g.indices)
    vals, ch = cbsr_compact(xs, k)
    rec = cbsr_records(vals, ch, dim)
    del vals, ch, gy
    row_bytes = 4 * rec.shape[1]
    want = stream_cbsr_spmm(plan, rec, k, dim, None, post)
    for mib, batch in itertools.product(budgets, batches):
        def run():
            return stream_cbsr_spmm_at(plan, rec, k, dim, None, post,
                                       hot_budget=mib << 20, batch=batch)
        if not _same_bits(run(), want):
            raise AssertionError(f"stream_cbsr_spmm budget {mib} batch "
                                 f"{batch}: bits differ")
        line(f"stream_cbsr_spmm A budget {mib} MiB batch {batch}",
             time_ms(run, iters),
             plan.hot_set(row_bytes, mib << 20))
    for batch in batches:
        def run_free():
            return stream_cbsr_spmm_at(plan, rec, k, dim, None, post,
                                       batch=batch, scatter=False)
        line(f"stream_cbsr_spmm A scatter-free variant (wrong y) batch "
             f"{batch}", time_ms(run_free, iters), plan.hot_set(row_bytes))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="ogbn-products")
    ap.add_argument("--budgets", default="0,10,20,30,40",
                    help="hot-set budgets in MiB")
    ap.add_argument("--depths", default="4,8,16",
                    help="stream_spmm rows fetched ahead")
    ap.add_argument("--batches", default="4,8,16",
                    help="stream_cbsr_spmm edges loaded ahead")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=97)
    args = ap.parse_args(argv)

    def ints(s: str) -> list[int]:
        return [int(v) for v in s.split(",")]

    sweep(args.dataset, ints(args.budgets), ints(args.depths),
          ints(args.batches), args.dim, args.k, args.iters, args.seed)


if __name__ == "__main__":
    main()
