"""Time the `csr_spmm` kernel over schedules on a recipe's graph, on the GPU:
source blocks and segment sizes (the measurements behind
`graphs/tiles.py::MIN_EDGES_PER_BLOCK_ROW` and `SEGMENT`).

    python -m spgemm_gnn_tpu_torch.utils.csr_sweep [--dataset reddit] \
        [--blocks auto,1,10] [--segments 512,1024] [--dim 256] [--iters 5] \
        [--stream f32|bf16x2]

On the synthetic stand-in at full size (seed 97), for A (the input MaxK at
k 32 then dropout 0.5, under the mean factors, as on the training path) and
Aᵀ (a dense cotangent): each schedule's sizes and build time, the kernel's
time over `--iters` launches (CUDA events), its error against the plain
version in float64 (as a share of max |y|), and `torch.sparse.mm` on the
same product. "auto" is the rule (`graphs/tiles.py::auto_src_blocks`);
`--segments` defaults to `SEGMENT`, the path's. `--stream bf16x2` runs the
16-bit form (csr_spmm_bf16 on the rows of round_rows, the pre factor folded
into them, as the planner does; "auto" then sizes blocks for 2-byte
channels), held to the plain version on the same bf16 rows.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import time

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


def sweep(dataset: str, blocks: list, segments: list[int], dim: int,
          iters: int, seed: int, stream: str) -> None:
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_fwd
    from spgemm_gnn_tpu_torch.kernels.round import round_rows
    from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    from spgemm_gnn_tpu_torch.ops.spmm import csr_spmm_plain

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    ds = load_dataset(dataset, allow_synthetic=True, data_path="/nonexistent",
                      synthetic_scale=1.0, seed=seed)
    g = ds.graph.to("cuda")
    n, e = g.num_nodes, g.num_edges
    print(f"{dataset}: N={n} E={e} dim={dim} stream {stream}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    y, _ = maxk_fwd(torch.randn((n, dim), generator=gen, device="cuda"), 32)
    keep = torch.rand((n, dim), generator=gen, device="cuda") >= 0.5
    xs = torch.where(keep, y / 0.5, torch.zeros_like(y))
    gy = torch.randn((n, dim), generator=gen, device="cuda")
    _, post = node_factors(g, "mean")
    for what, indptr, indices, rows, x, pre, pst in (
            ("A", g.indptr, g.indices, g.edge_dst, xs, None, post),
            ("A^T", g.t_indptr, g.t_indices, g.t_edge_dst, gy, post, None)):
        if stream == "bf16x2":
            x, pre = round_rows(x, pre), None
        ref = csr_spmm_plain(indptr, indices, x.double(), pre, pst)
        scale = float(ref.abs().max())
        w = torch.ones(e, device="cuda")
        if pre is not None:
            w = w * pre[indices.long()]
        if pst is not None:
            w = w * pst[rows.long()]
        a = torch.sparse_csr_tensor(indptr, indices, w.to(x.dtype),
                                    size=(n, n))
        print(f"{what}: torch.sparse.mm {time_ms(lambda: torch.sparse.mm(a, x), iters):.3f} ms",
              flush=True)
        del a, w
        for nb in blocks:
            for seg in segments:
                plan = CSRPlan(indptr, indices,
                               None if nb == "auto" else int(nb), seg)
                t0 = time.perf_counter()
                s = plan.schedule(n, dim, x.element_size())
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
                got = csr_spmm(plan, x, pre, pst)
                err = float((got - ref).abs().max()) / scale
                del got
                ms = time_ms(lambda: csr_spmm(plan, x, pre, pst), iters)
                print(f"{what} blocks {nb}->{s.nb} segment {seg}: "
                      f"{ms:.3f} ms, err {err:.3e} of max; segments "
                      f"{s.num_segments}, split runs {s.num_split_runs}, "
                      f"slots {s.n_slots}, extra "
                      f"{s.extra_bytes(indices) / 2**20:.1f} MiB, build "
                      f"{build_s:.2f} s", flush=True)
                del plan, s
                torch.cuda.empty_cache()
        del ref


def main(argv=None) -> None:
    from spgemm_gnn_tpu_torch.graphs.tiles import SEGMENT
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="reddit")
    ap.add_argument("--blocks", default="auto,1")
    ap.add_argument("--segments", default=str(SEGMENT))
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=97)
    ap.add_argument("--stream", default="f32", choices=["f32", "bf16x2"])
    args = ap.parse_args(argv)
    sweep(args.dataset, args.blocks.split(","),
          [int(s) for s in args.segments.split(",")], args.dim, args.iters,
          args.seed, args.stream)


if __name__ == "__main__":
    main()
