"""Kernel benchmark of the port (counterpart of the repository's
`kernel_bench.py`, which stays JAX-only): k × implementations over a
corpus of synthetic graphs, the CBSR aggregation pair (`aggregate_cbsr`)
timed forward and backward, optionally validated against the plain
oracle first.

Usage:
  python -m spgemm_gnn_tpu_torch.bench.kernels            # synth-mid-dense
  python -m spgemm_gnn_tpu_torch.bench.kernels --graphs sweep --json
  python -m spgemm_gnn_tpu_torch.bench.kernels --k 8 16 32 64 \\
      --impls torch ell cuda --generator sbm --stream bf16x2 --validate
  python -m spgemm_gnn_tpu_torch.bench.kernels --op maxk   # MaxK alone
  python -m spgemm_gnn_tpu_torch.bench.kernels --op sample --rows 2449029 \
      --k 32                      # cbsr_sample beside its sector floor
  python -m spgemm_gnn_tpu_torch.bench.kernels --device cpu --validate

`--graphs` takes the names of SYNTH_CORPUS, "sweep" (CORPUS_SWEEP) or a
dataset's name (its npz under --data_path; a missing file raises, as
`load_dataset` does). Impls: "cuda" (the port's planned path: the kernels
on the card, their plain versions on the CPU), "torch" (the plain oracle),
"ell" (the neighbor-group baseline). A failure exits non-zero. Rows go to
stdout (a table, or JSON lines with --json), progress to stderr.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from spgemm_gnn_tpu_torch.bench import harness

# synthetic corpus over the reference's 24-graph suite's regimes (average
# degree 5 to 492): nodes, edges (directed draws before symmetrising)
SYNTH_CORPUS = {
    "synth-tiny": (2_000, 20_000),                 # the CPU's default
    "synth-tiny-dense": (4_300, 430_000),          # deg 100
    "synth-deg5": (400_000, 2_000_000),
    "synth-mid-sparse": (200_000, 2_000_000),      # deg 10
    "synth-flickr-like": (89_250, 1_960_000),      # deg ~22
    "synth-products-like": (60_000, 3_000_000),    # deg 50
    "synth-mid-dense": (60_000, 6_000_000),        # deg 100
    "synth-deg200": (15_000, 3_000_000),
    "synth-reddit-density": (8_000, 3_936_000),    # deg 492
    "synth-small-dense": (10_000, 1_000_000),      # deg 100
    "synth-reddit-like": (232_965, 25_000_000),
}

# the default sweep: 8 regimes from average degree 5 to 492
CORPUS_SWEEP = ["synth-tiny-dense", "synth-deg5", "synth-mid-sparse",
                "synth-flickr-like", "synth-products-like", "synth-mid-dense",
                "synth-deg200", "synth-reddit-density"]

def _validate_rows(pg, g, vals, ch, dim: int, n_sample: int = 256,
                   seed: int = 0) -> float:
    """Relative max error of the planned forward (mean) against a mean of
    the in-neighbours' densified rows computed for a sample of rows only:
    O(sample · degree) work, so it checks the timed plan at any size."""
    from spgemm_gnn_tpu_torch.kernels.api import aggregate_cbsr
    from spgemm_gnn_tpu_torch.ops.maxk import cbsr_to_dense
    with torch.no_grad():
        y = aggregate_cbsr(pg, vals, ch, dim, "mean", "auto")
    rng = np.random.default_rng(seed)
    rows = np.unique(rng.integers(0, g.num_nodes, n_sample))
    host = g.host_arrays()
    indptr, indices = host["indptr"], host["indices"]
    segs = [indices[indptr[r]:indptr[r + 1]] for r in rows]
    counts = np.array([len(s) for s in segs], np.int64)
    if not counts.sum():
        return 0.0
    dev = vals.device
    nbr = torch.from_numpy(np.concatenate(segs).astype(np.int64)).to(dev)
    msgs = cbsr_to_dense(vals[nbr].float(), ch[nbr], dim)
    seg = torch.from_numpy(np.repeat(np.arange(len(rows)), counts)).to(dev)
    ref = torch.zeros((len(rows), dim), device=dev).index_add_(0, seg, msgs)
    ref = ref / torch.from_numpy(np.maximum(counts, 1)).to(dev)[:, None]
    got = y[torch.from_numpy(rows).to(dev)]
    return float((got - ref).abs().max() / (1e-6 + ref.abs().max()))


def _row_text(row: dict, impls) -> str:
    parts = [f"k={row['k']:3d}"]
    for impl in impls:
        parts.append(f"{impl}: fwd {row[f'{impl}_fwd_ms']:8.2f}ms "
                     f"bwd {row[f'{impl}_bwd_ms']:8.2f}ms "
                     f"({row[f'{impl}_gedges']:.3f} Ge/s)")
    if "cuda_gedges" in row and "torch_gedges" in row:
        parts.append(f"speedup "
                     f"{row['cuda_gedges'] / row['torch_gedges']:.2f}x")
    return "  ".join(parts)


def run_graph(gname: str, args, dev) -> list[dict]:
    """Rows of one graph: per k, each impl's forward and backward."""
    from spgemm_gnn_tpu_torch.kernels.api import aggregate_cbsr
    from spgemm_gnn_tpu_torch.kernels.planned import plan_graph
    from spgemm_gnn_tpu_torch.ops.ell import ell_graph
    from spgemm_gnn_tpu_torch.ops.maxk import maxk_cbsr

    meta = {}
    if gname in SYNTH_CORPUS:
        n, e = SYNTH_CORPUS[gname]
        g = harness._cached_graph(args.generator, n, e // 2, 0)
        meta = {"generator": args.generator}
    else:
        from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
        g = load_dataset(gname, args.data_path).graph
    g = g.to(dev)
    pg = plan_graph(g, dim=args.dim)
    graphs = {"cuda": pg, "torch": g}
    if "ell" in args.impls:
        graphs["ell"] = ell_graph(g)
    harness.log(f"# {gname}: N={g.num_nodes} E={g.num_edges} "
                f"avg_deg={g.num_edges / g.num_nodes:.1f} plan={pg.kind}")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((g.num_nodes, args.dim), generator=gen, device=dev)
    ct = torch.randn((g.num_nodes, args.dim), generator=gen, device=dev)
    rows = []
    for k in args.k:
        vals, ch = maxk_cbsr(x, k)
        row = {"graph": gname, "k": k, "dim": args.dim,
               "edges": g.num_edges, **meta}
        y0 = None
        for impl in args.impls:
            graph, api = graphs[impl], harness.API_IMPL[impl]

            def fwd(v, _g=graph, _api=api):
                return aggregate_cbsr(_g, v, ch, args.dim, "mean", _api)

            if args.validate and impl != "torch":
                with torch.no_grad():
                    if y0 is None:
                        y0 = aggregate_cbsr(g, vals, ch, args.dim, "mean",
                                            "torch")
                    y = fwd(vals)
                row[f"{impl}_err"] = float((y - y0).abs().max()
                                           / (1e-6 + y0.abs().max()))
                if impl == "cuda":
                    row["cuda_rows_err"] = _validate_rows(pg, g, vals, ch,
                                                          args.dim)

            @torch.no_grad()
            def fstep(v, _f=fwd, _k=k):
                return v + _f(v)[:, :_k] * 1e-9

            vv = vals.detach().requires_grad_()
            y = fwd(vv)

            def bstep(c, _y=y, _v=vv):
                # the backward alone, through the retained forward graph
                (dv,) = torch.autograd.grad(_y, _v, c, retain_graph=True)
                return c.add(dv.sum(), alpha=1e-9)

            t_f = harness.time_chained(fstep, vals, args.iters)
            t_b = harness.time_chained(bstep, ct, args.iters)
            row[f"{impl}_fwd_ms"] = t_f * 1e3
            row[f"{impl}_bwd_ms"] = t_b * 1e3
            row[f"{impl}_edges"] = g.num_edges
            row[f"{impl}_gedges"] = 2 * g.num_edges / (t_f + t_b) / 1e9
            del y, vv
        rows.append(row)
        print(json.dumps(row) if args.json else _row_text(row, args.impls),
              flush=True)
    return rows


def run_op(args, dev) -> list[dict]:
    """--op maxk | cbsr: the MaxK forward kernel, or the CBSR compaction
    kernel, against its plain version on random rows [--rows, dim]."""
    from spgemm_gnn_tpu_torch.kernels.api import cbsr_compact, maxk_op
    from spgemm_gnn_tpu_torch.ops.maxk import (cbsr_compact_plain,
                                               cbsr_to_dense, maxk)
    n = args.rows or (200_000 if dev.type == "cuda" else 2_000)
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = torch.randn((n, args.dim), generator=gen, device=dev)
    rows = []
    for k in args.k:
        row = {"op": args.op, "n": n, "dim": args.dim, "k": k}
        if args.op == "maxk":
            f_k = lambda xv, _k=k: maxk_op(xv, _k, "auto")   # noqa: E731
            f_p = lambda xv, _k=k: maxk(xv, _k)              # noqa: E731
            x = x0
            if args.validate:
                row["err"] = float((f_k(x) - f_p(x)).abs().max())

            def step(f):
                return lambda xv: xv + f(xv) * 1e-9
        else:
            x = maxk(x0, k)
            f_k = lambda xv, _k=k: cbsr_compact(xv, _k, "auto")  # noqa
            f_p = lambda xv, _k=k: cbsr_compact_plain(xv, _k)    # noqa
            if args.validate:
                (vk, ck), (vp, cp) = f_k(x), f_p(x)
                row["err"] = float((cbsr_to_dense(vk, ck, args.dim)
                                    - cbsr_to_dense(vp, cp, args.dim)
                                    ).abs().max())

            # a multiplicative chain keeps the masked pattern (<= k
            # nonzeros a row), the compaction's precondition
            def step(f):
                return lambda xv: xv * (1 + f(xv)[0].sum() * 1e-9)
        with torch.no_grad():
            t_k = harness.time_chained(step(f_k), x, args.iters)
            t_p = harness.time_chained(step(f_p), x, args.iters)
        row["cuda_ms"] = t_k * 1e3
        row["torch_ms"] = t_p * 1e3
        row["speedup"] = t_p / t_k
        rows.append(row)
        print(json.dumps(row) if args.json else
              f"{args.op} k={k:3d}  cuda {t_k * 1e3:7.3f}ms  torch "
              f"{t_p * 1e3:7.3f}ms  ({t_p / t_k:.2f}x)", flush=True)
    return rows


def _sector_bytes(ch: torch.Tensor, elem: int) -> int:
    """Bytes of the distinct 32-B sectors that reading each row's channels
    ch[r] of a row of `elem`-byte values touches (the card moves whole
    sectors)."""
    s = (ch // (32 // elem)).sort(dim=1).values
    distinct = 1 + (s[:, 1:] != s[:, :-1]).sum(dim=1)
    return int(distinct.sum()) * 32


def run_sample(args, dev) -> list[dict]:
    """--op sample: `cbsr_sample` (z[r, ch[r, j]], f32 and bf16 z) against
    its plain version (`torch.gather`) at MaxK's channels of random rows,
    beside two floors over 3.35 TB/s: the bytes the function needs (z's k
    values, the ids, the output, each once) and the bytes of the 32-B
    sectors its random channel reads touch (with the ids and the output)."""
    from spgemm_gnn_tpu_torch.kernels.cbsr import cbsr_sample
    from spgemm_gnn_tpu_torch.ops.maxk import maxk_cbsr, sample_channels
    n = args.rows or (200_000 if dev.type == "cuda" else 2_000)
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = torch.randn((n, args.dim), generator=gen, device=dev)
    rows = []
    for k in args.k:
        _, ch = maxk_cbsr(x0, k)
        row = {"op": "sample", "n": n, "dim": args.dim, "k": k}
        for tag, z in (("", x0), ("bf16_", x0.to(torch.bfloat16))):
            elem = z.element_size()
            if args.validate:
                row[f"{tag}err"] = float(
                    (cbsr_sample(z, ch) - sample_channels(z, ch)).abs().max())
            def step(f, _z=z):
                def run(c):        # independent calls on the same ids
                    f(_z, c)
                    return c
                return run

            ms = harness.time_chained(step(cbsr_sample), ch, args.iters) * 1e3
            plain_ms = harness.time_chained(step(sample_channels), ch,
                                            args.iters) * 1e3
            need = n * k * (elem + 4 + elem)
            sectors = _sector_bytes(ch, elem) + n * k * (4 + elem)
            row.update({f"{tag}cuda_ms": ms, f"{tag}torch_ms": plain_ms,
                        f"{tag}bound_bytes": need,
                        f"{tag}sector_bytes": sectors})
            if dev.type == "cuda":      # the card's floors, not the CPU's
                row.update({
                    f"{tag}bound_ms": need / harness.PEAK_BYTES_S * 1e3,
                    f"{tag}sector_floor_ms":
                        sectors / harness.PEAK_BYTES_S * 1e3})
        rows.append(row)
        print(json.dumps(row) if args.json else
              f"sample k={k:3d}  f32 {row['cuda_ms']:7.3f}ms  bf16 "
              f"{row['bf16_cuda_ms']:7.3f}ms  sector bytes "
              f"{row['sector_bytes']} / {row['bf16_sector_bytes']}",
              flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spgemm_gnn_tpu_torch.bench.kernels")
    ap.add_argument("--graphs", nargs="*", default=None,
                    help=f"graph names: {list(SYNTH_CORPUS)}, 'sweep' (the "
                         f"8-regime corpus) or dataset names (default "
                         f"synth-mid-dense; synth-tiny on the CPU)")
    ap.add_argument("--k", nargs="*", type=int, default=[8, 16, 32, 64])
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--impls", nargs="*", default=["torch", "cuda"],
                    choices=list(harness.IMPLS))
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--data_path", default="./data")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--validate", action="store_true",
                    help="each impl against the plain oracle before timing")
    ap.add_argument("--json", action="store_true", help="JSON-lines output")
    ap.add_argument("--generator", default="powerlaw",
                    choices=list(harness.GENERATORS),
                    help="synthetic family: sbm / rmat carry latent "
                         "community structure")
    ap.add_argument("--stream", default="f32", choices=["f32", "bf16x2"],
                    help="the kernels' feature stream (f32 for exact "
                         "comparisons with the oracle)")
    ap.add_argument("--op", default="spgemm",
                    choices=["spgemm", "maxk", "cbsr", "sample"],
                    help="spgemm: the aggregation pair; maxk: the MaxK "
                         "forward kernel; cbsr: the compaction kernel; "
                         "sample: the channel gather (cbsr_sample) beside "
                         "its sector floor")
    ap.add_argument("--rows", type=int, default=None,
                    help="rows of --op's input (200000 on the GPU, 2000 on "
                         "the CPU)")
    args = ap.parse_args(argv)

    from spgemm_gnn_tpu_torch.kernels import planned
    from spgemm_gnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    planned.DEFAULT_STREAM = args.stream
    harness.log(f"# device: {harness.card(dev)}; torch {torch.__version__}; "
                f"stream {args.stream}")
    if args.op == "sample":
        run_sample(args, dev)
        return 0
    if args.op != "spgemm":
        run_op(args, dev)
        return 0
    graphs = args.graphs or (["synth-mid-dense"] if dev.type == "cuda"
                             else ["synth-tiny"])
    if graphs == ["sweep"]:
        graphs = CORPUS_SWEEP
    for gname in graphs:
        run_graph(gname, args, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
