"""Headline benchmark of the port (counterpart of the repository's
`bench.py`, which stays JAX-only): prints ONE JSON line on stdout,

  {"metric": ..., "value": N, "unit": "Gedges/s", "vs_baseline": N, ...}

the MaxK aggregation pair (forward and backward of `aggregate` on MaxK'd
activations, k 32, dim 256) through the port's kernels on a synthetic
power-law graph, as edges/s (the harmonic mean of the forward's and the
backward's rates). `vs_baseline` is the speed-up over the plain
gather/scatter product ("torch"), `vs_ell` over the neighbor-group
baseline; above BASELINE_EDGE_CAP edges both baselines run on a cut graph
and compare per edge. On the card the line also carries two rates measured
in the same run, a 1-GiB device-to-device copy and a gather of random 1-KB
rows (bytes read plus written per second), and the card's name and power
limit; on the CPU those are null.

Usage:
  python -m spgemm_gnn_tpu_torch.bench [--scale medium] [--device cpu]
      [--iters N] [--stream f32|bf16x2] [--validate]
Progress goes to stderr. A failure of any phase exits non-zero with no
line. --validate holds the kernels to the plain versions
(`harness.validate_numerics`), writes the record under `.bench_cache/torch/`
and puts its pass into the line; a failed validation exits 1 after the
line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

SCALES = {
    # nodes, edges (directed draws before symmetrising)
    "micro": (2_000, 20_000),
    "tiny": (20_000, 400_000),
    "small": (60_000, 3_000_000),
    # an eighth of Reddit's nodes at Reddit's average degree (~492)
    "medium": (29_121, 14_325_000),
    "large": (58_241, 28_650_000),    # a quarter of Reddit's nodes
    "full": (232_965, 114_000_000),   # Reddit's size
    # products' density: the stream plan (average degree ~25)
    "sparse": (200_000, 5_000_000),
    "mid-dense": (60_000, 6_000_000),
    "deg50": (60_000, 3_000_000),
}


def _rate(r: dict) -> float:
    return 2.0 / (1.0 / r["fwd_gedges"] + 1.0 / r["bwd_gedges"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spgemm_gnn_tpu_torch.bench")
    ap.add_argument("--scale", default=None, choices=list(SCALES),
                    help="medium on the GPU, micro on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--stream", default="bf16x2", choices=["f32", "bf16x2"],
                    help="the kernels' feature stream (planned."
                         "DEFAULT_STREAM)")
    ap.add_argument("--validate", action="store_true",
                    help="the kernels against the plain versions, f32 and "
                         "bf16x2, on the benchmarked inputs")
    args = ap.parse_args(argv)

    import torch

    from spgemm_gnn_tpu_torch.bench import harness
    from spgemm_gnn_tpu_torch.kernels import planned
    from spgemm_gnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    scale = args.scale or ("medium" if cuda else "micro")
    log = harness.log
    metric = f"maxk_spgemm_aggregation_{scale}_k{args.k}"
    card = harness.card(dev)
    log(f"device: {card}; torch {torch.__version__}; stream {args.stream}")
    planned.DEFAULT_STREAM = args.stream
    n, e = SCALES[scale]

    val = None
    if args.validate:
        val = harness.validate_numerics(
            *harness._bench_inputs(n, e, args.dim, args.k, 0, None, dev),
            args.dim, args.k)
        path = harness.BENCH_CACHE / f"validate_{metric}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(val, indent=1))
        log(f"validate: {val} -> {path}")

    t0 = time.perf_counter()
    res = harness.bench_aggregation(n, e, args.dim, args.k,
                                    impls=("cuda", *harness.BASELINES),
                                    iters=args.iters, device=dev)
    log(f"bench_aggregation: {res} ({time.perf_counter() - t0:.1f} s)")
    eps = _rate(res["cuda"])
    # message bytes gathered per second: E · dim · (2 or 4 B) a pass
    stream_bytes = 2 if args.stream == "bf16x2" else 4
    result = {
        "metric": metric, "value": eps, "unit": "Gedges/s",
        "vs_baseline": eps / _rate(res["torch"]),
        "vs_ell": eps / _rate(res["ell"]),
        "stream": args.stream,
        "msg_gbps": eps * args.dim * stream_bytes,
        "num_nodes": res["num_nodes"], "num_edges": res["num_edges"],
        "plan_kind": res["plan_kind"],
        "baseline_edges": res["torch"].get("subsampled_edges",
                                           res["num_edges"]),
        "device": card,
        "copy_gbps": harness.copy_rate(dev) if cuda else None,
        "gather_gbps": harness.gather_rate(dev) if cuda else None,
    }
    if val is not None:
        result["validate_pass"] = val["pass"]
    print(json.dumps(result), flush=True)
    return 0 if val is None or val["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
