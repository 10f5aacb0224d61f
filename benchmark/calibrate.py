"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size (the benchmark's runs never run this).

    python -m benchmark.calibrate --workload <cell> --seeds 11 12 ... \
        [--faults 3] [--out benchmark/cache/calibrate]

For each seed, in one process (the graph is built once): the program's
first steps through `Trainer.run` as a run takes them (`run.first_steps`),
the plain reference, and the control: the reference put in the program's
place at the precision below the traffic's (f32: TF32; bfloat16: fp8
e4m3), each read against the reference by `compare.readings`. On the first
`--faults` seeds, each planted fault (`faults.py`) too. Prints one JSON
line per reading and, last, the largest sound reading, the smallest
control reading and the smallest reading of each fault, number by number.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

from benchmark import cells, compare, faults, graphgen, reference, run

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def program_steps(config, traffic, seed, device, graph, fault=None):
    """The program's first steps on `seed`, with `fault` planted."""
    import torch
    trainer, state, host = run.prepare(config, traffic, seed, device, graph)
    if fault is not None:
        faults.FAULTS[fault](trainer, state)
    steps, _ = run.first_steps(trainer, state, traffic["compared_steps"],
                               traffic["epochs_per_call"])
    del trainer, state
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return steps, host


def reference_steps(config, traffic, seed, device, indptr, indices, host,
                    precision="f32"):
    import torch
    out = reference.train_steps(
        torch.from_numpy(indptr.astype("int32")), torch.from_numpy(indices),
        host.to(device), config["model"], dropout_seed=seed + 1,
        model_file=cells.model_file(config), steps=traffic["compared_steps"],
        precision=precision, dtype=traffic["dtype"])
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def calibrate(config, traffic, seeds, n_faults, device, emit):
    """Readings of every seed (emitted as they come); returns the summary."""
    indptr, indices, _ = graphgen.load_graph(config)
    graph = run.build_graph(indptr, indices, device)
    control = CONTROL[traffic["dtype"]]
    sound, ctrl, planted = [], [], {f: [] for f in faults.FAULTS}
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        prog, host = program_steps(config, traffic, seed, device, graph)
        ref = reference_steps(config, traffic, seed, device, indptr, indices,
                              host)
        low = reference_steps(config, traffic, seed, device, indptr, indices,
                              host, control)
        sound.append(compare.readings(prog, ref))
        ctrl.append(compare.readings(low, ref))
        emit({"seed": seed, "kind": "sound", **sound[-1],
              "losses": prog.losses, "ref_losses": ref.losses})
        emit({"seed": seed, "kind": f"control-{control}", **ctrl[-1]})
        if i < n_faults:
            for name in faults.FAULTS:
                bad, _ = program_steps(config, traffic, seed, device, graph,
                                       fault=name)
                planted[name].append(compare.readings(bad, ref))
                emit({"seed": seed, "kind": f"fault-{name}",
                      **planted[name][-1]})
        print(f"[calibrate] seed {seed}: {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
    summary = {"lower": {k: max(r[k] for r in sound) for k in compare.NAMES},
               f"control-{control}": {k: min(r[k] for r in ctrl)
                                      for k in compare.NAMES}}
    for name, rs in planted.items():
        if rs:
            summary[f"fault-{name}"] = {k: min(r[k] for r in rs)
                                        for k in compare.NAMES}
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="benchmark/cache/calibrate")
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    config = cells.config(bench, cell["config"])
    traffic = cells.traffic(cell["traffic"])
    if args.device == "cuda":
        run.card(cell["chips"])
        print(f"[calibrate] card: {run.power_limit()}", file=sys.stderr)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"{cell['name']}.jsonl", "a") as f:
        def emit(row):
            line = json.dumps({"workload": cell["name"], **row})
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
        summary = calibrate(config, traffic, args.seeds, args.faults,
                            args.device, emit)
        emit({"summary": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
