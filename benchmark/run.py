"""Run one cell of the benchmark once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. A cell is full-graph MaxK-GNN training with
`spgemm_gnn_tpu_torch`'s Trainer on one configuration (`configs/`) under
one traffic mix (`traffic/`: the precision and the training flags). The
configuration's model family has a file of its own (`models/<model>.py`):
its weights, its plain forward and its counts.

Set-up, from the process's start to the first timed epoch: the graph
(drawn once per checkout, then loaded from `benchmark/cache/`; with
self-loops added where the configuration asks), the features, labels,
split and initial weights drawn from `--seed` on the card, the Trainer
(the graph's plans on the card, the kernels loaded, or built with nvcc at
the first run in a checkout), and one call of `Trainer.run(epochs=E)` (E
= the mix's `epochs_per_call`, the recipe's `eval_fetch_every`). That
first call is the run's first steps: an optimizer hook reads the first
gradient from Adam's state after step 1 and the parameters after the last
compared step.

The window then calls `Trainer.run(epochs=E)` on the same state until
`--seconds` have passed; each call ends in the program's synchronise.
`epoch_s` is all the window's seconds over all its epochs. With `--trace
1` one more call runs under `torch.profiler`, and the per-layer metrics
are read from it (`metrics/<name>.py`).

After the window, the program's state is freed and the plain reference
(`reference.py` with the model file's forward) recomputes the first steps
from the same inputs; the numbers of `compare.py` against the cell's
limits decide `correct`. The last line of standard output is the result,
as one JSON object.

Exit codes: 0 with a result; 2 without the card(s) the cell asks for; 3
when JAX or the JAX package is loaded once everything that runs after the
window (the metric readers, the reference, the comparison) has run; 1 on
any other failure, at once where the configuration's model family has no
model file. None of them but 0 prints a result.
"""
import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    # Python's bytecode of every module the run imports, torch's included,
    # compiled at the first run in a checkout and read by the later ones,
    # whatever PYTHONDONTWRITEBYTECODE says: like the kernels, it is built
    # once per checkout, at a fixed path inside it.
    sys.pycache_prefix = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "cache", "pycache")
    sys.dont_write_bytecode = False

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import cells, compare, graphgen, inputs, reference  # noqa: E402
from benchmark import trace as tracing  # noqa: E402
from benchmark.context import Context  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "spgemm_gnn_tpu")
CACHE = BENCH / "cache"
QUIET = logging.getLogger("benchmark.program")
QUIET.setLevel(logging.WARNING)


class NoChip(RuntimeError):
    """The cell's cards are not there."""


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout. The
    port's own kernels build into `build/kernels` of the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def card(chips: int) -> dict:
    """Name and count of the cards, or NoChip."""
    import torch
    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoChip(f"{torch.cuda.device_count()} CUDA device(s), the "
                     f"cell asks for {chips}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip() or out.stderr.strip()


def train_config(config: dict, traffic: dict, seed: int, device: str):
    """The Trainer's configuration of a cell."""
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    m = config["model"]
    return TrainConfig(
        dataset=config["dataset"]["name"], model=m["model"],
        nonlinear=m["nonlinear"], maxk=m["maxk"], hidden_dim=m["hidden_dim"],
        hidden_layers=m["hidden_layers"], norm=m["norm"],
        dropout=m["dropout"], w_lr=m["w_lr"],
        w_weight_decay=m["w_weight_decay"],
        enable_lookahead=m["enable_lookahead"], eval_every=m["eval_every"],
        eval_fetch_every=m["eval_fetch_every"], seed=seed, device=device,
        impl="auto", dtype=traffic["dtype"], stream=traffic["stream"],
        steps_per_call=traffic["steps_per_call"], remat=traffic["remat"],
        synthetic=True, epochs=traffic["epochs_per_call"])


def build_graph(indptr, indices, device: str):
    """The port's Graph (`graphs/csr.py::Graph`) of the benchmark's CSR,
    built on `device`: the graph is symmetric, so its transpose is itself
    and a node's in- and out-degrees are equal."""
    import torch

    from spgemm_gnn_tpu_torch.graphs.csr import Graph
    ptr = torch.from_numpy(indptr.astype("int32")).to(device)
    idx = torch.from_numpy(indices).to(device)
    deg = ptr[1:] - ptr[:-1]
    dst = torch.repeat_interleave(
        torch.arange(deg.shape[0], dtype=torch.int32, device=device),
        deg.long(), output_size=idx.shape[0])
    return Graph(indptr=ptr, indices=idx, edge_dst=dst, t_indptr=ptr,
                 t_indices=idx, t_edge_dst=dst, in_degrees=deg,
                 out_degrees=deg, num_nodes=int(deg.shape[0]),
                 num_edges=int(idx.shape[0]), symmetric=True)


def prepare(config: dict, traffic: dict, seed: int, device: str, graph):
    """(trainer, state, host inputs): the inputs of `seed` drawn on the
    device and kept on the host, a Trainer of the cell over `graph` (a
    Dataset of those inputs) and its state from the drawn weights."""
    import torch

    from spgemm_gnn_tpu_torch.graphs.datasets import Dataset
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    t = time.perf_counter()
    drawn = inputs.draw(config, seed, device)
    host = drawn.to("cpu")
    del drawn
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"inputs drawn: {time.perf_counter() - t:.2f} s")
    ds = config["dataset"]
    dataset = Dataset(
        name=ds["name"], graph=graph, features=host.features.numpy(),
        labels=host.labels.numpy(), train_mask=host.masks[0].numpy(),
        val_mask=host.masks[1].numpy(), test_mask=host.masks[2].numpy(),
        num_classes=ds["num_classes"], multilabel=False)
    t = time.perf_counter()
    trainer = Trainer(train_config(config, traffic, seed, device), dataset,
                      logger=QUIET)
    state = trainer.init_state(weights=host.weights)
    log(f"Trainer and state: {time.perf_counter() - t:.2f} s")
    return trainer, state, host


def first_steps(trainer, state, steps: int, epochs: int):
    """One `Trainer.run(epochs)` call on `state` that also reads the run's
    first `steps` steps: each loss, the first gradient (Adam's first moment
    after step 1 over 1 - beta1) and the parameters' change after step
    `steps`, as reference.Steps; and the call's history."""
    import torch
    model, opt = state["model"], state["optimizer"]
    names = {p: n for n, p in model.named_parameters()}
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads, change, count = {}, {}, [0]

    def hook(optimizer, args, kwargs):
        count[0] += 1
        if count[0] == 1:
            beta1 = optimizer.param_groups[0]["betas"][0]
            for p, n in names.items():
                st = optimizer.state.get(p, {})
                grads[n] = (float(torch.linalg.vector_norm(st["exp_avg"]))
                            / (1.0 - beta1) if "exp_avg" in st else 0.0)
        if count[0] == steps:
            for p, n in names.items():
                change[n] = float(torch.linalg.vector_norm(
                    p.detach().float() - start[n]))

    handle = opt.register_step_post_hook(hook)
    try:
        out = trainer.run(epochs=epochs, state=state)
    finally:
        handle.remove()
    if count[0] < steps:       # a step that never reached the optimizer
        for n in names:
            grads.setdefault(n, 0.0)
            change.setdefault(n, 0.0)
    losses = [r.loss for r in out["history"][:steps]]
    return reference.Steps(losses, grads, change), out


def finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def run_cell(config: dict, traffic: dict, limits: dict, seed: int,
             seconds: float, trace: bool, *, device: str = "cuda",
             chips: int = 1, per_layer: list[dict] = (),
             t_start: float = T_START) -> dict:
    """One run of a cell of `config` under `traffic`; returns the result's
    JSON object. `per_layer`: the cell's `per_layer` entries. `device`
    "cpu" runs the plain paths without looking for a card (tests)."""
    set_cache_dirs()
    import torch
    dev_info = (card(chips) if device == "cuda"
                else {"platform": "cpu", "kind": "cpu", "count": 1})
    if device == "cuda":
        log(f"card: {power_limit()}")
    from spgemm_gnn_tpu_torch.kernels import _build

    log(f"imports and the card: {time.perf_counter() - t_start:.2f} s")
    model_file = cells.model_file(config)
    t = time.perf_counter()
    indptr, indices, drawn = graphgen.load_graph(config)
    log(f"graph {'drawn and stored' if drawn else 'loaded'}: N "
        f"{indptr.shape[0] - 1}, E {indices.shape[0]} "
        f"({time.perf_counter() - t:.2f} s)")
    t = time.perf_counter()
    graph = build_graph(indptr, indices, device)
    trainer, state, host = prepare(config, traffic, seed, device, graph)
    log(f"graph, inputs and Trainer ({getattr(trainer.g, 'kind', 'no')} "
        f"plan): {time.perf_counter() - t:.2f} s")

    per_call = traffic["epochs_per_call"]
    steps = traffic["compared_steps"]
    t = time.perf_counter()
    prog, out = first_steps(trainer, state, steps, per_call)
    log(f"first call ({per_call} epochs, the first {steps} compared): "
        f"{time.perf_counter() - t:.3f} s")
    for _ in range(traffic["warmup_calls"] - 1):
        t = time.perf_counter()
        trainer.run(epochs=per_call, state=state)
        log(f"warm-up call: {time.perf_counter() - t:.3f} s")

    cuda = device == "cuda"
    peak_total = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses = [r.loss for r in out["history"]]
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    epochs, calls = 0, []
    while True:
        t = time.perf_counter()
        out = trainer.run(epochs=per_call, state=state)
        calls.append(time.perf_counter() - t)
        losses += [r.loss for r in out["history"]]
        epochs += per_call
        if time.perf_counter() - t_window >= seconds:
            break
    window_s = time.perf_counter() - t_window
    epoch_s = window_s / epochs
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window: {epochs} epochs in {window_s:.4f} s, calls "
        + " ".join(f"{c:.4f}" for c in calls))

    traced, launches, traced_epochs = None, collections.Counter(), 0
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        before = collections.Counter(_build.launches)
        with profile(activities=acts) as prof:
            with record_function(tracing.WINDOW):
                out = trainer.run(epochs=per_call, state=state)
        launches = collections.Counter(_build.launches) - before
        losses += [r.loss for r in out["history"]]
        traced_epochs = per_call
        tmp = tempfile.mkdtemp(prefix="benchmark-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            traced = tracing.load(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    ctx = Context(config=config, traffic=traffic,
                  num_edges=int(indices.shape[0]), epoch_s=epoch_s,
                  peak_window_bytes=peak_window, trace=traced,
                  traced_epochs=traced_epochs, launches=launches,
                  own_kernels=tracing.own_kernels(
                      ROOT / "spgemm_gnn_tpu_torch" / "csrc"))
    if trace:
        metrics = {}
        for m in per_layer:
            value = cells.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {"epoch_s": {"value": epoch_s, "unit": "s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    device_out = dict(dev_info, memory_peak_bytes=int(max(peak_total,
                                                          peak_window)))
    if traced is not None:
        device_out.update(busy_s=tracing.busy_s(traced),
                          window_s=traced.window_s)

    # the program's state goes before the reference runs on the card
    del trainer, state, out, graph
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference.train_steps(
        torch.from_numpy(indptr.astype("int32")),
        torch.from_numpy(indices), host.to(device), config["model"],
        dropout_seed=seed + 1, model_file=model_file, steps=steps,
        dtype=traffic["dtype"])
    log(f"reference, {steps} steps: {time.perf_counter() - t:.2f} s")
    values = compare.readings(prog, ref)
    ok, checks = compare.judge(values, limits)
    failed = sum(1 for x in losses if not math.isfinite(x))
    result = {"correct": bool(ok and failed == 0), "attempted": len(losses),
              "failed": failed, "metrics": metrics, "device": device_out}
    if traced is not None:
        result["breakdown"] = {"device_ops": tracing.top_device_ops(traced),
                               "idle_gaps": tracing.top_idle_gaps(traced)}
    result["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    config = cells.config(bench, cell["config"])
    try:
        cells.model_file(config)
    except cells.NoModelFile as exc:
        log(f"no result: {exc}")
        return 1
    try:
        result = run_cell(
            config, cells.traffic(cell["traffic"]),
            cells.limits(cell["name"]), args.seed, args.seconds,
            bool(args.trace), chips=cell["chips"],
            per_layer=cells.metrics_of(bench, cell["name"], "per_layer"))
    except NoChip as exc:
        log(f"no result: {exc}")
        return 2
    found = forbidden_modules()
    if found:
        log("no result: loaded once the window had closed: "
            + ", ".join(found))
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
