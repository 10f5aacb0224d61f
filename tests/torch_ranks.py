"""The rank programs of tests/test_torch_multiprocess.py, one spawned
process a rank over gloo on the CPU (`file://` rendezvous in the test's
own directory, so that parallel test workers never collide), one torch
thread each. They import the port only, never JAX: the test compares
their results with the in-process mesh and with the JAX package.

`spawn(program, world, workdir)` runs `PROGRAMS[program]` on every rank
and returns each rank's result (a dict of tensors, numbers and strings).
"""
from __future__ import annotations

import logging
import multiprocessing
import os
import traceback

import numpy as np
import torch

# the aggregation checks' graph and geometry (test_torch_planned_sharded)
AGG_GRAPH = dict(num_nodes=300, num_edges=3000, seed=31)
AGG_KW = dict(src_block=128, dst_block=128, window=8)
AGG_DIM, AGG_K = 128, 4
# the Trainer checks' configuration (test_torch_trainer_parallel's COMMON
# on a stand-in of more than one shard of 2048 rows: both ranks hold real
# rows, and the halo rounds run)
COMMON = dict(dataset="flickr", model="sage", epochs=2, hidden_dim=16,
              hidden_layers=2, maxk=4, dropout=0.0, w_lr=0.01,
              nonlinear="maxk", synthetic=True, synthetic_scale=0.03,
              eval_every=1, log_every=0, device="cpu")
TRAINERS = {
    "sage": dict(dropout=0.5, epochs=3),
    "gnn_res": dict(model="gnn_res", norm=True, dropout=0.5, epochs=3,
                    dataset="yelp", synthetic_scale=0.004),
    "proteins": dict(dataset="ogbn-proteins", synthetic_scale=0.016,
                     dropout=0.5, epochs=2, remat=True),
}
GRID_GRAPH = dict(num_nodes=200, num_edges=1600, seed=61)
# the nodes each rank's `Trainer.predict` answers (rows on both shards)
PREDICT_IDS = np.arange(0, 2677, 53)
QUIET = logging.getLogger("torch_ranks")
QUIET.addHandler(logging.NullHandler())
QUIET.propagate = False


def agg_inputs(n_pad: int) -> dict[str, np.ndarray]:
    """The aggregation checks' inputs on the padded rows: random x and
    cotangent, and an integer-valued k-sparse x (AGG_K values in 1..8 a
    row, so that every sum is exact) with an integer cotangent."""
    n, rng = AGG_GRAPH["num_nodes"], np.random.default_rng(0)
    x = np.zeros((n_pad, AGG_DIM), np.float32)
    x[:n] = rng.standard_normal((n, AGG_DIM))
    ct = rng.standard_normal((n_pad, AGG_DIM)).astype(np.float32)
    xi = np.zeros((n_pad, AGG_DIM), np.float32)
    cols = np.argsort(rng.random((n, AGG_DIM)), axis=1)[:, :AGG_K]
    np.put_along_axis(xi[:n], cols, rng.integers(1, 9, (n, AGG_K)), axis=1)
    cti = rng.integers(-4, 5, (n_pad, AGG_DIM)).astype(np.float32)
    return dict(x=x, ct=ct, xi=xi, cti=cti)


# (name, input, cotangent, norm, k, halo dtype)
AGG_FORMS = (
    ("dense", "x", "ct", "mean", None, None),
    ("cbsr", "x", "ct", "mean", AGG_K, None),
    ("cbsr_bf16_halo", "x", "ct", "mean", AGG_K, torch.bfloat16),
    ("dense_int", "xi", "cti", "sum", None, None),
    ("cbsr_int", "xi", "cti", "sum", AGG_K, None),
    ("cbsr_bf16_halo_int", "xi", "cti", "sum", AGG_K, torch.bfloat16),
)


def aggregate_forms(spg, inputs: dict, rows: slice) -> dict:
    """(y, dx) of `sharded_planned_aggregate` on `rows` of each input, by
    form; with k the input goes through MaxK first."""
    from spgemm_gnn_tpu_torch.ops.maxk import maxk
    from spgemm_gnn_tpu_torch.parallel.planned_sharded import (
        sharded_planned_aggregate)
    out = {}
    for name, xn, cn, norm, k, halo in AGG_FORMS:
        x = torch.from_numpy(inputs[xn][rows].copy()).requires_grad_()
        y = sharded_planned_aggregate(spg, maxk(x, k) if k else x, norm, k,
                                      halo)
        (y * torch.from_numpy(inputs[cn][rows])).sum().backward()
        out[name] = (y.detach(), x.grad)
    return out


def spmm_inputs(n_pad: int, dim: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """x and cotangent on the padded rows of the agg graph, 0 past N."""
    n, rng = AGG_GRAPH["num_nodes"], np.random.default_rng(4)
    x = np.zeros((n_pad, dim), np.float32)
    x[:n] = rng.standard_normal((n, dim))
    ct = np.zeros((n_pad, dim), np.float32)
    ct[:n] = rng.standard_normal((n, dim))
    return x, ct


def trainer(over: dict, mesh_shape: int = 2, weights=None, **run_kw):
    """(Trainer, its run's result) of COMMON with `over`."""
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    tr = Trainer(TrainConfig(**{**COMMON, "mesh_shape": mesh_shape, **over}),
                 logger=QUIET)
    state = None if weights is None else tr.init_state(weights=weights)
    return tr, tr.run(state=state, **run_kw)


def history(res) -> list[tuple]:
    return [(r.loss, r.train_acc, r.val_acc, r.test_acc)
            for r in res["history"]]


def first_step_grads(over: dict, mesh_shape: int = 2) -> dict:
    """The parameters' gradients after one train step (dropout drawn from
    seed 98) of COMMON with `over`: across ranks, the summed ones."""
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    t = Trainer(TrainConfig(**{**COMMON, "mesh_shape": mesh_shape, **over}),
                logger=QUIET)
    state = t.init_state()
    t.train_step(state, torch.Generator().manual_seed(98))
    return {n: p.grad.clone() for n, p in state["model"].named_parameters()}


def _pair(rank: int, world: int, workdir: str) -> dict:
    """The 2-rank program: the aggregation forms, impl "torch"'s
    `sharded_spmm`, the Trainers, checkpoint and resume, the refusal of
    batched steps, and the runtime's summary."""
    from spgemm_gnn_tpu_torch.graphs.synthetic import powerlaw_graph
    from spgemm_gnn_tpu_torch.ops.maxk import maxk
    from spgemm_gnn_tpu_torch.parallel import multihost
    from spgemm_gnn_tpu_torch.parallel.mesh import make_mesh
    from spgemm_gnn_tpu_torch.parallel.planned_sharded import (
        shard_planned_graph)
    from spgemm_gnn_tpu_torch.parallel.sharded import (shard_graph,
                                                       sharded_spmm)
    out = {"summary": multihost.process_summary("cpu")}
    mesh = make_mesh(world, "cpu")
    out["mesh"] = (str(mesh), mesh.num_shards, mesh.shard, mesh.shape)
    g = powerlaw_graph(AGG_GRAPH["num_nodes"], AGG_GRAPH["num_edges"],
                       seed=AGG_GRAPH["seed"])
    spg = shard_planned_graph(g, mesh, **AGG_KW)
    nps = spg.nodes_per_shard
    rows = slice(rank * nps, (rank + 1) * nps)
    out["agg"] = aggregate_forms(spg, agg_inputs(spg.padded_nodes), rows)
    out["agg_stats"] = dict(mesh.stats)

    sg = shard_graph(g, mesh)
    x, ct = spmm_inputs(sg.padded_nodes)
    r = slice(rank * sg.nodes_per_shard, (rank + 1) * sg.nodes_per_shard)
    out["spmm"] = {}
    for k in (None, AGG_K):
        xv = torch.from_numpy(x[r].copy()).requires_grad_()
        y = sharded_spmm(sg, maxk(xv, k) if k else xv, "mean", k)
        (y * torch.from_numpy(ct[r])).sum().backward()
        out["spmm"][k] = (y.detach(), xv.grad)

    out["grads"] = first_step_grads(TRAINERS["sage"])
    for name, over in TRAINERS.items():
        tr, res = trainer(over)
        out[name] = history(res)
        if name == "sage":
            model = res["final_state"]["model"]
            out["sage_weights"] = {n: t.detach().clone()
                                   for n, t in model.state_dict().items()}
            out["sage_predict"] = tr.predict(res["final_state"],
                                             PREDICT_IDS)
        out[f"{name}_collectives"] = res["collectives"]
        if name == "proteins":
            out["proteins_init_eval"] = [float(m) for m in
                                         tr.eval_step(tr.init_state())]
    weights = torch.load(os.path.join(workdir, "jax_weights.pt"))
    out["sage_jax"] = history(trainer({}, weights=weights)[1])

    ck = dict(dropout=0.5, checkpoint_every=2,
              path=os.path.join(workdir, "ck"))
    trainer({**ck, "epochs": 4})
    tr, res = trainer({**ck, "epochs": 6, "resume": True})
    out["resumed"] = history(res)
    out["uninterrupted"] = history(trainer({"dropout": 0.5, "epochs": 6})[1])
    out["best_eval"] = tr.evaluate_checkpoint(
        os.path.join(workdir, "ck", "checkpoints", "best"))
    try:
        trainer({"steps_per_call": 2, "epochs": 3})
        out["steps_per_call"] = "ran"
    except NotImplementedError as exc:
        out["steps_per_call"] = str(exc)
    return out


def _grid(rank: int, world: int, workdir: str) -> dict:
    """The 4-rank program: a (dp 2, graph 2) hybrid mesh, `sharded_spmm`
    over each graph row, and a sum over each dp column."""
    from spgemm_gnn_tpu_torch.graphs.synthetic import powerlaw_graph
    from spgemm_gnn_tpu_torch.parallel.multihost import make_hybrid_mesh
    from spgemm_gnn_tpu_torch.parallel.sharded import (shard_graph,
                                                       sharded_spmm)
    mesh = make_hybrid_mesh(dcn=2, ici=2, device="cpu")
    out = {"shape": mesh.shape, "shard": mesh.shard, "ranks": mesh.ranks,
           "dp_ranks": mesh.dp_ranks,
           "inferred": make_hybrid_mesh(ici=4, device="cpu").shape}
    try:
        make_hybrid_mesh(dcn=3, ici=3, device="cpu")
    except ValueError as exc:
        out["bad_shape"] = str(exc)
    g = powerlaw_graph(GRID_GRAPH["num_nodes"], GRID_GRAPH["num_edges"],
                       seed=GRID_GRAPH["seed"])
    sg = shard_graph(g, mesh)
    nps = sg.nodes_per_shard
    x = np.zeros((sg.padded_nodes, 32), np.float32)
    x[:g.num_nodes] = np.random.default_rng(0).standard_normal(
        (g.num_nodes, 32))
    out["y"] = sharded_spmm(sg, torch.from_numpy(
        x[mesh.shard * nps:(mesh.shard + 1) * nps]), "mean")
    out["dp_sum"] = mesh.all_reduce(torch.tensor([float(rank)]),
                                    axis="dp").item()
    return out


PROGRAMS = {"pair": _pair, "grid": _grid}


def _main(program: str, rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist
    from spgemm_gnn_tpu_torch.parallel.multihost import initialize_multihost
    torch.set_num_threads(1)
    try:
        initialize_multihost(f"file://{workdir}/{program}.rdzv", world,
                             rank, "cpu")
        out = PROGRAMS[program](rank, world, workdir)
        torch.save(out, os.path.join(workdir, f"{program}.rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"{program}.rank{rank}.err"),
                  "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(program: str, world: int, workdir: str,
          timeout: float = 240.0) -> list[dict]:
    """Run `program` on `world` spawned ranks; each rank's result. A rank
    that fails or outlives `timeout` fails the call, with its traceback."""
    import time
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_main, args=(program, r, world, workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(workdir, f"{program}.rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}"
                          + (" (timed out)" if r in hung else ""))
    if errors:
        raise RuntimeError(f"{program} on {world} ranks failed:\n"
                           + "\n".join(errors))
    return [torch.load(os.path.join(workdir, f"{program}.rank{r}.pt"),
                       weights_only=False) for r in range(world)]
