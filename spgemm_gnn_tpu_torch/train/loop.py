"""Full-graph training loop (counterpart of `spgemm_gnn_tpu/train/loop.py`).

The protocol is the JAX package's: a train step per epoch, evaluation every
`eval_every` epochs, best-val-selects-test, the same epoch log line, and the
steady-state epoch time measured after the first full iteration. PyTorch runs
eagerly, so a step is a plain method; eval metrics stay on the device and
reach the host in batches of `eval_fetch_every`.

Randomness comes from two explicit generators: one seeded with `seed` for the
initial weights (on the CPU, so the weights do not depend on the device) and
one seeded with `seed + 1` on the device for dropout.

Checkpoints (train/checkpoint.py): with `checkpoint_every`, the state is saved
every that many epochs and at the end, and a copy taken at the best-val
epoch is saved as `best`; eval metrics then reach the host at every
evaluation, so that the copy is taken at its epoch. With `resume`, `run`
restores the run directory's latest checkpoint and trains on from its step.
The RNG rule on resume: the checkpoint carries the dropout generator's
state, so a resumed run draws the masks the uninterrupted run draws; a
checkpoint without one (`convert.checkpoint_from_flax`) restarts the stream
at `seed + 1`, as the JAX Trainer does on every resume.

Serving: `predict` answers a batch of node ids by minibatch inference
(train/infer.py) through the feature store of `cache_strategy`
(graphs/features.py; every row on the device when "none"), and
`evaluate_checkpoint` scores a saved state.

With `dtype="bfloat16"` the features are cast to bf16 on the host, before
they move to the device (as the JAX Trainer does), the model computes its
hidden stack in bf16, and the loss and metrics read its f32 logits.

Metrics: ogbn-proteins reports ROC-AUC (`train/metrics.py::rocauc_tensor`,
on the device), every other dataset accuracy or micro-F1, as the JAX
Trainer does; the log line keeps its "Accuracy" wording either way.

Plans of a real (npz) dataset are cached under `<data_path>/plans`
(graphs/plan_cache.py), as the JAX Trainer caches its own; a synthetic
run builds them anew. With `device_inputs` on a synthetic run (the JAX
Trainer's condition: `synthetic` and one device), the stand-in is built
without its features and labels, which are drawn on the device instead
(`graphs/datasets.py::device_synthetic_inputs`); elsewhere the flag is
ignored with a warning.

With `remat` each hidden layer runs under `models/remat.py::remat`: the
same losses and weights bit for bit, less memory, a rerun of the layers'
dense work in each backward. It captures no CUDA graph: `steps_per_call`
> 1 with `remat` on the card raises NotImplementedError.

Over a mesh (`mesh_shape` D > 1, the JAX Trainer's mesh path): D graph
shards in this one process, all on the one device (parallel/mesh.py).
impl "torch" partitions the graph for `sharded_spmm`; "auto" and "cuda"
build each shard's plan pairs and the halo exchange
(`shard_planned_graph`; the JAX Trainer takes that path for impl "pallas"
only, its XLA path otherwise). Features, labels and masks are padded to
the mesh's rows, and evaluation and the best-val protocol run on the
padded arrays; the model state is one copy (the JAX Trainer replicates
it), and the node-wise layers run once on the whole padded tensor.
`predict` serves from the unsharded graph, as the JAX Trainer does,
moved to the device at its first call (the shards do not hold it).

Across ranks (parallel/multihost.py started a process group of more than
one rank; `mesh_shape` must equal its size): one graph shard a rank, the
JAX Trainer's layout with one device a process (parallel/mesh.py::
RankMesh). Each rank keeps its nps rows of the features (cast on the host,
only those rows transferred), labels and masks, and its shard's plans. The
model is replicated: every rank draws it from the same seed, and shard 0's
parameters and buffers are broadcast once in `init_state`. The train
loss on a rank is its rows' masked sum over the global train count
(all-reduced once at set-up), so after `loss.backward()` one all-reduce
(SUM) of the flattened gradients, in parameter order, with the loss
appended, gives every rank the global gradients and loss (no DDP
wrapper). Dropout and BatchNorm see the global rows (models/layers.py).
Evaluation sums micro-F1's counts over the ranks, or all-gathers the
logits for ROC-AUC (then the one-process computation on the padded rows),
so best-val selection is identical on every rank. Shard 0 writes the
checkpoints, behind a barrier; every rank restores; shard 0 logs the epoch
lines. `steps_per_call` > 1 raises NotImplementedError: a CUDA graph
cannot capture the exchange's host staging. `predict` reads the host's
features of the whole graph (a rank's features are its rows only).

Batched steps (`steps_per_call` n > 1, the JAX package's epoch batching):
consecutive train epochs run in groups of up to n that never straddle an
eval epoch or a checkpoint boundary (`group_size`), with no host sync
inside a group. On the card, where some group holds more than one step,
every step after the run's first (eager, so that it builds the kernels and
plans) replays a CUDA graph of one step's forward, loss and backward
(`GraphedStep`), captured right after that first step; the optimizer
steps eagerly after each replay, so Adam's bias correction stays on the
host as in an eager step, and Lookahead's host counter keeps counting. The
graph owns the dropout generator's state (`register_generator_state`), so
a replay draws the eager step's noise: the history is bit-equal to n = 1.
On the CPU a group runs its steps eagerly.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from spgemm_gnn_tpu_torch.graphs.datasets import (Dataset,
                                                  device_synthetic_inputs,
                                                  load_dataset)
from spgemm_gnn_tpu_torch.graphs.features import (DeviceFeatureStore,
                                                  FeatureStore,
                                                  make_feature_store)
from spgemm_gnn_tpu_torch.kernels import _build, planned
from spgemm_gnn_tpu_torch.models.layers import compute_dtype
from spgemm_gnn_tpu_torch.models.models import build_model
from spgemm_gnn_tpu_torch.parallel.mesh import RankMesh, make_mesh, world
from spgemm_gnn_tpu_torch.parallel.planned_sharded import shard_planned_graph
from spgemm_gnn_tpu_torch.parallel.sharded import shard_graph
from spgemm_gnn_tpu_torch.train import checkpoint as ckpt
from spgemm_gnn_tpu_torch.train.config import TrainConfig, check_supported
from spgemm_gnn_tpu_torch.train.infer import predict_nodes
from spgemm_gnn_tpu_torch.train.losses import loss_fn
from spgemm_gnn_tpu_torch.train.metrics import (f1_counts, f1_of_counts,
                                                micro_f1, rocauc_tensor)
from spgemm_gnn_tpu_torch.train.optim import build_optimizer
from spgemm_gnn_tpu_torch.utils.device import resolve_device
from spgemm_gnn_tpu_torch.utils.logging import get_logger, param_size


@dataclasses.dataclass
class EpochRecord:
    epoch: int
    loss: float
    train_acc: float
    val_acc: float
    test_acc: float


class GraphedStep:
    """One train step's forward, loss and backward captured as a CUDA graph
    over the state's parameters, with the gradients in static buffers;
    `step` replays it and then steps the optimizer eagerly.

    Capture needs a step already run eagerly on the state (the kernels and
    the plans' schedules are built at first use, with host copies that a
    capture refuses). A path whose step cannot be captured raises
    NotImplementedError naming the reason. `launches` are the kernel
    launches recorded at capture, one step's; a replay runs no Python, so
    the wrappers' counts (kernels/_build.py) do not grow with it:
    `replays` counts them.
    """

    def __init__(self, trainer: "Trainer", state: dict[str, Any],
                 generator: torch.Generator):
        model, opt = state["model"], state["optimizer"]
        self.state = state
        self.graph = torch.cuda.CUDAGraph()
        if not hasattr(self.graph, "register_generator_state"):
            raise NotImplementedError(
                "--steps_per_call > 1 needs CUDAGraph.register_generator_"
                "state (the dropout generator's state in the graph), which "
                f"this PyTorch {torch.__version__} lacks")
        self.graph.register_generator_state(generator)
        model.train()
        # backward writes fresh gradients (not accumulates) into buffers
        # the graph owns, which stay the parameters' .grad
        opt.zero_grad(set_to_none=True)
        before = collections.Counter(_build.launches)
        try:
            with torch.cuda.graph(self.graph):
                logits = model(trainer.g, trainer.features, generator)
                loss = trainer._loss(logits, trainer.labels,
                                     trainer.masks[0])
                loss.backward()
        except RuntimeError as exc:
            raise NotImplementedError(
                f"--steps_per_call > 1: this configuration's train step "
                f"cannot be captured as a CUDA graph ({exc})") from exc
        self.launches = collections.Counter(_build.launches) - before
        # drop the captured autograd graph: only its buffers are kept
        self.loss = loss.detach()
        del logits, loss
        self.replays = 0

    def step(self) -> torch.Tensor:
        """Replay the graph, then step the optimizer; returns the loss
        before the update (the graph's static buffer)."""
        self.graph.replay()
        self.replays += 1
        self.state["optimizer"].step()
        self.state["step"] += 1
        return self.loss


class Trainer:
    """Owns the graph and data on the device, and the train/eval steps for
    one (config, dataset) pair."""

    def __init__(self, config: TrainConfig, dataset: Dataset | None = None,
                 logger=None):
        check_supported(config)
        if config.steps_per_call > 1 and world()[1] > 1:
            raise NotImplementedError(
                "--steps_per_call > 1 with more than one process: a CUDA "
                "graph cannot capture the exchange's host staging; run "
                "--steps_per_call 1")
        self.config = config
        self.logger = logger or get_logger(None)
        self.device = resolve_device(config.device)
        # device_inputs takes effect on a synthetic run on one device only;
        # elsewhere it is ignored aloud, and the host features transfer
        self._device_inputs = bool(config.device_inputs and config.synthetic
                                   and config.mesh_shape <= 1)
        if config.device_inputs and not self._device_inputs:
            self.logger.warning(
                "--device_inputs ignored: it requires --synthetic and a "
                "single-device run (mesh_shape <= 1); host features will "
                "transfer as usual")
        if dataset is None:
            dataset = load_dataset(
                config.dataset, config.data_path, self_loop=config.selfloop,
                allow_synthetic=config.synthetic,
                synthetic_scale=config.synthetic_scale, seed=config.seed,
                synthetic_payload=not self._device_inputs)
        self.dataset = dataset
        # set unconditionally, as the reference does: the stream is
        # process-global, and an earlier Trainer may have changed it
        planned.DEFAULT_STREAM = config.stream
        dtype = compute_dtype(config.dtype)
        cache = (None if config.synthetic
                 else os.path.join(config.data_path, "plans"))
        self.feature_store: FeatureStore | None = None
        self.mesh = None
        # under a mesh, the unsharded device graph that `predict` serves
        # from, moved at its first call
        self._serve_graph = None
        if config.mesh_shape > 1 or world()[1] > 1:
            self._init_mesh(dataset, dtype, cache)
        else:
            self._init_single(dataset, dataset.graph.to(self.device), dtype,
                              cache)
        self._loss = loss_fn(dataset.multilabel)
        self._metric = (rocauc_tensor if dataset.name == "ogbn-proteins"
                        else micro_f1)
        if self.on_ranks:
            self._init_ranks()

    @property
    def on_ranks(self) -> bool:
        """True where each rank holds one graph shard (RankMesh)."""
        return isinstance(self.mesh, RankMesh)

    @property
    def logs_epochs(self) -> bool:
        """Whether this process logs the epoch lines: shard 0 across
        ranks, else always."""
        return not self.on_ranks or self.mesh.shard == 0

    def _init_ranks(self) -> None:
        """Across ranks: the global train count the loss divides by, and
        for ROC-AUC every rank's labels and masks (the logits are gathered
        at each evaluation)."""
        mesh = self.mesh
        count = mesh.all_reduce(self.masks[0].sum().float(), kind="setup")
        self._loss = functools.partial(self._loss, count=count)
        if self._metric is rocauc_tensor:
            self._all_labels = mesh.all_gather(self.labels, kind="setup")
            self._all_masks = tuple(
                mesh.all_gather(m.to(torch.uint8), kind="setup").bool()
                for m in self.masks)

    def _init_single(self, dataset: Dataset, g, dtype: torch.dtype,
                     cache: str | None) -> None:
        """The graph, features, labels and masks on the one device."""
        cfg, dev = self.config, self.device
        # the kernels' impls plan the graph, so that each graph takes the
        # reference's kernel (csr_spmm, or stream_spmm at low degree), for
        # the gathered rows' size; the plain ops read the raw graph
        self.g = (g if cfg.impl == "torch"
                  else planned.plan_graph(g, dim=cfg.hidden_dim,
                                          dtype=dtype, cache_dir=cache))
        if self._device_inputs:
            self.logger.info("device_inputs: features and labels drawn on "
                             "the device (no host feature transfer)")
            feat, self.labels = device_synthetic_inputs(
                dataset.name, cfg.synthetic_scale, cfg.seed, dev)
            self.features = feat.to(dtype)
        else:
            self.features = self._load_features(dataset, dtype)
            self.labels = torch.from_numpy(
                np.asarray(dataset.labels)).to(dev)
        self.masks = tuple(torch.from_numpy(np.asarray(m, bool)).to(dev)
                           for m in (dataset.train_mask, dataset.val_mask,
                                     dataset.test_mask))

    def _init_mesh(self, dataset: Dataset, dtype: torch.dtype,
                   cache: str | None) -> None:
        """The graph over a mesh of mesh_shape shards on the one device
        (the JAX Trainer's mesh path), or one shard a rank across
        processes: impl "torch" partitions it for the plain
        `sharded_spmm`; "auto" and "cuda" build each shard's plan pairs
        and the halo exchange (`shard_planned_graph`, cached under
        `<data_path>/plans` for npz datasets). Features (cast on the host
        first), labels and masks are padded to the mesh's padded_nodes
        rows, of which a rank keeps its own; the padding rows have no
        edges and no mask."""
        cfg = self.config
        self.mesh = make_mesh(cfg.mesh_shape, self.device)
        self.device = self.mesh.device
        if cfg.impl == "torch":
            self.g = shard_graph(dataset.graph, self.mesh)
        else:
            self.g = shard_planned_graph(dataset.graph, self.mesh,
                                         cache_dir=cache,
                                         dim=cfg.hidden_dim, dtype=dtype)
        n_pad = self.g.padded_nodes
        self.logger.info("%s: %d nodes in shards of %d rows (%d with "
                         "padding), impl %s", self.mesh, dataset.num_nodes,
                         self.g.nodes_per_shard, n_pad, cfg.impl)
        if cfg.cache_strategy != "none":
            self.logger.warning("--cache-strategy ignored under a mesh: "
                                "the padded features go to the device "
                                "whole")

        lo, hi = 0, n_pad
        if self.on_ranks:
            lo = self.mesh.shard * self.g.nodes_per_shard
            hi = lo + self.g.nodes_per_shard

        def pad(a: np.ndarray, dtype=None) -> torch.Tensor:
            """Rows [lo, hi) of a, padded with zeros past its end."""
            t = torch.from_numpy(np.asarray(a)[lo:hi])
            t = t if dtype is None else t.to(dtype)
            out = t.new_zeros((hi - lo,) + tuple(t.shape[1:]))
            out[:t.shape[0]] = t
            return out.to(self.device)

        # cast on the host: the transfer moves the narrow dtype
        self.features = pad(np.asarray(dataset.features, np.float32), dtype)
        self.labels = pad(dataset.labels)
        self.masks = tuple(pad(np.asarray(m, bool)) for m in (
            dataset.train_mask, dataset.val_mask, dataset.test_mask))

    def _load_features(self, dataset: Dataset, dtype: torch.dtype
                       ) -> torch.Tensor:
        """The features on the device, through the store of
        `cache_strategy` when it is not "none" (kept as `feature_store`;
        full-graph training reads every row, so it serves `full()`)."""
        cfg = self.config
        if cfg.cache_strategy == "none":
            # cast on the host: the transfer moves the narrow dtype
            return torch.from_numpy(np.asarray(
                dataset.features, np.float32)).to(dtype).to(self.device)
        self.feature_store = make_feature_store(
            dataset.features, policy=cfg.cache_strategy,
            cache_ratio=cfg.cache_size_ratio,
            out_degrees=dataset.graph.out_degrees.cpu().numpy(),
            dtype=dtype, device=self.device)
        self.logger.info("Feature store: %s (capacity ratio %.2f)",
                         cfg.cache_strategy, cfg.cache_size_ratio)
        return self.feature_store.full()

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int | None = None,
                   weights: dict[str, torch.Tensor] | None = None
                   ) -> dict[str, Any]:
        """A fresh model and optimizer: weights drawn from `seed` (default
        config.seed), or loaded from the state_dict `weights`."""
        cfg = self.config
        seed = cfg.seed if seed is None else seed
        model = build_model(
            cfg.model, in_dim=self.features.shape[1],
            hidden_dim=cfg.hidden_dim, num_layers=cfg.hidden_layers,
            out_dim=self.dataset.num_classes, maxk=cfg.maxk,
            feat_drop=cfg.dropout, use_norm=cfg.norm,
            nonlinear=cfg.nonlinear, impl=cfg.impl, remat=cfg.remat,
            dtype=cfg.dtype)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        if weights is not None:
            model.load_state_dict(weights)
        model.to(self.device)
        if self.on_ranks:
            self._broadcast(model)
        opt = build_optimizer(model.parameters(), cfg.w_lr,
                              cfg.w_weight_decay, cfg.enable_lookahead)
        return {"model": model, "optimizer": opt, "step": 0}

    @torch.no_grad()
    def _broadcast(self, model: torch.nn.Module) -> None:
        """Shard 0's parameters and buffers into every rank's model, in
        one flattened broadcast."""
        tensors = list(model.parameters()) + list(model.buffers())
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        self.mesh.broadcast_(flat)
        at = 0
        for t in tensors:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()

    def _all_reduce_grads(self, model: torch.nn.Module,
                          loss: torch.Tensor) -> torch.Tensor:
        """Across ranks: the gradients summed in place, in one all-reduce
        of them flattened in parameter order with the loss appended;
        returns the summed (global) loss."""
        params = [p for p in model.parameters() if p.grad is not None]
        flat = self.mesh.all_reduce(torch.cat(
            [p.grad.reshape(-1) for p in params]
            + [loss.detach().float().reshape(1)]), kind="grad_all_reduce")
        at = 0
        for p in params:
            p.grad.copy_(flat[at:at + p.numel()].view_as(p.grad))
            at += p.numel()
        return flat[-1]

    # -- steps -----------------------------------------------------------------

    def train_step(self, state: dict[str, Any],
                   generator: torch.Generator | None) -> torch.Tensor:
        """One full-graph step; returns the loss before the update (a 0-d
        device tensor). Across ranks the gradients and the loss are summed
        over the ranks before the update."""
        model, opt = state["model"], state["optimizer"]
        model.train()
        opt.zero_grad(set_to_none=True)
        logits = model(self.g, self.features, generator)
        loss = self._loss(logits, self.labels, self.masks[0])
        loss.backward()
        loss = loss.detach()
        if self.on_ranks:
            loss = self._all_reduce_grads(model, loss)
        opt.step()
        state["step"] += 1
        return loss

    @torch.no_grad()
    def eval_step(self, state: dict[str, Any]
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(train, val, test) accuracy or micro-F1 (ROC-AUC for
        ogbn-proteins), as 0-d device tensors; across ranks, of every
        rank's rows."""
        model = state["model"]
        model.eval()
        logits = model(self.g, self.features)
        if not self.on_ranks:
            return tuple(self._metric(logits, self.labels, m)
                         for m in self.masks)
        if self._metric is rocauc_tensor:
            logits = self.mesh.all_gather(logits, kind="metric")
            return tuple(rocauc_tensor(logits, self._all_labels, m)
                         for m in self._all_masks)
        counts = self.mesh.all_reduce(torch.stack(
            [f1_counts(logits, self.labels, m) for m in self.masks]),
            kind="metric")
        return tuple(f1_of_counts(c) for c in counts)

    # -- serving ---------------------------------------------------------------

    @property
    def graph(self):
        """The plain device Graph: a PlannedGraph's own on one device; under
        a mesh the dataset's, moved to the device at first use (only
        `predict` reads it, and the shards do not hold it)."""
        if self.mesh is not None:
            if self._serve_graph is None:
                self._serve_graph = self.dataset.graph.to(self.device)
            return self._serve_graph
        return (self.g.graph if isinstance(self.g, planned.PlannedGraph)
                else self.g)

    def predict(self, state: dict[str, Any], node_ids) -> torch.Tensor:
        """Logits of `node_ids` (sorted unique order) by minibatch inference
        (train/infer.py): the hidden_layers-hop closure, its rows through
        `feature_store` (a DeviceFeatureStore of the features when there is
        none), the model on the induced subgraph."""
        store = self.feature_store
        if store is None and self.on_ranks:
            # a rank's features are its rows: serve the host's whole
            store = DeviceFeatureStore(
                torch.from_numpy(np.asarray(self.dataset.features,
                                            np.float32)),
                self.features.dtype, self.device)
        elif store is None:
            store = DeviceFeatureStore(self.features, self.features.dtype,
                                       self.device)
        return predict_nodes(state["model"], None, self.graph, store,
                             node_ids, hops=self.config.hidden_layers)

    def evaluate_checkpoint(self, path: str) -> tuple[float, float, float]:
        """(train, val, test) accuracy of the state saved at `path` (a
        checkpoint directory, or a run directory: its latest step)."""
        state = ckpt.restore_checkpoint(path, self.init_state())
        tr, va, te = self.eval_step(state)
        return float(tr), float(va), float(te)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- epoch loop ------------------------------------------------------------

    def run(self, epochs: int | None = None,
            on_epoch: Callable[[EpochRecord], None] | None = None,
            state: dict[str, Any] | None = None) -> dict[str, Any]:
        """Train for `epochs` (default config.epochs) from `state` (default
        `init_state()`), or with `resume` from the latest checkpoint under
        config.path, to epoch `epochs`."""
        cfg = self.config
        epochs = cfg.epochs if epochs is None else epochs
        state = self.init_state() if state is None else state
        dropout_gen = torch.Generator(device=self.device)
        dropout_gen.manual_seed(cfg.seed + 1)
        state["dropout_rng"] = dropout_gen
        start_epoch = 0
        if cfg.resume and ckpt.latest_step(cfg.path) is not None:
            state = ckpt.restore_checkpoint(cfg.path, state)
            start_epoch = state["step"]
            self.logger.info("Resumed from step %d", start_epoch)
        self.logger.info("Input features shape: %s",
                         tuple(self.features.shape))
        self.logger.info("Hidden: %d x %d layers -> %d classes",
                         cfg.hidden_dim, cfg.hidden_layers,
                         self.dataset.num_classes)
        self.logger.info("Model parameters: %.2f MB",
                         param_size(state["model"]))
        best_val, best_test, best_epoch = 0.0, 0.0, -1
        best_state = None   # a snapshot at the best-val epoch
        history: list[EpochRecord] = []
        pending: list[tuple[int, torch.Tensor]] = []
        # checkpointing snapshots the best state at its epoch, so every
        # evaluation reaches the host before the parameters move on
        fetch_every = (1 if cfg.checkpoint_every
                       else max(cfg.eval_fetch_every, 1))

        def flush():
            nonlocal best_val, best_test, best_epoch, best_state
            if not pending:
                return
            rows = torch.stack([p[1] for p in pending]).cpu().tolist()
            for (epoch, _), (loss, tr, va, te) in zip(pending, rows):
                if va > best_val:
                    best_val, best_test, best_epoch = va, te, epoch
                    if cfg.checkpoint_every:
                        best_state = ckpt.snapshot(state)
                rec = EpochRecord(epoch, loss, tr, va, te)
                history.append(rec)
                if on_epoch is not None:
                    on_epoch(rec)
                if (cfg.log_every and epoch % cfg.log_every == 0
                        and self.logs_epochs):
                    self.logger.info(
                        "Epoch %04d/%04d| Loss %.4f | Train Accuracy %.4f | "
                        "Val Accuracy %.4f | Test Accuracy %.4f | "
                        "Best val. Accuracy %.4f | Best test Accuracy %.4f",
                        epoch, epochs, loss, tr, va, te, best_val, best_test)
            pending.clear()

        spc = max(cfg.steps_per_call, 1)

        def group_size(e: int) -> int:
            """Train epochs from e that run as one group: at most
            steps_per_call, ending at the next eval epoch or checkpoint
            boundary (the JAX Trainer's rule)."""
            n = min(spc, epochs - e)
            if cfg.eval_every:
                r = e % cfg.eval_every
                to_eval = 1 if r == 0 else cfg.eval_every - r + 1
                n = min(n, to_eval, max(epochs - 1 - e, 0) + 1)
            if cfg.checkpoint_every:
                n = min(n, cfg.checkpoint_every - (e % cfg.checkpoint_every))
            return max(n, 1)

        groups = []
        epoch = start_epoch
        while epoch < epochs:
            groups.append(group_size(epoch))
            epoch += groups[-1]
        # the graph is captured after the run's first step, which runs
        # eagerly, and then takes every step
        use_graph = self.device.type == "cuda" and any(n > 1 for n in groups)
        if use_graph and cfg.remat:
            raise NotImplementedError(
                "--steps_per_call > 1 with --remat: a rematerialised step "
                "sets its dropout generator's state in the backward, which "
                "a CUDA graph capture does not allow; run one of the two")
        graphed: GraphedStep | None = None
        t_start = time.perf_counter()
        t_steady = None   # clock after the first full iteration
        steady_from = None
        epoch = start_epoch
        for n in groups:
            for _ in range(n):
                if graphed is not None:
                    loss = graphed.step()
                    continue
                loss = self.train_step(state, dropout_gen)
                if use_graph:
                    graphed = GraphedStep(self, state, dropout_gen)
            epoch += n
            last = epoch - 1   # the epoch whose state we now hold
            if cfg.eval_every and (last % cfg.eval_every == 0
                                   or last == epochs - 1):
                metrics = self.eval_step(state)
                pending.append((last, torch.stack(
                    [loss.float(), *(m.float() for m in metrics)])))
                if len(pending) >= fetch_every:
                    flush()
            if cfg.checkpoint_every and (last + 1) % cfg.checkpoint_every == 0:
                flush()   # best_epoch must be current for is_best
                ckpt.save_checkpoint(cfg.path, state, last + 1,
                                     is_best=best_epoch == last,
                                     mesh=self.mesh)
            if t_steady is None:
                self._sync()
                t_steady = time.perf_counter()
                steady_from = epoch
        flush()
        self._sync()
        now = time.perf_counter()
        wall = now - t_start
        steady = ((now - t_steady) / (epochs - steady_from)
                  if t_steady is not None and epochs > steady_from else None)
        if steady is not None:
            self.logger.info("Steady-state epoch time: %.3f s", steady)
        if cfg.checkpoint_every:
            ckpt.save_checkpoint(cfg.path, state, epochs, mesh=self.mesh)
            if best_state is not None:
                ckpt.save_checkpoint(cfg.path, best_state, best_epoch + 1,
                                     is_best=True, mesh=self.mesh)
        return {
            "best_val_accuracy": best_val,
            "best_test_accuracy": best_test,
            "best_epoch": best_epoch,
            "history": history,
            "wall_time_s": wall,
            "steady_epoch_s": steady,
            "final_state": state,
            # the CUDA graph of steps_per_call > 1: its kernel launches (one
            # step's) and how often it was replayed
            "graph_launches": dict(graphed.launches) if graphed else {},
            "graph_replays": graphed.replays if graphed else 0,
            # across ranks: the collectives' calls, bytes and host ms
            # (parallel/mesh.py::RankMesh.stats)
            "collectives": dict(self.mesh.stats) if self.on_ranks else {},
        }


def train_and_evaluate(config: TrainConfig, dataset: Dataset | None = None,
                       logger=None) -> dict[str, Any]:
    """One-call training run: a Trainer of `config` (and `dataset`), run."""
    return Trainer(config, dataset, logger).run()

