"""Full-graph training loop (counterpart of `spgemm_gnn_tpu/train/loop.py`).

The protocol is the JAX package's: a train step per epoch, evaluation every
`eval_every` epochs, best-val-selects-test, the same epoch log line, and the
steady-state epoch time measured after the first full iteration. PyTorch runs
eagerly, so a step is a plain method; eval metrics stay on the device and
reach the host in batches of `eval_fetch_every`.

Randomness comes from two explicit generators: one seeded with `seed` for the
initial weights (on the CPU, so the weights do not depend on the device) and
one seeded with `seed + 1` on the device for dropout.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from spgemm_gnn_tpu_torch.graphs.datasets import Dataset, load_dataset
from spgemm_gnn_tpu_torch.kernels.planned import plan_graph
from spgemm_gnn_tpu_torch.models.models import build_model
from spgemm_gnn_tpu_torch.train.config import TrainConfig, check_supported
from spgemm_gnn_tpu_torch.train.losses import loss_fn
from spgemm_gnn_tpu_torch.train.metrics import micro_f1
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


class Trainer:
    """Owns the graph and data on the device, and the train/eval steps for
    one (config, dataset) pair."""

    def __init__(self, config: TrainConfig, dataset: Dataset | None = None,
                 logger=None):
        check_supported(config)
        self.config = config
        self.logger = logger or get_logger(None)
        self.device = resolve_device(config.device)
        if dataset is None:
            dataset = load_dataset(
                config.dataset, config.data_path, self_loop=config.selfloop,
                allow_synthetic=config.synthetic,
                synthetic_scale=config.synthetic_scale, seed=config.seed)
        self.dataset = dataset
        dev = self.device
        g = dataset.graph.to(dev)
        # the kernels' impls plan the graph, so that each graph takes the
        # reference's kernel (csr_spmm, or stream_spmm at low degree); the
        # plain ops read the raw graph
        self.g = (g if config.impl == "torch"
                  else plan_graph(g, dim=config.hidden_dim))
        self.features = torch.from_numpy(
            np.asarray(dataset.features, np.float32)).to(dev)
        self.labels = torch.from_numpy(np.asarray(dataset.labels)).to(dev)
        self.masks = tuple(torch.from_numpy(np.asarray(m, bool)).to(dev)
                           for m in (dataset.train_mask, dataset.val_mask,
                                     dataset.test_mask))
        self._loss = loss_fn(dataset.multilabel)

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
        opt = build_optimizer(model.parameters(), cfg.w_lr,
                              cfg.w_weight_decay, cfg.enable_lookahead)
        return {"model": model, "optimizer": opt, "step": 0}

    # -- steps -----------------------------------------------------------------

    def train_step(self, state: dict[str, Any],
                   generator: torch.Generator | None) -> torch.Tensor:
        """One full-graph step; returns the loss before the update (a 0-d
        device tensor)."""
        model, opt = state["model"], state["optimizer"]
        model.train()
        opt.zero_grad(set_to_none=True)
        logits = model(self.g, self.features, generator)
        loss = self._loss(logits, self.labels, self.masks[0])
        loss.backward()
        opt.step()
        state["step"] += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, state: dict[str, Any]
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(train, val, test) accuracy or micro-F1, as 0-d device tensors."""
        model = state["model"]
        model.eval()
        logits = model(self.g, self.features)
        return tuple(micro_f1(logits, self.labels, m) for m in self.masks)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- epoch loop ------------------------------------------------------------

    def run(self, epochs: int | None = None,
            on_epoch: Callable[[EpochRecord], None] | None = None,
            state: dict[str, Any] | None = None) -> dict[str, Any]:
        """Train for `epochs` (default config.epochs) from `state` (default
        `init_state()`)."""
        cfg = self.config
        epochs = cfg.epochs if epochs is None else epochs
        state = self.init_state() if state is None else state
        self.logger.info("Input features shape: %s",
                         tuple(self.features.shape))
        self.logger.info("Hidden: %d x %d layers -> %d classes",
                         cfg.hidden_dim, cfg.hidden_layers,
                         self.dataset.num_classes)
        self.logger.info("Model parameters: %.2f MB",
                         param_size(state["model"]))
        dropout_gen = torch.Generator(device=self.device)
        dropout_gen.manual_seed(cfg.seed + 1)
        best_val, best_test, best_epoch = 0.0, 0.0, -1
        history: list[EpochRecord] = []
        pending: list[tuple[int, torch.Tensor]] = []
        fetch_every = max(cfg.eval_fetch_every, 1)

        def flush():
            nonlocal best_val, best_test, best_epoch
            if not pending:
                return
            rows = torch.stack([p[1] for p in pending]).cpu().tolist()
            for (epoch, _), (loss, tr, va, te) in zip(pending, rows):
                if va > best_val:
                    best_val, best_test, best_epoch = va, te, epoch
                rec = EpochRecord(epoch, loss, tr, va, te)
                history.append(rec)
                if on_epoch is not None:
                    on_epoch(rec)
                if cfg.log_every and epoch % cfg.log_every == 0:
                    self.logger.info(
                        "Epoch %04d/%04d| Loss %.4f | Train Accuracy %.4f | "
                        "Val Accuracy %.4f | Test Accuracy %.4f | "
                        "Best val. Accuracy %.4f | Best test Accuracy %.4f",
                        epoch, epochs, loss, tr, va, te, best_val, best_test)
            pending.clear()

        t_start = time.perf_counter()
        t_steady = None   # clock after the first full iteration
        steady_from = None
        for epoch in range(epochs):
            loss = self.train_step(state, dropout_gen)
            if cfg.eval_every and (epoch % cfg.eval_every == 0
                                   or epoch == epochs - 1):
                metrics = self.eval_step(state)
                pending.append((epoch, torch.stack(
                    [loss.float(), *(m.float() for m in metrics)])))
                if len(pending) >= fetch_every:
                    flush()
            if t_steady is None:
                self._sync()
                t_steady = time.perf_counter()
                steady_from = epoch + 1
        flush()
        self._sync()
        now = time.perf_counter()
        wall = now - t_start
        steady = ((now - t_steady) / (epochs - steady_from)
                  if t_steady is not None and epochs > steady_from else None)
        if steady is not None:
            self.logger.info("Steady-state epoch time: %.3f s", steady)
        return {
            "best_val_accuracy": best_val,
            "best_test_accuracy": best_test,
            "best_epoch": best_epoch,
            "history": history,
            "wall_time_s": wall,
            "steady_epoch_s": steady,
            "final_state": state,
        }

