"""Training CLI of the port (counterpart of the repository's `train.py`).

Examples:
  python -m spgemm_gnn_tpu_torch.train --dataset reddit --model sage \
      --nonlinear maxk --maxk 32 --hidden_layers 4 --hidden_dim 256 \
      --dropout 0.5 --norm --w_lr 0.01
  python -m spgemm_gnn_tpu_torch.train --dataset flickr --synthetic \
      --synthetic_scale 0.01 --epochs 20 --device cpu
  # the 16-bit feature stream (bf16 messages, f32 sums)
  python -m spgemm_gnn_tpu_torch.train --dataset ogbn-products --synthetic \
      --hidden_layers 3 --norm --w_lr 0.003 --stream bf16x2
  # checkpoints every 10 epochs under --path, then on to 200 epochs from the
  # latest, then the accuracies of the best-val snapshot
  python -m spgemm_gnn_tpu_torch.train --dataset flickr --synthetic \
      --epochs 100 --checkpoint_every 10 --path /tmp/run
  python -m spgemm_gnn_tpu_torch.train --dataset flickr --synthetic \
      --epochs 200 --checkpoint_every 10 --resume --path /tmp/run
  python -m spgemm_gnn_tpu_torch.train --dataset flickr --synthetic \
      --evaluate /tmp/run/checkpoints/best --path /tmp/run
  # 4 train epochs a group (a CUDA graph of the step on the GPU), a trace
  # of 3 steps in /tmp/trace (the program's spans among its annotations),
  # the run's time by phase and its aggregation share, TensorBoard scalars
  python -m spgemm_gnn_tpu_torch.train --dataset flickr --synthetic \
      --epochs 20 --eval_every 5 --steps_per_call 4 --profile /tmp/trace \
      --timing --tensorboard --path /tmp/run
  # two processes, one graph shard each (gloo on the CPU; on a machine with
  # one GPU both ranks share cuda:0 over gloo), one command a rank
  python -m spgemm_gnn_tpu_torch.train --dataset flickr --synthetic \
      --epochs 20 --device cpu --multihost --coordinator 127.0.0.1:29500 \
      --num_processes 2 --process_id 0 --mesh_shape 2 --path /tmp/run
  python -m spgemm_gnn_tpu_torch.train ... --process_id 1 ...

Across processes every rank logs to its own file (`<dataset>.log` for rank
0, `<dataset>.rank<r>.log` for the others), and rank 0 writes results.json
and the TensorBoard scalars.
"""
from __future__ import annotations

import contextlib
import json
import os

from spgemm_gnn_tpu_torch.utils import spans

# the spans of a train step and their share of it, for --timing
STEP_PHASES = ("step.forward", "step.backward", "step.optimizer",
               "step.replay")
PHASES = (*STEP_PHASES, "eval", "fetch", "aggregate", "aggregate.backward")
AGGREGATION = ("aggregate", "aggregate.backward")


def timing_stats(record: list) -> dict:
    """The time of a run by phase, from the spans of a `Trainer.run`
    recorded whole (`utils/spans.py::recording`), over its steps after the
    Trainer's first (`setup.first_step`, which builds kernels and plans):

      phases: {span: {device_ms, host_ms}} an epoch (device_ms None where
        the spans placed no events: on the CPU, or inside a CUDA graph);
      setup_s: {set-up span: its self seconds, less the set-up spans
        inside it (the first step's phases are recorded too)};
      host_syncs: the run's waits on the device;
      aggregation_stats: step_s (forward, backward and optimizer an
        epoch), aggregation_s (`aggregate` and `aggregate.backward` inside
        them) and aggregation_pct, on the device's clock where the spans
        have it, else the host's.
    """
    first = {s.id for s in spans.under(record, "setup.first_step")}
    run = [s for s in spans.under(record, "trainer.run")
           if s.id not in first]
    epochs = max(sum(s.name == "step.optimizer" for s in run), 1)
    on_device = any(s.device_ms is not None for s in run)

    def ms(names, within) -> float:
        """ms an epoch of the spans of `names` in `within`, on the
        device's clock where the spans have it."""
        got = [spans.device_ms(n, within) if on_device
               else spans.host_s(n, spans=within) for n in names]
        scale = 1.0 if on_device else 1e3
        return sum(g * scale for g in got if g is not None) / epochs

    phases = {}
    for name in PHASES:
        host = spans.host_s(name, spans=run)
        if host is not None:
            dev = spans.device_ms(name, run)
            phases[name] = {"device_ms": None if dev is None else dev / epochs,
                            "host_ms": host * 1e3 / epochs}
    step_ms = ms(STEP_PHASES, run)
    agg_ms = ms(AGGREGATION, spans.under(run, *STEP_PHASES))
    setup = [s for s in record if s.name.startswith("setup.")]
    return {
        "phases": phases,
        "setup_s": {n: spans.host_s(n, own=True, spans=setup)
                    for n in sorted({s.name for s in setup})},
        "host_syncs": spans.counters["host_syncs"],
        "aggregation_stats": {
            "step_s": step_ms / 1e3, "aggregation_s": agg_ms / 1e3,
            "aggregation_pct": 100.0 * agg_ms / step_ms if step_ms else 0.0}}


def _tensorboard(config, logger):
    """A SummaryWriter under <path>/tb with the config as text, or None
    (logged) where the tensorboard package is missing."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        logger.info("tensorboard unavailable; skipping TB logging")
        return None
    writer = SummaryWriter(log_dir=os.path.join(config.path, "tb"))
    writer.add_text("config", config.as_markdown(), 0)
    return writer


def _profile(trainer, out_dir: str, logger) -> None:
    """A torch.profiler Chrome trace of 3 train steps into out_dir, on a
    fresh state and dropout generator (the run's own are untouched), after
    one step outside the trace that builds the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = trainer.init_state()
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    trainer.train_step(state, gen)
    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(3):
            trainer.train_step(state, gen)
        trainer._sync()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def main(argv=None) -> dict:
    from spgemm_gnn_tpu_torch.parallel.multihost import (
        initialize_multihost, process_summary)
    from spgemm_gnn_tpu_torch.train.config import check_supported, from_args
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    from spgemm_gnn_tpu_torch.utils.logging import get_logger

    config = from_args(argv)
    check_supported(config)
    if config.timing:
        # the record holds this run's spans alone, its set-up's included
        spans.reset()
    rank, summary = 0, None
    if config.multihost or config.coordinator:
        # before the Trainer: its mesh is one shard a rank
        initialize_multihost(config.coordinator, config.num_processes,
                             config.process_id, config.device)
        summary = process_summary(config.device)
        rank = summary["process_index"]
    os.makedirs(config.path, exist_ok=True)
    log_name = f"{config.dataset}.log" if rank == 0 else (
        f"{config.dataset}.rank{rank}.log")
    logger = get_logger(os.path.join(config.path, log_name))
    if summary is not None:
        logger.info("multihost runtime: %s", summary)
    config.print_params(logger.info)
    trainer = Trainer(config, logger=logger)
    if config.evaluate:
        # eval-only: restore the checkpoint and report its accuracies
        tr, va, te = trainer.evaluate_checkpoint(config.evaluate)
        logger.info("Eval-only: train %.4f | val %.4f | test %.4f",
                    tr, va, te)
        out = {"train_acc": tr, "val_acc": va, "test_acc": te}
        if rank == 0:
            with open(os.path.join(config.path, "results.json"), "w") as f:
                json.dump(out, f)
        return out
    logger.info("Training...")
    writer = (_tensorboard(config, logger)
              if config.tensorboard and rank == 0 else None)
    try:
        return _train(config, trainer, logger, writer)
    finally:
        if writer is not None:
            writer.close()


def _train(config, trainer, logger, writer) -> dict:
    """The training run of `main`, its optional profile before it, its
    spans recorded with --timing; results.json under config.path."""
    def on_epoch(rec):
        if writer is not None:
            writer.add_scalar("train/loss", rec.loss, rec.epoch)
            writer.add_scalar("train/train_acc", rec.train_acc, rec.epoch)
            writer.add_scalar("train/val_acc", rec.val_acc, rec.epoch)
            writer.add_scalar("train/test_acc", rec.test_acc, rec.epoch)

    if config.profile:
        _profile(trainer, config.profile, logger)
    with (spans.recording() if config.timing
          else contextlib.nullcontext()):
        results = trainer.run(on_epoch=on_epoch)
    logger.info("Best val accuracy: %.4f (epoch %d)",
                results["best_val_accuracy"], results["best_epoch"])
    logger.info("Best test accuracy: %.4f", results["best_test_accuracy"])
    logger.info("Total training time: %.1fs", results["wall_time_s"])
    if config.timing:
        # the run's phases and the aggregation share of its steps (the
        # reference's Amdahl stat), from the spans inside them
        timing = timing_stats(spans.record())
        for name, p in timing["phases"].items():
            dev = ("-" if p["device_ms"] is None
                   else f"{p['device_ms']:.3f}")
            logger.info("Phase %s: device %s ms, host %.3f ms an epoch",
                        name, dev, p["host_ms"])
        for name, sec in timing["setup_s"].items():
            logger.info("Set-up %s: %.3f s (self)", name, sec)
        logger.info("Host syncs: %d", timing["host_syncs"])
        stats = timing.pop("aggregation_stats")
        logger.info("Train step time: %.4fs", stats["step_s"])
        logger.info("Forward+backward aggregation time: %.4fs",
                    stats["aggregation_s"])
        logger.info("Aggregation percentage: %.2f%%",
                    stats["aggregation_pct"])
        results["timing"] = timing
        results["aggregation_stats"] = stats
    summary = {k: results[k] for k in
               ("best_val_accuracy", "best_test_accuracy", "best_epoch",
                "wall_time_s", "steady_epoch_s")}
    if config.timing:
        summary["timing"] = results["timing"]
        summary["aggregation_stats"] = results["aggregation_stats"]
    if results["collectives"]:
        logger.info("Collectives: %s", results["collectives"])
    if trainer.logs_epochs:       # rank 0 across ranks
        with open(os.path.join(config.path, "results.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return results

if __name__ == "__main__":
    main()
