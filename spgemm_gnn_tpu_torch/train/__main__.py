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
  # of 3 steps in /tmp/trace, the aggregation share, TensorBoard scalars
  python -m spgemm_gnn_tpu_torch.train --dataset flickr --synthetic \
      --epochs 20 --eval_every 5 --steps_per_call 4 --profile /tmp/trace \
      --timing --tensorboard --path /tmp/run
"""
from __future__ import annotations

import json
import os


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
    from spgemm_gnn_tpu_torch.train.config import check_supported, from_args
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    from spgemm_gnn_tpu_torch.utils.logging import get_logger

    config = from_args(argv)
    check_supported(config)
    os.makedirs(config.path, exist_ok=True)
    logger = get_logger(os.path.join(config.path, f"{config.dataset}.log"))
    config.print_params(logger.info)
    trainer = Trainer(config, logger=logger)
    if config.evaluate:
        # eval-only: restore the checkpoint and report its accuracies
        tr, va, te = trainer.evaluate_checkpoint(config.evaluate)
        logger.info("Eval-only: train %.4f | val %.4f | test %.4f",
                    tr, va, te)
        out = {"train_acc": tr, "val_acc": va, "test_acc": te}
        with open(os.path.join(config.path, "results.json"), "w") as f:
            json.dump(out, f)
        return out
    logger.info("Training...")
    writer = _tensorboard(config, logger) if config.tensorboard else None
    try:
        return _train(config, trainer, logger, writer)
    finally:
        if writer is not None:
            writer.close()


def _train(config, trainer, logger, writer) -> dict:
    """The training run of `main`, its optional profile before it and
    timing probe after it; results.json under config.path."""
    def on_epoch(rec):
        if writer is not None:
            writer.add_scalar("train/loss", rec.loss, rec.epoch)
            writer.add_scalar("train/train_acc", rec.train_acc, rec.epoch)
            writer.add_scalar("train/val_acc", rec.val_acc, rec.epoch)
            writer.add_scalar("train/test_acc", rec.test_acc, rec.epoch)

    if config.profile:
        _profile(trainer, config.profile, logger)
    results = trainer.run(on_epoch=on_epoch)
    logger.info("Best val accuracy: %.4f (epoch %d)",
                results["best_val_accuracy"], results["best_epoch"])
    logger.info("Best test accuracy: %.4f", results["best_test_accuracy"])
    logger.info("Total training time: %.1fs", results["wall_time_s"])
    if config.timing:
        # the aggregation share of a train step (the reference's Amdahl
        # stat); a failing probe fails the run
        from spgemm_gnn_tpu_torch.utils.timing import (
            measure_aggregation_fraction)
        stats = measure_aggregation_fraction(trainer)
        logger.info("Train step time: %.4fs", stats["step_s"])
        logger.info("Forward+backward aggregation time: %.4fs",
                    stats["aggregation_s"])
        logger.info("Aggregation percentage: %.2f%%",
                    stats["aggregation_pct"])
        results["aggregation_stats"] = stats
    summary = {k: results[k] for k in
               ("best_val_accuracy", "best_test_accuracy", "best_epoch",
                "wall_time_s", "steady_epoch_s")}
    if "aggregation_stats" in results:
        summary["aggregation_stats"] = results["aggregation_stats"]
    with open(os.path.join(config.path, "results.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return results

if __name__ == "__main__":
    main()
