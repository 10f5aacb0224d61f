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
"""
from __future__ import annotations

import json
import os


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
    results = trainer.run()
    logger.info("Best val accuracy: %.4f (epoch %d)",
                results["best_val_accuracy"], results["best_epoch"])
    logger.info("Best test accuracy: %.4f", results["best_test_accuracy"])
    logger.info("Total training time: %.1fs", results["wall_time_s"])
    summary = {k: results[k] for k in
               ("best_val_accuracy", "best_test_accuracy", "best_epoch",
                "wall_time_s", "steady_epoch_s")}
    with open(os.path.join(config.path, "results.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return results


if __name__ == "__main__":
    main()
