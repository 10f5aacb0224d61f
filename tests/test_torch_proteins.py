"""ogbn-proteins in the port: the ROC-AUC metrics against the JAX
package's (`spgemm_gnn_tpu/train/metrics.py`), and the proteins stand-in's
Trainer against the JAX Trainer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu.train import metrics as jmetrics
from spgemm_gnn_tpu_torch.train import metrics as tmetrics


def _scores(seed: int, n: int = 400, c: int = 12, ties: bool = True):
    """Logits (rounded to a coarse grid where `ties`, so that many tie),
    multilabel labels with a class of no positive and a class of no
    negative, and a random mask."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32)
    if ties:
        logits = np.round(logits * 4) / 4
    labels = (rng.random((n, c)) < 0.35).astype(np.float32)
    labels[:, 0] = 0.0          # no positive
    labels[:, 1] = 1.0          # no negative
    mask = rng.random(n) < 0.6
    return logits, labels, mask


@pytest.mark.parametrize("seed,ties", [(0, True), (1, True), (2, False)])
def test_rocauc_numpy_equals_jax(seed, ties):
    """The host rocauc is the JAX package's exactly, ties and classes with
    no positive or no negative included."""
    logits, labels, mask = _scores(seed, ties=ties)
    assert tmetrics.rocauc(logits, labels, mask) == jmetrics.rocauc(
        logits, labels, mask)
    # single-label labels (a 1-D 0/1 column) too
    assert tmetrics.rocauc(logits[:, 2], labels[:, 2], mask) == \
        jmetrics.rocauc(logits[:, 2], labels[:, 2], mask)


@pytest.mark.parametrize("seed,ties", [(0, True), (3, True), (4, False)])
def test_rocauc_tensor_against_host_and_jax(seed, ties):
    """On tensors: within 1e-12 of the host rocauc (each class's AUC is
    exact: the doubled ranks summed in int64) and within 1e-5 of
    rocauc_jax, which sums f32 ranks."""
    logits, labels, mask = _scores(seed, ties=ties)
    got = tmetrics.rocauc_tensor(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask))
    assert got.dtype == torch.float64 and got.dim() == 0
    host = tmetrics.rocauc(logits, labels, mask)
    assert abs(float(got) - host) <= 1e-12
    jax_auc = float(jmetrics.rocauc_jax(jnp.asarray(logits),
                                        jnp.asarray(labels),
                                        jnp.asarray(mask)))
    assert abs(float(got) - jax_auc) <= 1e-5


def test_rocauc_tensor_no_valid_class_is_zero():
    """No class with both a positive and a negative: 0, as both JAX
    functions give."""
    logits, _, mask = _scores(5)
    labels = np.zeros_like(logits)
    got = tmetrics.rocauc_tensor(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask))
    assert float(got) == 0.0 == jmetrics.rocauc(logits, labels, mask)


@pytest.mark.parametrize("multilabel", [False, True])
def test_accuracy_topk_equals_jax(multilabel):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((200, 9)).astype(np.float32)
    labels = (rng.random((200, 9)) < 0.3).astype(np.float32) if multilabel \
        else rng.integers(0, 9, 200)
    assert tmetrics.accuracy_topk(logits, labels, (1, 3, 5)) == \
        jmetrics.accuracy_topk(logits, labels, (1, 3, 5))


def test_proteins_trainer_matches_jax_trainer():
    """The proteins stand-in (scale 0.002: N 265), 2 layers x 64, MaxK 8,
    dropout off, 3 epochs, from the JAX initial weights: the port's losses
    within 1e-4 of the JAX Trainer's and its train / val / test ROC-AUCs
    within 1e-4 (BCE loss, ROC-AUC metric, the windowed plan)."""
    import jax
    from spgemm_gnn_tpu.graphs.datasets import load_dataset as jload
    from spgemm_gnn_tpu.train.config import TrainConfig as JConfig
    from spgemm_gnn_tpu.train.loop import Trainer as JTrainer
    from spgemm_gnn_tpu_torch.convert import params_from_flax
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer

    cfg = dict(dataset="ogbn-proteins", model="sage", epochs=3,
               hidden_dim=64, hidden_layers=2, maxk=8, dropout=0.0,
               w_lr=0.01, nonlinear="maxk", norm=True, synthetic=True,
               synthetic_scale=0.002, eval_every=1, log_every=0, seed=97)
    jd = jload("ogbn-proteins", "/nonexistent", allow_synthetic=True,
               synthetic_scale=cfg["synthetic_scale"], seed=cfg["seed"])
    jt = JTrainer(JConfig(impl="xla", **cfg), dataset=jd)
    jres = jt.run()
    td = load_dataset("ogbn-proteins", "/nonexistent", allow_synthetic=True,
                      synthetic_scale=cfg["synthetic_scale"],
                      seed=cfg["seed"])
    assert td.multilabel and td.num_classes == 112
    np.testing.assert_array_equal(td.labels, jd.labels)
    tt = Trainer(TrainConfig(impl="auto", device="cpu", **cfg), dataset=td)
    assert tt.g.kind == "windowed"
    weights = params_from_flax(jax.device_get(jt.init_state()["params"]))
    tres = tt.run(state=tt.init_state(weights=weights))
    assert len(tres["history"]) == len(jres["history"]) == 3
    for rj, rt in zip(jres["history"], tres["history"]):
        assert abs(rj.loss - rt.loss) <= 1e-4
        for a, b in ((rj.train_acc, rt.train_acc), (rj.val_acc, rt.val_acc),
                     (rj.test_acc, rt.test_acc)):
            assert abs(a - b) <= 1e-4
            assert 0.0 < b < 1.0
    assert abs(tres["best_val_accuracy"] - jres["best_val_accuracy"]) <= 1e-4


def test_eval_step_takes_rocauc_for_proteins_only():
    """The Trainer's evaluation is ROC-AUC on ogbn-proteins (the host
    rocauc of the same logits) and micro-F1 on yelp, the other multilabel
    stand-in."""
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    from spgemm_gnn_tpu_torch.train.metrics import micro_f1
    for name, scale in (("ogbn-proteins", 0.002), ("yelp", 0.0005)):
        tr = Trainer(TrainConfig(dataset=name, synthetic=True,
                                 synthetic_scale=scale, hidden_dim=16,
                                 hidden_layers=1, maxk=4, device="cpu",
                                 log_every=0))
        state = tr.init_state()
        got = tr.eval_step(state)
        with torch.no_grad():
            state["model"].eval()
            logits = state["model"](tr.g, tr.features)
        for m, v in zip(tr.masks, got):
            if name == "ogbn-proteins":
                want = tmetrics.rocauc(logits.numpy(), tr.labels.numpy(),
                                       m.numpy())
                assert abs(float(v) - want) <= 1e-12
            else:
                assert float(v) == float(micro_f1(logits, tr.labels, m))


def test_cli_trains_proteins_on_cpu(tmp_path):
    from spgemm_gnn_tpu_torch.train.__main__ import main as tmain
    res = tmain(["--dataset", "ogbn-proteins", "--synthetic",
                 "--synthetic_scale", "0.002", "--epochs", "2",
                 "--hidden_dim", "16", "--hidden_layers", "1", "--maxk",
                 "4", "--device", "cpu", "--path", str(tmp_path)])
    assert len(res["history"]) == 2
    assert all(0.0 < r.val_acc < 1.0 for r in res["history"])
    assert (tmp_path / "results.json").exists()
