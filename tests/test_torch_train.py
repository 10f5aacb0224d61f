"""The port's Trainer, optimizers and CLI against the JAX package, and
chip_smoke.py's refusal to run without a GPU."""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spgemm_gnn_tpu.graphs.datasets import load_dataset as jload
from spgemm_gnn_tpu.train.config import TrainConfig as JConfig
from spgemm_gnn_tpu.train.loop import Trainer as JTrainer
from spgemm_gnn_tpu.train.optim import build_optimizer as jbuild_optimizer
from spgemm_gnn_tpu_torch.convert import params_from_flax
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.datasets import Dataset
from spgemm_gnn_tpu_torch.train.__main__ import main as tmain
from spgemm_gnn_tpu_torch.train.config import TrainConfig, check_supported
from spgemm_gnn_tpu_torch.train.loop import Trainer
from spgemm_gnn_tpu_torch.train.optim import build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = dict(dataset="flickr", model="sage", epochs=5, hidden_dim=32,
              hidden_layers=2, maxk=8, dropout=0.0, w_lr=0.01,
              nonlinear="maxk", norm=True, synthetic=True,
              synthetic_scale=0.004, eval_every=1, log_every=0, seed=3)


def test_trainer_matches_jax_trainer():
    """One dataset's numpy arrays, the JAX initial weights, dropout off, five
    epochs: the per-epoch losses agree within 1e-4 and val accuracy within
    one node."""
    jd = jload("flickr", "/nonexistent", allow_synthetic=True,
               synthetic_scale=COMMON["synthetic_scale"], seed=COMMON["seed"])
    jt = JTrainer(JConfig(impl="xla", **COMMON), dataset=jd)
    jres = jt.run()

    td = Dataset(name=jd.name,
                 graph=from_edges(np.asarray(jd.graph.indices),
                                  np.asarray(jd.graph.edge_dst),
                                  jd.graph.num_nodes),
                 features=jd.features, labels=jd.labels,
                 train_mask=jd.train_mask, val_mask=jd.val_mask,
                 test_mask=jd.test_mask, num_classes=jd.num_classes,
                 multilabel=jd.multilabel)
    tt = Trainer(TrainConfig(impl="auto", device="cpu", **COMMON), dataset=td)
    weights = params_from_flax(jax.device_get(jt.init_state()["params"]))
    tres = tt.run(state=tt.init_state(weights=weights))

    jl = np.array([r.loss for r in jres["history"]])
    tl = np.array([r.loss for r in tres["history"]])
    assert len(tl) == len(jl) == COMMON["epochs"]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    n_val = int(jd.val_mask.sum())
    for rj, rt in zip(jres["history"], tres["history"]):
        assert abs(rj.val_acc - rt.val_acc) * n_val <= 1 + 1e-6
    assert tres["best_epoch"] >= 0 and tres["steady_epoch_s"] is not None


@pytest.mark.parametrize("lookahead", [False, True])
def test_optimizer_matches_optax(lookahead):
    """Adam with L2 folded in (and Lookahead α 0.5, k 6) follows the optax
    trajectory on a toy problem whose gradient depends on the parameters."""
    rng = np.random.default_rng(2)
    p0 = {"w": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    target = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()}

    def jloss(p):
        return sum(((p[k] - target[k]) ** 2).sum() + 0.25 * (p[k] ** 4).sum()
                   for k in p)

    tx = jbuild_optimizer(0.05, 1e-3, lookahead)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt = build_optimizer(list(tp.values()), 0.05, 1e-3, lookahead)
    tt = {k: torch.tensor(v) for k, v in target.items()}
    for _ in range(13):                 # two Lookahead syncs, then one step
        u, st = tx.update(jax.grad(jloss)(jp), st, jp)
        jp = optax.apply_updates(jp, u)
        opt.zero_grad()
        sum(((tp[k] - tt[k]) ** 2).sum() + 0.25 * (tp[k] ** 4).sum()
            for k in tp).backward()
        opt.step()
        # optax takes Adam's bias corrections 1 - b^t in f32 (1 - 0.999 is
        # off by 1.3e-5 relative at t = 1), PyTorch in f64: the updates differ
        # by ~6e-6 relative and the O(1) parameters drift by up to ~5e-6
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-5)


def test_cli_trains_on_cpu(tmp_path):
    res = tmain(["--dataset", "flickr", "--synthetic", "--synthetic_scale",
                 "0.003", "--epochs", "3", "--hidden_dim", "16",
                 "--hidden_layers", "1", "--maxk", "4", "--device", "cpu",
                 "--path", str(tmp_path)])
    assert len(res["history"]) == 3
    summary = json.loads((tmp_path / "results.json").read_text())
    assert summary["best_epoch"] == res["best_epoch"]
    assert (tmp_path / "flickr.log").exists()


def test_default_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainConfig(**COMMON))


@pytest.mark.parametrize("flag", [
    dict(mesh_shape=2), dict(multihost=True), dict(coordinator="h:1")])
def test_unported_flags_raise(flag):
    """Only the multi-GPU flags (ROADMAP Queue A13) are left unported."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_supported(TrainConfig(**{**COMMON, **flag}))


@pytest.mark.parametrize("flag", [
    dict(remat=True), dict(device_inputs=True),
    dict(dataset="ogbn-proteins")])
def test_lifted_flags_pass_the_check(flag):
    """--remat, --device_inputs and ogbn-proteins no longer raise."""
    check_supported(TrainConfig(**{**COMMON, **flag}))


def test_dtype_flag_is_supported():
    """`--dtype bfloat16` is ported: check_supported accepts float32 and
    bfloat16 and rejects any other dtype, and so does the CLI's parser."""
    from spgemm_gnn_tpu_torch.train.config import from_args
    for dtype in ("float32", "bfloat16"):
        check_supported(TrainConfig(**{**COMMON, "dtype": dtype}))
        assert from_args(["--dtype", dtype]).dtype == dtype
    with pytest.raises(ValueError, match="dtype"):
        check_supported(TrainConfig(**{**COMMON, "dtype": "float16"}))
    with pytest.raises(SystemExit):
        from_args(["--dtype", "float16"])


def test_stream_flag_is_supported_and_sets_default_stream(monkeypatch):
    """`--stream bf16x2` is ported: check_supported accepts it, and the
    Trainer sets `kernels.planned.DEFAULT_STREAM` from it unconditionally,
    as the reference's does (a later f32 Trainer sets "f32" back)."""
    from spgemm_gnn_tpu_torch.kernels import planned as tplanned
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", "f32")
    for stream in ("bf16x2", "f32"):
        cfg = TrainConfig(**{**COMMON, "stream": stream, "device": "cpu"})
        check_supported(cfg)
        Trainer(cfg)
        assert tplanned.DEFAULT_STREAM == stream


def test_chip_smoke_fails_without_gpu(tmp_path):
    """No GPU, or no repository around it: a non-zero exit within seconds and
    no result line (there is no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would measure it")
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    for cwd in (ROOT, str(lone)):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           capture_output=True, text=True, timeout=120,
                           env=dict(os.environ, PYTHONPATH=""))
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
