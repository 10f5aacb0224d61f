"""The port's GCN, GIN, GNNRes and integrated MaxK models against the JAX
package's, with the flax weights (and batch statistics) carried across by
`convert.py` (dropout off: the two frameworks draw different noise).

Each family runs on the raw graph (the plain aggregation on the CPU) and on
a forced stream plan with `STREAM_CBSR_FORWARD` set (the CBSR stream
forward's plain version); logits, the input gradient and every parameter's
gradient agree with the JAX model (impl "xla") to 2e-4, the tolerance of
tests/test_torch_model.py. Then GNNRes's running statistics after a train
step, the init scheme, the GCN recipe's Trainer against the JAX Trainer, and
the CLI for every family.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu.graphs.synthetic import powerlaw_graph as jpowerlaw
from spgemm_gnn_tpu.models.models import build_model as jbuild
from spgemm_gnn_tpu_torch.convert import buffers_from_flax, params_from_flax
from spgemm_gnn_tpu_torch.graphs.synthetic import powerlaw_graph as tpowerlaw
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.models.models import build_model as tbuild

N, IN_DIM, HID, OUT, K, LAYERS = 300, 12, 32, 5, 8, 2
TOL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = ["gcn", "gin", "gnn_res", "sage_integrated", "gcn_integrated",
            "gin_integrated"]


def _inputs(seed: int = 3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, IN_DIM)).astype(np.float32),
            rng.standard_normal((N, OUT)).astype(np.float32))


def _jax_model(model: str, nonlinear: str, use_norm: bool, x: np.ndarray):
    jg = jpowerlaw(N, 3000, seed=7)
    jm = jbuild(model, impl="xla", hidden_dim=HID, num_layers=LAYERS,
                out_dim=OUT, maxk=K, feat_drop=0.0, use_norm=use_norm,
                nonlinear=nonlinear)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jg,
                        jnp.asarray(x), train=False)
    return jg, jm, variables


def _port_model(model: str, nonlinear: str, use_norm: bool, variables):
    tm = tbuild(model, in_dim=IN_DIM, hidden_dim=HID, num_layers=LAYERS,
                out_dim=OUT, maxk=K, feat_drop=0.0, use_norm=use_norm,
                nonlinear=nonlinear, impl="auto")
    tm.load_state_dict({
        **params_from_flax(jax.device_get(variables["params"])),
        **buffers_from_flax(jax.device_get(variables.get("batch_stats",
                                                         {})))})
    return tm


def _port_graphs():
    """The raw graph, and a stream plan of 7-edge chunks (for the flag)."""
    tg = tpowerlaw(N, 3000, seed=7)
    return {"raw": tg,
            "stream_cbsr": tplanned.plan_graph(tg, kind="stream", chunk=7)}


def _port_run(tm, g, x, ct):
    xt = torch.tensor(x, requires_grad=True)
    out = tm(g, xt)
    (out * torch.tensor(ct)).sum().backward()
    return out.detach(), xt.grad, {n: p.grad.clone()
                                   for n, p in tm.named_parameters()}


def _assert_matches(tm, got, out_j, gx_j, gp_j, what):
    out_t, gx_t, grads_t = got
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               err_msg=what, **TOL)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), err_msg=what,
                               **TOL)
    grads = params_from_flax(jax.device_get(gp_j))
    assert set(grads) == {n for n, _ in tm.named_parameters()}, what
    for name, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), grads[name].numpy(),
                                   err_msg=f"{what}: {name}", **TOL)


@pytest.mark.parametrize("use_norm", [True, False])
@pytest.mark.parametrize("nonlinear", ["maxk", "relu"])
@pytest.mark.parametrize("model", FAMILIES)
def test_family_matches_jax(model, nonlinear, use_norm, monkeypatch):
    """Eval mode (GNNRes's BatchNorm normalises by the running statistics,
    as flax's with train=False)."""
    x, ct = _inputs()
    jg, jm, variables = _jax_model(model, nonlinear, use_norm, x)

    def loss(p, xv):
        out = jm.apply({**variables, "params": p}, jg, xv, train=False)
        return (out * jnp.asarray(ct)).sum(), out

    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", True)
    tm = _port_model(model, nonlinear, use_norm, variables).eval()
    for what, g in _port_graphs().items():
        tm.zero_grad(set_to_none=True)
        _assert_matches(tm, _port_run(tm, g, x, ct), out_j, gx_j, gp_j, what)


@pytest.mark.parametrize("model", FAMILIES)
def test_flag_on_and_off_agree_by_value(model, monkeypatch):
    """With MaxK on a stream plan, the model with the flag set gives the
    flag-off model's logits and gradients by value (the CBSR forward sums
    the same terms in the same order)."""
    x, ct = _inputs(5)
    _, _, variables = _jax_model(model, "maxk", True, x)
    g = _port_graphs()["stream_cbsr"]
    runs = []
    for flag in (True, False):
        monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", flag)
        tm = _port_model(model, "maxk", True, variables)
        runs.append(_port_run(tm, g, x, ct))
    (out_a, gx_a, gp_a), (out_b, gx_b, gp_b) = runs
    assert torch.equal(out_a, out_b) and torch.equal(gx_a, gx_b)
    for name in gp_a:
        assert torch.equal(gp_a[name], gp_b[name]), name


@pytest.mark.parametrize("graph", ["raw", "stream_cbsr"])
def test_gnn_res_batch_stats_match_jax_after_a_train_step(graph,
                                                          monkeypatch):
    """Train mode: normalised by the batch's statistics; the running mean
    and variance after the step equal flax's batch_stats (momentum 0.9,
    biased variance), which torch.nn.BatchNorm1d's unbiased running
    variance would not."""
    x, ct = _inputs(4)
    jg, jm, variables = _jax_model("gnn_res", "relu", True, x)

    def loss(p, xv):
        out, new = jm.apply({**variables, "params": p}, jg, xv, train=True,
                            mutable=["batch_stats"])
        return (out * jnp.asarray(ct)).sum(), (out, new["batch_stats"])

    (_, (out_j, stats_j)), (gp_j, gx_j) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", True)
    tm = _port_model("gnn_res", "relu", True, variables).train()
    _assert_matches(tm, _port_run(tm, _port_graphs()[graph], x, ct), out_j,
                    gx_j, gp_j, graph)
    # the statistics are means over the nodes of inputs that agree to f32
    # rounding: 1e-5 relative, so that the unbiased variance (300/299 of
    # the biased one, 3.3e-4 more in the running variance) fails
    want = buffers_from_flax(jax.device_get(stats_j))
    assert set(want) == {n for n, _ in tm.named_buffers()}
    for name, buf in tm.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                   err_msg=name, rtol=1e-5, atol=1e-6)
    assert not torch.equal(tm.bn0.running_var, torch.ones(HID))


@pytest.mark.parametrize("model", FAMILIES)
def test_init_follows_jax_scheme(model):
    """Xavier-uniform bounds (gain √2 on fc_self, fc_neigh and conv_w, 1
    elsewhere), zero biases and scalars, and the same weights from the same
    seed (SAGE's case is tests/test_torch_model.py's)."""
    def make():
        m = tbuild(model, in_dim=IN_DIM, hidden_dim=HID, num_layers=LAYERS,
                   out_dim=OUT, use_norm=True)
        m.reset_parameters(torch.Generator().manual_seed(5))
        return m

    a, b = make(), make()
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        p = p.detach()
        assert torch.equal(p, q), name
        leaf = name.split(".")[-1]
        if leaf == "bias" or leaf.startswith(("eps", "conv_b")):
            assert torch.count_nonzero(p) == 0, name
        elif name.startswith(("norm", "bn")) or ".norm." in name:
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            fan_out, fan_in = p.shape
            relu_gain = any(s in name for s in ("fc_self", "fc_neigh",
                                                "conv_w"))
            bound = (2.0 ** 0.5 if relu_gain else 1.0) * (
                6.0 / (fan_in + fan_out)) ** 0.5
            assert bound * 0.5 < float(p.abs().max()) <= bound, name


@pytest.mark.parametrize("chunk", [7, 128])
def test_gcn_recipe_trainer_with_flag_follows_jax(chunk, monkeypatch):
    """GCN with self-loops (the recipes' --selfloop), MaxK, 5 epochs, on a
    forced stream plan with STREAM_CBSR_FORWARD set: the port's Trainer
    follows the JAX Trainer (impl "xla") per epoch within 1e-4 of the loss
    and one val node, at the size where tests/test_torch_train.py holds the
    SAGE Trainer (flickr stand-in at scale 0.004)."""
    from spgemm_gnn_tpu.graphs.datasets import load_dataset as jload
    from spgemm_gnn_tpu.train.config import TrainConfig as JConfig
    from spgemm_gnn_tpu.train.loop import Trainer as JTrainer
    from spgemm_gnn_tpu_torch.graphs.csr import from_edges
    from spgemm_gnn_tpu_torch.graphs.datasets import Dataset
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer

    cfg = dict(dataset="flickr", model="gcn", selfloop=True, epochs=5,
               hidden_dim=32, hidden_layers=2, maxk=8, dropout=0.0,
               w_lr=0.01, nonlinear="maxk", norm=True, synthetic=True,
               synthetic_scale=0.004, eval_every=1, log_every=0, seed=3)
    jd = jload("flickr", "/nonexistent", self_loop=True, allow_synthetic=True,
               synthetic_scale=cfg["synthetic_scale"], seed=cfg["seed"])
    jt = JTrainer(JConfig(impl="xla", **cfg), dataset=jd)
    jres = jt.run()

    n = jd.graph.num_nodes
    src, dst = np.asarray(jd.graph.indices), np.asarray(jd.graph.edge_dst)
    assert (src == dst).sum() == n                  # one loop per node
    td = Dataset(name=jd.name, graph=from_edges(src, dst, n),
                 features=jd.features, labels=jd.labels,
                 train_mask=jd.train_mask, val_mask=jd.val_mask,
                 test_mask=jd.test_mask, num_classes=jd.num_classes,
                 multilabel=jd.multilabel)
    tt = Trainer(TrainConfig(impl="auto", device="cpu", **cfg), dataset=td)
    tt.g = tplanned.plan_graph(tt.g.graph, kind="stream", chunk=chunk)
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", True)
    calls = []
    fn = tplanned.stream_cbsr_spmm
    monkeypatch.setattr(tplanned, "stream_cbsr_spmm",
                        lambda *a: calls.append(1) or fn(*a))
    weights = params_from_flax(jax.device_get(jt.init_state()["params"]))
    tres = tt.run(state=tt.init_state(weights=weights))
    # per epoch a train and an eval forward, one aggregation per layer
    assert len(calls) == 5 * 2 * cfg["hidden_layers"]

    jl = np.array([r.loss for r in jres["history"]])
    tl = np.array([r.loss for r in tres["history"]])
    assert len(tl) == len(jl) == cfg["epochs"]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    n_val = int(jd.val_mask.sum())
    for rj, rt in zip(jres["history"], tres["history"]):
        assert abs(rj.val_acc - rt.val_acc) * n_val <= 1 + 1e-6


@pytest.mark.parametrize("model", FAMILIES)
def test_cli_trains_every_family_on_cpu(model, tmp_path):
    """`python -m spgemm_gnn_tpu_torch.train --model <family> --device cpu`
    (with --selfloop, as the recipes give the families other than SAGE)."""
    from spgemm_gnn_tpu_torch.train.__main__ import main as tmain
    res = tmain(["--dataset", "flickr", "--synthetic", "--synthetic_scale",
                 "0.003", "--model", model, "--selfloop", "--norm",
                 "--epochs", "2", "--hidden_dim", "16", "--hidden_layers",
                 "2", "--maxk", "4", "--device", "cpu", "--path",
                 str(tmp_path)])
    assert len(res["history"]) == 2
    assert all(np.isfinite(r.loss) for r in res["history"])
