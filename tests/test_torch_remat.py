"""`--remat` in the port (models/remat.py): every family's losses and
gradients with remat bit-equal to the same model without it, dropout on;
the aggregation kept, not rerun; every family within 1e-4 of the JAX
model with remat=True; the Trainer bit-equal. The GPU cases (marker `gpu`:
the kernels' path bit-equal, the CUDA graph's documented raise) skip
without a card. This file imports JAX only inside the test that compares
with it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_remat.py
"""
import collections

import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs.synthetic import powerlaw_graph
from spgemm_gnn_tpu_torch.kernels import maxk as kmaxk
from spgemm_gnn_tpu_torch.kernels import planned
from spgemm_gnn_tpu_torch.models import remat as remat_mod
from spgemm_gnn_tpu_torch.models.models import MODELS, build_model
from spgemm_gnn_tpu_torch.train.config import TrainConfig
from spgemm_gnn_tpu_torch.train.loop import Trainer

N, IN_DIM, HID, OUT, K, LAYERS = 300, 12, 32, 5, 8, 2
FAMILIES = sorted(MODELS)
TINY = dict(dataset="flickr", model="sage", epochs=3, hidden_dim=32,
            hidden_layers=2, maxk=8, dropout=0.5, w_lr=0.01, norm=True,
            synthetic=True, synthetic_scale=0.004, eval_every=1,
            log_every=0, seed=3)


@pytest.fixture
def one_torch_thread():
    """One torch thread for the Trainer runs this file compares bit for
    bit, as the other bit-equal Trainer tests run
    (tests/test_torch_stream.py::one_torch_thread): no sum of the two runs
    is split across an intra-op thread pool."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _graph(kind: str, device="cpu"):
    g = powerlaw_graph(N, 3000, seed=7).to(device)
    return planned.plan_graph(g, kind=kind, dim=HID)


def _train_twice(model: str, remat: bool, g, dtype: str, device="cpu"):
    """Two steps of a model from fixed weights and dropout seed: the losses,
    every parameter's gradient after each, the buffers and the dropout
    generator's state after both."""
    m = build_model(model, in_dim=IN_DIM, hidden_dim=HID, num_layers=LAYERS,
                    out_dim=OUT, maxk=K, feat_drop=0.5, use_norm=True,
                    remat=remat, dtype=dtype)
    m.reset_parameters(torch.Generator().manual_seed(1))
    m.to(device).train()
    x = torch.randn((N, IN_DIM), generator=torch.Generator().manual_seed(0)
                    ).to(device)
    gen = torch.Generator(device=device).manual_seed(5)
    losses, grads = [], []
    for _ in range(2):
        m.zero_grad(set_to_none=True)
        loss = (m(g, x, gen).float() ** 2).mean()
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
    return dict(losses=losses, grads=grads,
                buffers={n: b.clone() for n, b in m.named_buffers()},
                rng=gen.get_state())


def _assert_bit_equal(a, b, what):
    assert a["losses"] == b["losses"], what
    for ga, gb in zip(a["grads"], b["grads"]):
        assert ga.keys() == gb.keys()
        for n in ga:
            assert torch.equal(ga[n], gb[n]), f"{what}: {n}"
    for n in a["buffers"]:
        assert torch.equal(a["buffers"][n], b["buffers"][n]), f"{what}: {n}"
    assert torch.equal(a["rng"], b["rng"]), what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", FAMILIES)
def test_remat_bit_equal_every_family(model, dtype):
    """Dropout 0.5, LayerNorm (BatchNorm for GNNRes, its running averages
    moved once a step), two steps on a windowed plan: the same losses,
    gradients, buffers and generator state with and without remat; at
    bf16 the MaxK channels reach the sampled backward."""
    g = _graph("windowed")
    _assert_bit_equal(_train_twice(model, True, g, dtype),
                      _train_twice(model, False, g, dtype),
                      f"{model} {dtype}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_bit_equal_on_a_stream_plan(dtype, monkeypatch):
    """SAGE on a stream plan with the CBSR forward forced (and the sampled
    backward on its transpose positions, f32 and bf16): bit-equal."""
    monkeypatch.setattr(planned, "STREAM_CBSR_FORWARD", True)
    g = _graph("stream")
    _assert_bit_equal(_train_twice("sage", True, g, dtype),
                      _train_twice("sage", False, g, dtype), dtype)


def test_remat_keeps_the_aggregation_and_reruns_the_rest(monkeypatch):
    """Forward and backward of a 3-layer SAGE: the aggregation runs its
    forward and backward products once each with remat as without it (the
    rerun takes its kept output), MaxK's forward runs twice a layer with
    remat (the rerun) and once without; evaluation under no_grad reruns
    nothing. The backward product is `plan_sspmm` where the sampled
    backward takes it (f32 on this windowed plan), and counts as one."""
    calls = collections.Counter()
    spmm, fwd = planned.plan_spmm, kmaxk.maxk_fwd
    sspmm = planned.plan_sspmm
    monkeypatch.setattr(planned, "plan_spmm", lambda *a, **k: (
        calls.update(["spmm"]), spmm(*a, **k))[1])
    monkeypatch.setattr(planned, "plan_sspmm", lambda *a, **k: (
        calls.update(["spmm"]), sspmm(*a, **k))[1])
    monkeypatch.setattr(kmaxk, "maxk_fwd", lambda *a, **k: (
        calls.update(["maxk"]), fwd(*a, **k))[1])
    g = _graph("windowed")
    x = torch.randn(N, IN_DIM)
    seen = {}
    for rm in (False, True):
        m = build_model("sage", in_dim=IN_DIM, hidden_dim=HID, num_layers=3,
                        out_dim=OUT, maxk=K, feat_drop=0.5, use_norm=True,
                        remat=rm)
        m.reset_parameters(torch.Generator().manual_seed(1))
        calls.clear()
        m(g, x, torch.Generator().manual_seed(2)).sum().backward()
        seen[rm] = dict(calls)
        calls.clear()
        with torch.no_grad():
            m.eval()(g, x)
        assert dict(calls) == {"spmm": 3, "maxk": 3}
    assert seen[False] == {"spmm": 6, "maxk": 3}
    assert seen[True] == {"spmm": 6, "maxk": 6}
    assert not remat_mod.recomputing()


@pytest.mark.parametrize("model", FAMILIES)
def test_remat_matches_jax_remat(model):
    """Train mode, dropout off (the frameworks draw different noise): the
    port's model with remat against the JAX model with remat=True (impl
    "xla"), the flax weights carried across: logits, the input gradient
    and every parameter's gradient within 1e-4."""
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.graphs.synthetic import powerlaw_graph as jpowerlaw
    from spgemm_gnn_tpu.models.models import build_model as jbuild
    from spgemm_gnn_tpu_torch.convert import (buffers_from_flax,
                                              params_from_flax)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, IN_DIM)).astype(np.float32)
    ct = rng.standard_normal((N, OUT)).astype(np.float32)
    jg = jpowerlaw(N, 3000, seed=7)
    jm = jbuild(model, impl="xla", hidden_dim=HID, num_layers=LAYERS,
                out_dim=OUT, maxk=K, feat_drop=0.0, use_norm=True,
                remat=True)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jg,
                        jnp.asarray(x), train=False)

    def loss(p, xv):
        out, _ = jm.apply({**variables, "params": p}, jg, xv, train=True,
                          mutable=["batch_stats"])
        return (out * jnp.asarray(ct)).sum(), out

    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    tm = build_model(model, in_dim=IN_DIM, hidden_dim=HID, num_layers=LAYERS,
                     out_dim=OUT, maxk=K, feat_drop=0.0, use_norm=True,
                     remat=True)
    tm.load_state_dict({
        **params_from_flax(jax.device_get(variables["params"])),
        **buffers_from_flax(jax.device_get(variables.get("batch_stats",
                                                         {})))})
    tm.train()
    xt = torch.tensor(x, requires_grad=True)
    out = tm(_graph("windowed"), xt)
    (out * torch.tensor(ct)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **tol)
    grads = params_from_flax(jax.device_get(gp_j))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   err_msg=name, **tol)


def _history(res):
    return [(r.loss, r.train_acc, r.val_acc, r.test_acc)
            for r in res["history"]]


@pytest.mark.parametrize("over", [{}, {"dtype": "bfloat16"},
                                  {"model": "gnn_res"}])
def test_trainer_remat_bit_equal(over, one_torch_thread):
    cfg = TrainConfig(**{**TINY, "device": "cpu", **over})
    plain = Trainer(cfg).run()
    rem = Trainer(cfg.replace(remat=True)).run()
    assert _history(rem) == _history(plain)
    a = rem["final_state"]["model"].state_dict()
    b = plain["final_state"]["model"].state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)


# ---------------------------------------------------------------------------
# GPU (skips without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", FAMILIES)
def test_remat_bit_equal_on_gpu(cuda, model, dtype):
    g = _graph("windowed", cuda)
    _assert_bit_equal(_train_twice(model, True, g, dtype, cuda),
                      _train_twice(model, False, g, dtype, cuda),
                      f"{model} {dtype}")


@pytest.mark.gpu
def test_remat_with_a_cuda_graph_raises(cuda):
    cfg = TrainConfig(**{**TINY, "device": "cuda", "eval_every": 4,
                         "steps_per_call": 4, "remat": True})
    with pytest.raises(NotImplementedError, match="--remat"):
        Trainer(cfg).run()
