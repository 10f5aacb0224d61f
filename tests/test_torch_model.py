"""The port's SAGE against the JAX package's SAGE, with the flax weights
carried across by `convert.params_from_flax` (dropout off: the two
frameworks draw different noise). Outputs, input gradients and parameter
gradients agree to 2e-4, the tolerance of tests/test_torch_crossval.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu.graphs.synthetic import powerlaw_graph as jpowerlaw
from spgemm_gnn_tpu.models.models import build_model as jbuild
from spgemm_gnn_tpu_torch.convert import params_from_flax
from spgemm_gnn_tpu_torch.graphs.synthetic import powerlaw_graph as tpowerlaw
from spgemm_gnn_tpu_torch.models.models import build_model as tbuild

N, IN_DIM, HID, OUT, K, LAYERS = 80, 12, 16, 5, 4, 2
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("use_norm", [True, False])
@pytest.mark.parametrize("nonlinear", ["maxk", "relu"])
def test_sage_matches_jax(nonlinear, use_norm, impl):
    jg, tg = jpowerlaw(N, 400, seed=7), tpowerlaw(N, 400, seed=7)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, IN_DIM)).astype(np.float32)
    ct = rng.standard_normal((N, OUT)).astype(np.float32)
    kw = dict(hidden_dim=HID, num_layers=LAYERS, out_dim=OUT, maxk=K,
              feat_drop=0.0, use_norm=use_norm, nonlinear=nonlinear)

    jm = jbuild("sage", impl="xla", **kw)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jg, jnp.asarray(x),
                     train=False)["params"]

    def loss(p, xv):
        out = jm.apply({"params": p}, jg, xv, train=False)
        return (out * jnp.asarray(ct)).sum(), out

    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    tm = tbuild("sage", in_dim=IN_DIM, impl=impl, **kw)
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    xt = torch.tensor(x, requires_grad=True)
    out_t = tm(tg, xt)
    (out_t * torch.tensor(ct)).sum().backward()

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **TOL)
    grads = params_from_flax(jax.device_get(gp_j))
    assert set(grads) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   err_msg=name, **TOL)


def test_init_follows_jax_scheme():
    """Xavier-uniform bounds (gain 1 on lin_in/lin_out, √2 on fc_*), zero
    biases, and the same weights from the same seed."""
    def make():
        m = tbuild("sage", in_dim=IN_DIM, hidden_dim=HID, num_layers=LAYERS,
                   out_dim=OUT, use_norm=True)
        m.reset_parameters(torch.Generator().manual_seed(5))
        return m

    a, b = make(), make()
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        p = p.detach()
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert torch.count_nonzero(p) == 0, name
        elif name.endswith("weight") and "norm" not in name:
            fan_out, fan_in = p.shape
            gain = 2.0 ** 0.5 if ".fc_" in name else 1.0
            bound = gain * (6.0 / (fan_in + fan_out)) ** 0.5
            assert float(p.abs().max()) <= bound, name
            assert float(p.abs().max()) > 0.5 * bound, name


def test_unported_models_raise():
    """Every family is ported, and so is --remat (it builds, flagged on the
    model); an unknown model is a ValueError, as in the JAX package."""
    kw = dict(in_dim=4, hidden_dim=8, num_layers=1, out_dim=2)
    assert tbuild("sage", remat=True, **kw).remat
    assert not tbuild("sage", **kw).remat
    with pytest.raises(ValueError, match="unknown model"):
        tbuild("gat", **kw)


def test_bfloat16_model_is_built_and_unknown_dtype_raises():
    """The 16-bit model is ported: dtype "bfloat16" builds every hidden
    layer at bf16 with f32 parameters and an f32 lin_out; float16 or any
    other dtype raises."""
    kw = dict(in_dim=4, hidden_dim=8, num_layers=1, out_dim=2,
              use_norm=True)
    m = tbuild("gcn", dtype="bfloat16", **kw)
    assert m.compute_dtype == torch.bfloat16
    assert m.lin0.compute_dtype == m.norm0.compute_dtype == torch.bfloat16
    assert m.lin_out.compute_dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert tbuild("gcn", dtype="float32", **kw).compute_dtype == torch.float32
    for bad in ("float16", "int8", torch.float16):
        with pytest.raises(ValueError, match="dtype"):
            tbuild("gcn", dtype=bad, **kw)
