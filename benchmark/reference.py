"""The plain reference: MaxK-GNN's SAGE model trained full-graph, in plain
PyTorch, for the first steps of a run.

It follows the published model (MaxK-GNN, ASPLOS'24; DGL's SAGEConv with
the mean aggregator): lin_in, then per layer MaxK (the k largest entries of
each row kept, ties to the lowest channel), inverted dropout, the mean over
in-neighbours, fc_self(x) + fc_neigh(mean), LayerNorm; then lin_out, and
cross-entropy averaged over the training rows; Adam (betas 0.9 / 0.999,
eps 1e-8, no weight decay).

`dtype` is the traffic's compute dtype. "float32" computes every
activation in f32. "bfloat16" is the 16-bit model as the configuration
states it (flax's mixed precision, which the port follows): the features
cast to bf16; every hidden dense layer casts its input, weight and bias to
bf16 and rounds its product to bf16; MaxK and dropout act on the bf16 rows;
the mean sums the bf16 rows in f32 and gives bf16(bf16(sum) * bf16(1/deg)),
its backward sums the messages bf16(g / deg) in f32 and rounds to bf16;
LayerNorm takes its statistics and computes (x - mean) * (rstd * scale) +
bias in f32 and rounds once to bf16; lin_out, the loss and the parameters
stay f32.

It imports nothing of the program. The graph enters as the benchmark's own
CSR, the inputs and weights as the benchmark drew them. The aggregation is a
sparse CSR product (`torch.sparse`), so that no E x dim block of messages is
ever held; the graph is symmetric by construction (`graphgen.py`), so the
backward of the mean, A^T (g / deg), is A (g / deg). The dropout masks are
drawn as the program's Trainer draws them: a generator on the device seeded
with the run's seed + 1, one `torch.rand` of [N, dim] per layer and train
step, in layer order.

`precision` sets every dense product: "f32" exact (TF32 off), "tf32" with
both operands of each product (forward and backward) rounded to TF32's
10-bit mantissa, "fp8" with each operand scaled to its largest magnitude
and rounded to float8 e4m3. The two lower ones are the controls of the
comparison in `compare.py`.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.nn.functional as F

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
LN_EPS = 1e-5
FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties to even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x scaled so that its largest magnitude is e4m3's largest, rounded to
    float8 e4m3, and scaled back."""
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


ROUNDINGS = {"f32": None, "tf32": round_tf32, "fp8": round_fp8}


class _LowLinear(torch.autograd.Function):
    """y = q(x) @ q(w)^T, and both products of the backward on q-rounded
    operands: a dense product computed in a lower precision (f32
    accumulation, each result in its operand's dtype)."""

    @staticmethod
    def forward(ctx, x, w, q):
        ctx.save_for_backward(x, w)
        ctx.q = q
        return (q(x.float()) @ q(w.float()).t()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        q = ctx.q
        gq = q(g.float())
        return ((gq @ q(w.float())).to(x.dtype),
                (gq.t() @ q(x.float())).to(w.dtype), None)


class _MeanAgg(torch.autograd.Function):
    """y = D^-1 A x over the symmetric graph A (sparse CSR, ones), summed
    in f32; on bf16 rows as the module docstring says."""

    @staticmethod
    def forward(ctx, x, adj, inv_deg):
        ctx.adj, ctx.inv_deg = adj, inv_deg
        if x.dtype == torch.float32:
            return (adj @ x) * inv_deg[:, None]
        y = (adj @ x.float()).to(x.dtype)
        return y * inv_deg.to(x.dtype)[:, None]

    @staticmethod
    def backward(ctx, g):
        if g.dtype == torch.float32:
            return ctx.adj @ (g * ctx.inv_deg[:, None]), None, None
        m = (g.float() * ctx.inv_deg[:, None]).to(g.dtype)
        return (ctx.adj @ m.float()).to(g.dtype), None, None


def _layer_norm(h, weight, bias):
    """LayerNorm over the last axis: f32 statistics and arithmetic, one
    rounding to h's dtype."""
    if h.dtype == torch.float32:
        return F.layer_norm(h, (h.shape[1],), weight, bias, LN_EPS)
    x = h.float()
    var, mean = torch.var_mean(x, -1, unbiased=False, keepdim=True)
    return ((x - mean) * (torch.rsqrt(var + LN_EPS) * weight) + bias
            ).to(h.dtype)


def maxk(h: torch.Tensor, k: int) -> torch.Tensor:
    """h with all but the k largest entries of each row zeroed; ties keep
    the lowest channels (a stable sort)."""
    idx = torch.sort(h.detach(), dim=1, descending=True, stable=True
                     ).indices[:, :k]
    return torch.zeros_like(h).scatter(1, idx, h.gather(1, idx))


@dataclasses.dataclass
class Steps:
    """What the first steps give: each step's loss, each leaf's gradient
    norm at step 1, and each leaf's change over all the steps."""
    losses: list[float]
    grad_norms: dict[str, float]
    change_norms: dict[str, float]


def train_steps(indptr: torch.Tensor, indices: torch.Tensor, inputs,
                model: dict, dropout_seed: int, steps: int = 3,
                precision: str = "f32", dtype: str = "float32") -> Steps:
    """`steps` full-graph train steps of the SAGE-MaxK model of `model`
    (a configuration's "model" group) from `inputs` (features, labels,
    masks and weights on one device), at the compute dtype `dtype`."""
    q = ROUNDINGS[precision]
    cd = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    dev = inputs.features.device
    n = inputs.features.shape[0]
    deg = (indptr[1:] - indptr[:-1]).to(dev, torch.float32)
    inv_deg = 1.0 / deg.clamp(min=1.0)
    with warnings.catch_warnings():    # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        adj = torch.sparse_csr_tensor(
            indptr.to(dev, torch.int32), indices.to(dev, torch.int32),
            torch.ones(indices.shape[0], device=dev), size=(n, n),
            check_invariants=False)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inputs.weights.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in params.items()}
    p_drop, k = model["dropout"], model["maxk"]
    lr = model["w_lr"]
    gen = torch.Generator(device=dev).manual_seed(int(dropout_seed))
    train = inputs.masks[0]

    def linear(x, name, bias=True, dt=cd):
        """A dense layer computing in dt: input, weight and bias cast to
        it, the product rounded to it, the bias added in it."""
        x, w = x.to(dt), params[f"{name}.weight"].to(dt)
        y = F.linear(x, w) if q is None else _LowLinear.apply(x, w, q)
        return y + params[f"{name}.bias"].to(dt) if bias else y

    losses, grad_norms = [], {}
    b1, b2 = ADAM_BETAS
    for t in range(1, steps + 1):
        h = linear(inputs.features.to(cd), "lin_in")
        for i in range(model["hidden_layers"]):
            x = maxk(h, k)
            noise = torch.rand(x.shape, generator=gen, device=dev)
            x = torch.where(noise >= p_drop, x / (1.0 - p_drop),
                            torch.zeros_like(x))
            agg = _MeanAgg.apply(x, adj, inv_deg)
            h = (linear(x, f"layer{i}.fc_self")
                 + linear(agg, f"layer{i}.fc_neigh", bias=False))
            if model["norm"]:
                h = _layer_norm(h, params[f"layer{i}.norm.weight"],
                                params[f"layer{i}.norm.bias"])
        logits = linear(h, "lin_out", dt=torch.float32)
        per_node = F.cross_entropy(logits, inputs.labels, reduction="none")
        m = train.to(per_node.dtype)
        loss = (per_node * m).sum() / m.sum().clamp(min=1.0)
        del h, x, agg, logits, per_node
        loss.backward()
        losses.append(loss.item())
        with torch.no_grad():
            for name, p in params.items():
                g = p.grad
                if t == 1:
                    grad_norms[name] = float(torch.linalg.vector_norm(g))
                mu, nu = moments[name]
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (nu / (1.0 - b2 ** t)).sqrt_().add_(ADAM_EPS)
                p.addcdiv_(mu, denom, value=-lr / (1.0 - b1 ** t))
                p.grad = None
    change = {name: float(torch.linalg.vector_norm(p.detach() - start[name]))
              for name, p in params.items()}
    return Steps(losses, grad_norms, change)
