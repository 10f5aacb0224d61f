"""The plain reference: a MaxK-GNN model trained full-graph, in plain
PyTorch, for the first steps of a run.

This file keeps what every model family shares; the family's own forward
pass, from the features to the logits, is its model file's `forward(net,
features, model)` (`models/<model>.py`, found by `cells.model_file`),
which builds on the pieces of `Net`: the dense layer at the compute dtype
and precision, MaxK (the k largest entries of each row kept, ties to the
lowest channel), inverted dropout, LayerNorm, and the graph as its
product A x (`CSR`) with its degrees. `train_steps` runs that forward, the
cross-entropy averaged over the training rows, and Adam (betas 0.9 /
0.999, eps 1e-8, no weight decay).

`dtype` is the traffic's compute dtype. "float32" computes every
activation in f32. "bfloat16" is the 16-bit model as the configuration
states it (flax's mixed precision, which the port follows): the features
cast to bf16; every hidden dense layer casts its input, weight and bias to
bf16 and rounds its product to bf16; MaxK and dropout act on the bf16 rows;
LayerNorm takes its statistics and computes (x - mean) * (rstd * scale) +
bias in f32 and rounds once to bf16; lin_out, the loss and the parameters
stay f32. Each model file states its aggregation's bf16 rule.

It imports nothing of the program. The graph enters as the benchmark's own
CSR, the inputs and weights as the benchmark drew them. The aggregation's
product A x (`CSR`) gathers the rows of x edge by edge in blocks of rows,
so that no E x dim block of messages is ever held, and sums each row's
messages in f32 in the CSR's order (`torch.segment_reduce`), so that the
same inputs give the same bits on every run; cuSPARSE's product
(`torch.sparse`), which it replaces, did not on the card, and one run in
a few of the same seed then read a gap at the control's level. The graph
is symmetric by construction (`graphgen.py`, and its self-loops transform
keeps it so), so the backward of A x is A g. The dropout masks are drawn as the program's Trainer draws them: a generator on
the device seeded with the run's seed + 1, one `torch.rand` of [N, dim] per
dropout and train step, in the order the forward meets them.

`precision` sets every dense product: "f32" exact (TF32 off), "tf32" with
both operands of each product (forward and backward) rounded to TF32's
10-bit mantissa, "fp8" with each operand scaled to its largest magnitude
and rounded to float8 e4m3. The two lower ones are the controls of the
comparison in `compare.py`.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
LN_EPS = 1e-5
FP8_MAX = 448.0
# edges whose rows a product gathers at once: 2 GiB of f32 rows of 256
EDGE_BLOCK = 1 << 21


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


class CSR:
    """The product A x over a CSR graph of ones (row = destination), in
    blocks of about EDGE_BLOCK edges: the block's source rows gathered,
    then each destination's sum by `torch.segment_reduce`, one sequential
    sum an output element, the same bits on every run."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor):
        ptr = indptr.to("cpu", torch.int64)
        self.n = ptr.shape[0] - 1
        self.indices = indices.long()
        self.lengths = (indptr[1:] - indptr[:-1]).long()
        cuts = torch.searchsorted(ptr, torch.arange(0, int(ptr[-1]),
                                                    EDGE_BLOCK))
        rows = sorted(set(cuts.tolist()) | {0, self.n})
        self.blocks = [(r0, r1, int(ptr[r0]), int(ptr[r1]))
                       for r0, r1 in zip(rows[:-1], rows[1:]) if r1 > r0]

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty((self.n, x.shape[1]), dtype=x.dtype,
                          device=x.device)
        for r0, r1, e0, e1 in self.blocks:
            out[r0:r1] = torch.segment_reduce(
                x.index_select(0, self.indices[e0:e1]), "sum",
                lengths=self.lengths[r0:r1], axis=0, unsafe=True)
        return out


@dataclasses.dataclass
class Steps:
    """What the first steps give: each step's loss, each leaf's gradient
    norm at step 1, and each leaf's change over all the steps."""
    losses: list[float]
    grad_norms: dict[str, float]
    change_norms: dict[str, float]


class Net:
    """The pieces a model file's forward builds on, for one run of the
    reference: its parameters, the graph, the compute dtype, the precision
    of its dense products and its dropout generator."""

    def __init__(self, params: dict[str, torch.Tensor], adj: CSR,
                 deg: torch.Tensor, model: dict, dtype: torch.dtype, q,
                 gen: torch.Generator):
        self.params = params
        self.adj = adj          # CSR: adj @ x is A x
        self.deg = deg          # f32 [N] degrees, not clamped
        self.dtype = dtype      # the hidden stack's compute dtype
        self.k = model["maxk"]
        self.p_drop = model["dropout"]
        self._q = q
        self._gen = gen

    def linear(self, x, name: str, bias: bool = True, dt=None):
        """The dense layer `name` computing in dt (default the compute
        dtype): input, weight and bias cast to it, the product rounded to
        it, the bias added in it."""
        dt = self.dtype if dt is None else dt
        x, w = x.to(dt), self.params[f"{name}.weight"].to(dt)
        y = F.linear(x, w) if self._q is None else _LowLinear.apply(x, w,
                                                                    self._q)
        return y + self.params[f"{name}.bias"].to(dt) if bias else y

    def maxk(self, h: torch.Tensor) -> torch.Tensor:
        return maxk(h, self.k)

    def dropout(self, x: torch.Tensor) -> torch.Tensor:
        """Inverted dropout with the next [N, dim] draw of the run's
        generator."""
        noise = torch.rand(x.shape, generator=self._gen, device=x.device)
        return torch.where(noise >= self.p_drop, x / (1.0 - self.p_drop),
                           torch.zeros_like(x))

    def layer_norm(self, h: torch.Tensor, name: str) -> torch.Tensor:
        return _layer_norm(h, self.params[f"{name}.weight"],
                           self.params[f"{name}.bias"])


def train_steps(indptr: torch.Tensor, indices: torch.Tensor, inputs,
                model: dict, dropout_seed: int, model_file, steps: int = 3,
                precision: str = "f32", dtype: str = "float32") -> Steps:
    """`steps` full-graph train steps of the model of `model` (a
    configuration's "model" group), whose forward is `model_file.forward`,
    from `inputs` (features, labels, masks and weights on one device), at
    the compute dtype `dtype`."""
    cd = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    dev = inputs.features.device
    deg = (indptr[1:] - indptr[:-1]).to(dev, torch.float32)
    adj = CSR(indptr.to(dev), indices.to(dev))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inputs.weights.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in params.items()}
    lr = model["w_lr"]
    net = Net(params, adj, deg, model, cd, ROUNDINGS[precision],
              torch.Generator(device=dev).manual_seed(int(dropout_seed)))
    train = inputs.masks[0]

    losses, grad_norms = [], {}
    b1, b2 = ADAM_BETAS
    for t in range(1, steps + 1):
        logits = model_file.forward(net, inputs.features, model)
        per_node = F.cross_entropy(logits, inputs.labels, reduction="none")
        m = train.to(per_node.dtype)
        loss = (per_node * m).sum() / m.sum().clamp(min=1.0)
        del logits, per_node
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
