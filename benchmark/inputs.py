"""What `--seed` draws: the features, the labels with a planted signal, the
train / val / test split and the initial weights.

Everything is drawn on the run's device from one `torch.Generator` seeded
with `--seed`, in a few large calls, so that the same seed gives the same
inputs on the same device. The rule is the stand-in's: standard normal
features, uniform labels, class centroids (scale 2.5) added to the first 16
feature channels, a 60/20/20 split from one permutation. The weights follow
the model family's initialisation, which its model file states
(`models/<model>.py::weight_shapes`: names, shapes, initialisers and gains
in the order they are drawn): Xavier-uniform from one draw of them all,
zero biases, LayerNorm scale 1 and bias 0.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from benchmark import cells

CENTROID_DIMS = 16
CENTROID_SCALE = 2.5


@dataclasses.dataclass
class Inputs:
    features: torch.Tensor          # f32 [N, F]
    labels: torch.Tensor            # int64 [N]
    masks: tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # bool [N]
    weights: dict[str, torch.Tensor]

    def to(self, device) -> "Inputs":
        return Inputs(self.features.to(device), self.labels.to(device),
                      tuple(m.to(device) for m in self.masks),
                      {k: v.to(device) for k, v in self.weights.items()})


def draw(config: dict, seed: int, device) -> Inputs:
    """The inputs of one run of `config` from `seed`, on `device`."""
    ds, model = config["dataset"], config["model"]
    n, f, c = ds["num_nodes"], ds["num_features"], ds["num_classes"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    feat = torch.randn((n, f), generator=gen, device=device)
    labels = torch.randint(0, c, (n,), generator=gen, device=device)
    r = min(CENTROID_DIMS, f)
    mu = torch.randn((c, r), generator=gen, device=device) * CENTROID_SCALE
    feat[:, :r] += mu[labels]
    perm = torch.randperm(n, generator=gen, device=device)
    masks = []
    for lo, hi in ((0, int(0.6 * n)), (int(0.6 * n), int(0.8 * n)),
                   (int(0.8 * n), n)):
        m = torch.zeros(n, dtype=torch.bool, device=device)
        m[perm[lo:hi]] = True
        masks.append(m)
    shapes = cells.model_file(config).weight_shapes(model, f, c)
    u = torch.rand(sum(math.prod(shape) for _, shape, init, _ in shapes
                       if init == "xavier"), generator=gen, device=device)
    weights, at = {}, 0
    for name, shape, init, gain in shapes:
        if init == "xavier":
            fan_out, fan_in = shape
            a = gain * math.sqrt(6.0 / (fan_in + fan_out))
            size = math.prod(shape)
            weights[name] = (u[at:at + size].view(shape) * 2.0 - 1.0) * a
            at += size
        elif init == "ones":
            weights[name] = torch.ones(shape, device=device)
        else:
            weights[name] = torch.zeros(shape, device=device)
    return Inputs(feat, labels, tuple(masks), weights)
