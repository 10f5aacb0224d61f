"""Rows that stress MaxK's select and the CBSR compaction.

`family_rows` makes one small block of rows per family, from a seeded
generator: rows where more than 32 keys share the pivot's high bits, rows of
one repeated value, integer rows, zero and signed-zero rows, subnormal rows,
rows with infinities, and rows with exactly k, k - 1, k / 2 and one nonzero.
`with_families` writes them over every `every`-th row of an input, and
`seeded_rows` makes the MaxK input of `chip_smoke.py` and
`utils/maxk_sweep.py` with them.
"""
from __future__ import annotations

import torch


def family_rows(dim: int, k: int, gen: torch.Generator,
                device: torch.device | str = "cpu"
                ) -> dict[str, torch.Tensor]:
    """Family name -> f32 rows [m, dim] (k: the MaxK k the rows are for)."""
    def perm():
        return torch.randperm(dim, generator=gen, device=device).double()

    def rand():
        return torch.rand(dim, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             device=device).float()

    def some(m):
        return perm()[:m].long()

    zero = torch.zeros(dim, device=device)
    f = {}
    # more than 32 keys share the high bits of the pivot: 1 + j * 2^-20 (the
    # bits below the exponent), the same negated, 1 + j * 2^-7 (distinct in
    # bf16 too), and 1 + j * 2^-20 on half of the channels over 0.5
    f["shared_prefix"] = torch.stack([
        1 + perm() * 2.0 ** -20, -(1 + perm() * 2.0 ** -20),
        1 + perm() * 2.0 ** -7,
        torch.where(rand() < 0.5, 1 + perm() * 2.0 ** -20, 0.5)]).float()
    few = zero.clone()
    few[some(max(k // 2, 1))] = 3.0
    f["repeated"] = torch.stack([
        zero + 2.5, torch.where(rand() < 0.5, -1.25, 0.0), few])
    f["integer"] = ints(-3, 4, 3, dim)
    f["zeros"] = torch.stack([zero, -zero,
                              torch.where(rand() < 0.5, 0.0, -0.0)])
    # subnormals: multiples of 2^-149 (f32's least) and of 2^-133 (bf16's),
    # and the latter with -0.0
    sub = ints(-20, 21, 3, dim)
    sub[0] *= 2.0 ** -149
    sub[1:] *= 2.0 ** -133
    sub[2] = torch.where(rand() < 0.5, sub[2], -0.0)
    f["subnormal"] = sub
    inf = randn(3, dim)
    inf[0, some(3)] = float("inf")
    inf[1, some(5)] = float("-inf")
    inf[2] = torch.where(rand() < 0.5, float("inf"), float("-inf"))
    f["inf"] = inf
    nz = torch.zeros(4, dim, device=device)
    for r, m in enumerate((k, k - 1, k // 2, 1)):
        if m > 0:
            nz[r, some(m)] = randn(m)
    f["few_nonzeros"] = nz
    return f


def with_families(x: torch.Tensor, k: int, gen: torch.Generator,
                  every: int) -> torch.Tensor:
    """x (f32 [N, dim]) with row r taken from the families of
    `family_rows` for every r divisible by `every`, in turn; returns x."""
    rows = torch.cat(list(family_rows(x.shape[1], k, gen,
                                      x.device).values()))
    at = torch.arange(0, x.shape[0], every, device=x.device)
    x[at] = rows[torch.arange(at.numel(), device=x.device) % rows.shape[0]]
    return x


def seeded_rows(n: int, dim: int, k: int, gen: torch.Generator
                ) -> torch.Tensor:
    """Random normal f32 rows [n, dim] on gen's device, tie- and edge-heavy:
    every 97th row of integers, every 1009th of zeros, every 89th from the
    families."""
    x = torch.randn((n, dim), generator=gen, device=gen.device)
    x[::97] = x[::97].round()
    x[::1009] = 0.0
    return with_families(x, k, gen, 89)
