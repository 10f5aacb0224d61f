"""The comparison that decides `correct`.

The program's first steps and the reference's (`reference.Steps`) give
three numbers, each against a limit of the cell's own (`limits/<cell>.json`):

- `loss_gap`: the largest |program - reference| / |reference| of the
  losses of the compared steps;
- `grad_gap`: the first gradient, as the optimizer got it, by the worst
  leaf: |‖g‖ - ‖g_ref‖| over the larger of ‖g_ref‖ and the median leaf's
  ‖g_ref‖;
- `change_gap`: the parameters' change over the compared steps, by the
  worst leaf, measured the same way. Leaves whose reference gradient is
  under a thousandth of the median leaf's move by round-off alone under
  Adam, and are left out of it.

A reading that is not finite fails.
"""
from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "grad_gap", "change_gap")
QUIET_LEAF = 1e-3


def _worst_leaf(prog: dict[str, float], ref: dict[str, float],
                leaves) -> float:
    floor = statistics.median(ref[k] for k in ref)
    worst = 0.0
    for k in leaves:
        gap = abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor, 1e-30)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def readings(prog, ref) -> dict[str, float]:
    """The three numbers of `prog` against `ref` (both reference.Steps)."""
    loss = max((abs(p - r) / max(abs(r), 1e-30)
                for p, r in zip(prog.losses, ref.losses)), default=math.inf)
    if len(prog.losses) != len(ref.losses) or not math.isfinite(loss):
        loss = math.inf
    gfloor = statistics.median(ref.grad_norms.values())
    moving = [k for k, v in ref.grad_norms.items() if v >= QUIET_LEAF * gfloor]
    return {"loss_gap": loss,
            "grad_gap": _worst_leaf(prog.grad_norms, ref.grad_norms,
                                    ref.grad_norms),
            "change_gap": _worst_leaf(prog.change_norms, ref.change_norms,
                                      moving)}


def judge(values: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict[str, dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and finite."""
    checks = {name: {"value": values[name], "limit": limits[name]}
              for name in NAMES}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
