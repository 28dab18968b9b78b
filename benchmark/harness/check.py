"""The comparison that decides ``correct``.

Both sides give the same readings of the first steps of training, from
the same weights and batches: each step's loss, each leaf's first
gradient (the program's worked out from AdamW's first moment after one
step, m = (1 − β1)·g) and each leaf's change over the steps.  From them:

  loss_gap           the worst step's |loss − ref| / |ref|
  loss1_gap          the same of the first step alone
  grad_gap           the worst leaf's |‖g‖ − ‖g_ref‖| / max(‖g_ref‖,
                     the median leaf's ‖g_ref‖)
  grad_median_gap    the median leaf's of the same
  change_gap         the worst leaf's gap of ‖p − p0‖, over the leaves
                     whose reference gradient is at least a thousandth of
                     the median leaf's (a leaf whose gradient is nought to
                     rounding moves under Adam by round-off alone)
  change_median_gap  the median leaf's of the same

A cell's file names the numbers it compares, each with its limit (a
limit of ``null``, for a cell whose limits are not set yet, makes no run
correct); every number is printed.  No loss of the measured window may
be other than finite.
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "grad_median_gap",
           "change_gap", "change_median_gap")
QUIET_LEAF = 1e-3


def _gaps(prog: dict, ref: dict, names) -> dict[str, float]:
    median = statistics.median(ref[n] for n in names)
    return {n: (abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
                if n in prog else math.inf) for n in names}


def _worst(gaps: dict) -> tuple[float, str | None]:
    worst, at = 0.0, None
    for n, gap in gaps.items():
        if not gap <= worst:  # a NaN is the worst
            worst, at = gap, n
    return worst, at


def _median(gaps: dict) -> float:
    values = list(gaps.values())
    return math.nan if any(v != v for v in values) else statistics.median(
        values)


def readings(prog: dict, ref: dict) -> dict:
    """Every number of the module docstring, and where each worst lies."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        missing = sorted(set(ref["grad_norms"]) ^ set(prog["grad_norms"]))
        raise ValueError(f"the two sides hold different leaves: "
                         f"{missing[:5]}")
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                  ref["losses"])]
    g_ref = ref["grad_norms"]
    grads = _gaps(prog["grad_norms"], g_ref, list(g_ref))
    g_med = statistics.median(g_ref.values())
    quiet = sorted(n for n, g in g_ref.items() if g < QUIET_LEAF * g_med)
    moved = [n for n in g_ref if n not in quiet]
    changes = _gaps(prog["change_norms"],
                    {n: ref["change_norms"][n] for n in moved}, moved)
    grad_gap, grad_at = _worst(grads)
    change_gap, change_at = _worst(changes)
    loss_gap, loss_at = _worst(dict(enumerate(losses, 1)))
    return {"values": {"loss_gap": loss_gap, "loss1_gap": losses[0],
                       "grad_gap": grad_gap,
                       "grad_median_gap": _median(grads),
                       "change_gap": change_gap,
                       "change_median_gap": _median(changes)},
            "worst": {"loss_step": loss_at, "grad_leaf": grad_at,
                      "change_leaf": change_at},
            "quiet_leaves": quiet}


def compare(prog: dict, ref: dict, limits: dict) -> dict:
    """The numbers ``limits`` names, each with its limit, and ``correct``;
    every reading beside them."""
    got = readings(prog, ref)
    checks = {name: {"value": got["values"][name], "limit": limit}
              for name, limit in limits.items()}
    checks["nonfinite_losses"] = {"value": prog["nonfinite_losses"],
                                  "limit": 0}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    return {"correct": correct, "checks": checks, **got}


def check_lines(checks: dict) -> list[str]:
    """One plain line a number: its name, its value and its limit."""
    return [f"check {name}: {c['value']!r} limit {c['limit']!r}"
            for name, c in checks.items()]
