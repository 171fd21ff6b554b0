"""The numbers that decide ``correct`` for a training cell.

Per-leaf norms are compared leaf by leaf: the gap between the program's
norm and the reference's, over the larger of the reference's norm of that
leaf and of the median leaf (some gradients are all but zero).  The worst
leaf is the number.  Leaves whose gradient in the reference is under a
thousandth of the median leaf's move under Adam by round-off alone and are
left out of the parameters' change.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

ROUNDOFF = 1e-3


def worst_leaf(prog: Dict[tuple, float], ref: Dict[tuple, float],
               keep: Optional[Iterable[tuple]] = None) -> Tuple[float, str]:
    """(gap, leaf) of the leaf whose norm departs most from the
    reference's."""
    med = statistics.median(ref.values())
    worst, where = 0.0, ''
    for p in (keep if keep is not None else ref):
        den = max(ref[p], med)
        gap = abs(prog[p] - ref[p]) / den if den > 0 else 0.0
        if gap > worst:
            worst, where = gap, '/'.join(map(str, p))
    return worst, where


def moving(ref_grad_norms: Dict[tuple, float]):
    """Leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref_grad_norms.values())
    return [p for p, v in ref_grad_norms.items() if v >= ROUNDOFF * med]


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a)


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every reading at or under its
    limit; a reading that is not a number fails."""
    rows = []
    ok = True
    for name in limits:
        v = readings.get(name)
        lim = float(limits[name])
        good = v is not None and v == v and v <= lim
        ok = ok and good
        rows.append((name, v, lim))
    return ok, rows
