"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's (``reference.train``) on the same
dataset, partition, weights, seeds and dropout generator.

Numbers compared, each against its cell's limit (``checks/<cell>.json``):

* ``loss1``: the first step's loss, |program - reference| over
  |reference|;
* ``grad1``: the first gradient as the optimizer gets it (clipped), by the
  worst leaf: the gap between the program's and the reference's norms of
  the leaf over the larger of the reference's norm of that leaf and of the
  median leaf;
* ``change1``: the parameters' change after the first step, by the median
  leaf, each leaf's gap measured as ``grad1``'s.  AdamW's first step is
  about lr * sign(g) in every element, so rounding barely moves its norm;
  a missing, doubled or mis-scaled update does.

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's (nought to rounding, so moved by round-off alone under Adam)
are left out of the change.  The later steps' losses and the change after
three steps by the worst leaf are read too (``loss2``, ``loss3``,
``change3``) but not compared: AdamW turns a rounding-level gap in a
gradient element near zero into a whole step of the opposite sign, and
such elements make those numbers swing from seed to seed by three orders
(PERF.md gives the look and the readings).
"""
from __future__ import annotations

import math
import statistics

NUMBERS = ("loss1", "grad1", "change1")
QUIET_LEAF = 1e-3


def _gaps(prog: dict, ref: dict, leaves) -> list:
    med = statistics.median(ref.values())
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves]


def readings(prog: dict, ref: dict) -> dict:
    """{number: reading} of a program run against the reference's: the
    compared numbers and the read-only ones."""
    out = {}
    for k, (lp, lr) in enumerate(zip(prog["losses"], ref["losses"])):
        out[f"loss{k + 1}"] = abs(lp - lr) / abs(lr)
    g_ref = ref["grad_norms"]
    out["grad1"] = max(_gaps(prog["grad_norms"], g_ref, g_ref))
    med = statistics.median(g_ref.values())
    moving = [k for k, v in g_ref.items() if v >= QUIET_LEAF * med]
    out["change1"] = statistics.median(_gaps(
        prog["change1_norms"], ref["change1_norms"], moving))
    last = f"change{len(ref['losses'])}_norms"
    out["change3"] = max(_gaps(prog[last], ref[last], moving))
    return out


def judge(read: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: [reading, limit]}): correct when every compared
    number is finite and within its limit."""
    table = {k: [read[k], limits[k]] for k in NUMBERS}
    ok = all(math.isfinite(v) and v <= lim for v, lim in table.values())
    return ok, table
