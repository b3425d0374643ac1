"""The numbers compared, and the judgement of a run by them.

From the program's first jobs and the reference's:

* ``loss_gap``: the largest relative gap of a job's loss;
* ``grad_gap``: model 0's first gradient as its optimizer got it, worst
  leaf: the gap between the program's norm of the leaf and the reference's,
  against the larger of the reference's norm of that leaf and of the median
  leaf;
* ``update_gap``: the same for each model's parameter change after the
  jobs, worst leaf over the models, leaving out a leaf whose first
  gradient in the reference is under a thousandth of the median leaf's
  (a leaf the loss does not reach moves by round-off alone);
* ``decode_gap``: over the checked jobs and their data chunks, the largest
  gap from 1 of a chunk's total decode weight in the view the coded step
  was fed (1 for each chunk is the decode that gives the full-batch
  gradient);
* ``grad_gap_median``: the median leaf's gap in place of the worst leaf's,
  steady from seed to seed, for a cell whose worst leaf reads noise;
* ``grad_gap_kind``: model 0's first gradient, each kind of leaf that every
  layer has (its path less the layer's index: ``layers.ssm.D``) read by the
  median of its layers' gaps, the worst kind.  A fault in one output of a
  kernel's backward moves that kind in every layer, where rounding moves a
  few layers' leaves.

A cell's limits (``cells/<cell>.json``) name the numbers it compares.
"""

from __future__ import annotations

import re
import statistics
from collections import defaultdict

NEGLIGIBLE = 1e-3
LAYER = re.compile(r"^layers\.\d+\.")


def leaf_gaps(own: dict, ref: dict, paths=None) -> list[float]:
    """Each leaf's gap between the two norms, against the larger of the
    reference's norm of the leaf and of the median leaf."""
    paths = list(ref) if paths is None else list(paths)
    median = statistics.median(ref[p] for p in paths)
    return [abs(own[p] - ref[p]) / max(ref[p], median) for p in paths]


def kind_gaps(gaps: dict[str, float]) -> dict[str, float]:
    """{kind: the median over the layers of its leaves' ``gaps``} for each
    kind of leaf that more than one layer has; a kind is a path less its
    layer index."""
    kinds = defaultdict(list)
    for p, g in gaps.items():
        if LAYER.match(p):
            kinds[LAYER.sub("layers.", p)].append(g)
    return {k: statistics.median(v) for k, v in kinds.items() if len(v) > 1}


def numbers(program: dict, reference: dict) -> dict[str, float]:
    """The compared numbers of a run; ``decode_gap`` only where the program's
    readings carry decode gaps."""
    losses = {j: abs(program["losses"][j] - ref) / abs(ref)
              for j, ref in reference["losses"].items()}
    ref0 = reference["grad_norms"][0]
    grads = dict(zip(ref0, leaf_gaps(program["grad_norms"][0], ref0)))
    out = {"loss_gap": max(losses.values()), "grad_gap": max(grads.values()),
           "grad_gap_median": statistics.median(grads.values())}
    kinds = kind_gaps(grads)
    if kinds:
        out["grad_gap_kind"] = max(kinds.values())
    updates = []
    for m, ref in reference["change_norms"].items():
        first = reference["grad_norms"][m]
        median = statistics.median(first.values())
        kept = [p for p in ref if first[p] >= NEGLIGIBLE * median]
        updates.append(max(leaf_gaps(program["change_norms"][m], ref, kept)))
    out["update_gap"] = max(updates)
    if program.get("decode_gaps"):
        out["decode_gap"] = max(program["decode_gaps"])
    return out


def judge(found: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and within its limit; a limit whose number is missing fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        value = found.get(name)
        table[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:  # NaN fails too
            ok = False
    return ok, table
