"""The comparisons that decide `correct`: the numbers a run compares with
the plain reference, and each beside its limit.

Train cells (the program's first steps against the reference's):
  loss_gap   the largest |loss - reference loss| / |reference loss| over the
             steps;
  grad_gap   for the median parameter: |norm of the first gradient as the
             optimizer got it - the reference's| / max(the reference's
             norm, the median parameter's). By the worst parameter this
             gap reads a few tenths in sound bf16 runs (BN scales and
             shifts of the first stages and the stem's weight, whose
             gradients are sums that nearly cancel), so the median
             parameter's, steady from seed to seed, is the one compared;
  delta_gap  the same for each parameter's change over the steps, over the
             parameters whose reference gradient is not nought to rounding
             (a norm under a thousandth of the median parameter's: such a
             parameter moves under Adam by round-off alone).
Serve cell (sampled served requests against the reference's scores):
  sim_gap    the widest |served similarity - reference similarity| of a
             returned class;
  sim_mean   the mean of the same gaps over the sample's returned classes;
  unanswered the sampled requests that got no result (an exact count).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

NOUGHT = 1e-3  # of the median parameter's gradient norm


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys):
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog / ref: {"loss": [..], "grad": {name: norm}, "delta": {..}}."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        raise ValueError("the program and the reference took different "
                         "numbers of steps")
    if set(prog["grad"]) != set(ref["grad"]):
        raise ValueError(f"parameters differ: "
                         f"{sorted(set(prog['grad']) ^ set(ref['grad']))}")
    med = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= NOUGHT * med]
    return {"loss_gap": loss,
            "grad_gap": statistics.median(_gaps(prog["grad"], ref["grad"],
                                                ref["grad"])),
            "delta_gap": max(_gaps(prog["delta"], ref["delta"], moved))}


def leaf_gaps(prog: dict, ref: dict, key: str):
    """[(gap, name, program norm, reference norm)] of every parameter for
    `key` ("grad" or "delta"), the widest first."""
    med = statistics.median(ref[key].values())
    return sorted(((abs(prog[key][k] - ref[key][k]) / max(ref[key][k], med,
                                                          1e-30),
                    k, prog[key][k], ref[key][k]) for k in ref[key]),
                  reverse=True)


def serve_numbers(served: List[dict], ref_sims) -> Dict[str, float]:
    """served: per sampled request its [(class index, similarity)] top-k in
    served order; ref_sims: per request the reference's similarity to every
    class (a sequence of floats)."""
    gaps = [abs(s - float(sims[c]))
            for topk, sims in zip(served, ref_sims) for c, s in topk]
    return {"sim_gap": max(gaps, default=0.0),
            "sim_mean": sum(gaps) / len(gaps) if gaps else 0.0}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """-> (correct, {name: {"value", "limit"}}): every number at or under
    its limit; a number that is missing or not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
