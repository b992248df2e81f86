"""The comparison that decides `correct`: the program's readings of its
first three steps against the reference's, each number beside its
limit.

The readings (`hosbench/reference/train.py::run_steps` and the program's
own, `harness.run`): each step's loss, each parameter's gradient norm as
Adam received it at the first step, and each parameter's change over the
three steps. The numbers, of which a configuration's `limits` name the
compared ones:

  loss_gap     the largest |L_p - L_r| / |L_r| over the steps
  loss0_gap    the same at the first step alone
  dloss_gap    the largest |(L_p,i - L_p,0) - (L_r,i - L_r,0)| /
               |L_r,i - L_r,0| over the later steps: how far the updates
               moved the loss, against the reference's move
  grad_gap     the worst parameter's | |g_p| - |g_r| | / max(|g_r|, the
               median parameter's |g_r|)
  grad_gap_median   the median parameter's of the same
  grad_cos_median   the median parameter's 1 - cos(g_p, g_r) of the first
               gradients (a direction: blind to a common scale; a missing
               gradient reads 1), where both sides' vectors are at hand
  change_gap, change_gap_median   the same of the parameters' change,
               over the parameters whose reference gradient is at least
               `floor` x the median's (the others move by round-off
               alone under Adam)
  grad_cos_image   the median parameter's 1 - cos of the first gradients
               over the moved parameters whose reference gradient the
               image losses carry: the other terms' share of it
               (`other_share`, where the reference reads one) under
               `IMAGE_SHARE`
  change_gap_image   the worst parameter's change gap over the same
"""

from __future__ import annotations

from typing import Dict

import numpy as np

NUMBERS = ("loss_gap", "loss0_gap", "dloss_gap", "grad_gap",
           "grad_gap_median", "grad_cos_median",
           "change_gap", "change_gap_median", "grad_cos_image",
           "change_gap_image")
IMAGE_SHARE = 0.1


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys):
    med = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med)
            for k in keys}


def cos_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """1 - cos of each parameter's first gradient, program against
    reference (1 where the program has none or it is zero)."""
    out = {}
    for k, r in ref.items():
        p = prog.get(k)
        if p is None:
            out[k] = 1.0
            continue
        p, r = p.double().reshape(-1), r.double().reshape(-1)
        den = float(p.norm() * r.norm())
        out[k] = 1.0 - float(p @ r) / den if den > 0 else 1.0
    return out


def gaps(prog: dict, ref: dict, floor: float = 1e-3) -> Dict[str, object]:
    lp, lr = prog["losses"], ref["losses"]
    loss = [abs(a - b) / abs(b) for a, b in zip(lp, lr)]
    dloss = [abs((lp[i] - lp[0]) - (lr[i] - lr[0])) / abs(lr[i] - lr[0])
             for i in range(1, len(lr))]
    rg = ref["grad_norms"]
    g = _leaf_gaps(prog["grad_norms"], rg, list(rg))
    for k, v in prog["grad_norms"].items():
        if k not in rg and v > 0:     # a gradient the reference has not
            g[k] = float("inf")
    med_g = float(np.median(list(rg.values())))
    moved = [k for k, v in rg.items() if v >= floor * med_g]
    c = _leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    worst_g = max(g, key=g.get)
    worst_c = max(c, key=c.get)
    cos = (cos_gaps(prog["grads"], ref["grads"])
           if "grads" in prog and "grads" in ref else None)
    share = ref.get("other_share")
    image = ([k for k in moved if share[k] < IMAGE_SHARE] if share
             else [])
    return {"grad_cos_median": (float(np.median(list(cos.values())))
                                if cos else float("nan")),
            "loss_gap": max(loss), "loss0_gap": loss[0],
            "dloss_gap": max(dloss),
            "grad_gap": g[worst_g], "grad_leaf": worst_g,
            "grad_gap_median": float(np.median(list(g.values()))),
            "change_gap": c[worst_c], "change_leaf": worst_c,
            "change_gap_median": float(np.median(list(c.values()))),
            "grad_cos_image": (float(np.median([cos[k] for k in image]))
                               if image and cos else float("nan")),
            "change_gap_image": (max(c[k] for k in image) if image
                                 else float("nan")),
            "leaves_moved": len(moved), "leaves_image": len(image),
            "leaves": len(rg)}
