"""The numbers that decide ``correct``, program against reference.

Training (the first ``check_steps`` steps of the set-up, which the window's
own call ran):

- ``loss1_gap`` and ``loss_gap``: the relative gap of the first step's
  loss, and the largest of any step's;
- ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first step's gradient (the program's from
  its optimizer's first moments), over the larger of that leaf's reference
  norm and the median leaf's;
- ``change_gap``: the same of the weights' change over the checked steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf with no gradient moves by round-off and weight
  decay alone); ``change_median_gap``: the relative gap of the change of
  the median one of those leaves (by the reference's change);
  ``grad_color_gap``: ``grad_gap`` over the colour nets' leaves alone,
  which neither a last sample's density nor the priors' discrete choices
  reach;
- ``table_row_gap`` and ``table_row_p90_gap``: the table's first gradient
  row by row (a row is the table's first axis), each row's norm gap over
  the larger of its reference norm and the median touched row's, the
  median and the 90th percentile over the rows either side touched. A
  ray whose gradient explodes touches a few hundred rows, so these hold
  the table's gradient where ``grad_gap`` cannot (see ``PERF.md``).

A cell's ``limits/<cell>.json`` names the numbers it is held to.

Serving (a seeded sample of the window's finished requests, rendered again
by the reference): see ``serve_numbers``.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from nerfbench.reference.spec import FAR


def _median(vals) -> float:
    return float(np.median(np.asarray(list(vals), np.float64)))


def _norm_gap(prog: Dict[str, float], ref: Dict[str, float], leaves,
              label: str = "") -> float:
    med = _median(ref.values())
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves}
    if label:
        for k in sorted(gaps, key=gaps.get)[-3:]:
            print(f"detail {label} {k} program {prog[k]!r} reference {ref[k]!r} "
                  f"median {med!r}", file=sys.stderr)
    return max(gaps.values()) if gaps else 0.0


def row_gaps(prog_rows: np.ndarray, ref_rows: np.ndarray) -> Dict[str, float]:
    """Median and 90th percentile of the per-row norm gaps of the table's
    gradient (``table_row_gap``, ``table_row_p90_gap``)."""
    prog_rows = np.asarray(prog_rows, np.float64)
    ref_rows = np.asarray(ref_rows, np.float64)
    touched = (prog_rows > 0) | (ref_rows > 0)
    if not touched.any():
        return {"table_row_gap": float("inf"), "table_row_p90_gap": float("inf")}
    p, r = prog_rows[touched], ref_rows[touched]
    med = float(np.median(r))
    gaps = np.abs(p - r) / np.maximum(np.maximum(r, med), 1e-30)
    return {"table_row_gap": float(np.median(gaps)),
            "table_row_p90_gap": float(np.quantile(gaps, 0.9))}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["losses"], ref["losses"])]
    g_med = _median(ref["grad_norms"].values())
    moving = [k for k, v in ref["grad_norms"].items() if v >= 1e-3 * g_med]
    ch, gr = ref["change_norms"], ref["grad_norms"]
    mid = sorted(moving, key=ch.get)[len(moving) // 2]
    out = row_gaps(prog["table_rows"], ref["table_rows"])
    out.update({"loss1_gap": losses[0], "loss_gap": max(losses),
            "grad_gap": _norm_gap(prog["grad_norms"], ref["grad_norms"],
                                  list(ref["grad_norms"]), "grad"),
            "grad_color_gap": _norm_gap(prog["grad_norms"], ref["grad_norms"],
                                        [k for k in gr if ".color_net." in k]),
            "change_gap": _norm_gap(prog["change_norms"], ch, moving, "change"),
            "change_median_gap": abs(prog["change_norms"][mid] - ch[mid])
            / max(ch[mid], 1e-30)})
    return out


QUANTILES = {"p50": 0.5, "p99": 0.99, "p999": 0.999}


def serve_numbers(prog: List[Dict], ref: List[Dict]) -> Dict[str, float]:
    """Per-pixel gaps of each sampled request, at the quantiles of
    ``QUANTILES`` over the frame, the worst request's: of the rgb gap
    (largest channel) and of the depth gap (over the far bound), e.g.
    ``rgb_p999_gap``. Not the largest gap: a sample point within rounding
    of a block face of the block-hash grid takes the other tile's features
    (the encode is not continuous across faces), so ~50 of a request's
    640,000 rays (8e-5 of the frame) differ by up to the whole pixel on
    sound runs; a high quantile leaves them out and still sees a fault in
    any region larger than the quantile's tail (a short tile is 18% of
    the frame). The worst request's, so that one wrong answer among right
    ones fails."""
    names = [f"{m}_{q}_gap" for m in ("rgb", "depth") for q in QUANTILES]
    if len(prog) != len(ref) or not prog:
        return {k: float("inf") for k in names}
    out = {k: 0.0 for k in names}
    for p, r in zip(prog, ref):
        gaps = {"rgb": np.abs(p["rgb_map"] - r["rgb"]).max(-1).ravel(),
                "depth": np.abs(p["depth_map"] - r["depth"]).ravel() / FAR}
        for m, g in gaps.items():
            for q, f in QUANTILES.items():
                out[f"{m}_{q}_gap"] = max(out[f"{m}_{q}_gap"],
                                          float(np.quantile(g, f)))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a missing or non-finite number
    fails)."""
    return all(k in numbers and np.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())
