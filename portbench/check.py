"""The numbers that decide ``correct``, and their verdict against the limits.

Training (``train_numbers``), from what the program's first steps produced and
what the reference's steps from the same weights and batches produced:

- ``loss_gap``: the largest |loss - reference loss| / |reference loss| over
  the steps compared;
- ``grad_gap``: the worst leaf's gap between the norms of the first step's
  gradient as the optimizer got it, |‖g‖ - ‖g_ref‖|, over the larger of
  ‖g_ref‖ and the median leaf's ‖g_ref‖ in its model;
- ``change_gap``: the same of each leaf's change over the steps compared
  (encoder, predictor and target encoder), leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's in its model
  (a target-encoder leaf goes with its encoder leaf): round-off alone moves
  those under Adam.

A leaf that one side lacks reads infinitely far off. Extraction
(``embed_numbers``): ``embed_gap``, the worst clip's ‖e - e_ref‖ / ‖e_ref‖
over every embedding the window returned, and ``missing_answers``, the rows
that never came or are not finite.
"""

from __future__ import annotations

import math

import numpy as np

SMALL_GRAD = 1e-3  # a leaf whose reference gradient is under this share of the median


def _model(leaf: str) -> str:
    return leaf.split(".", 1)[0]


def _medians(ref: dict) -> dict:
    groups: dict[str, list] = {}
    for leaf, v in ref.items():
        groups.setdefault(_model(leaf), []).append(v)
    return {m: float(np.median(v)) for m, v in groups.items()}


def worst_leaf(prog: dict, ref: dict, leaves=None) -> tuple[float, str]:
    """(the largest gap of norms over ``leaves`` (default: every leaf of
    either side), the leaf)."""
    med = _medians(ref)
    worst, at = 0.0, ""
    for leaf in sorted(set(prog) | set(ref) if leaves is None else leaves):
        if leaf not in prog or leaf not in ref:
            return math.inf, leaf
        gap = abs(prog[leaf] - ref[leaf]) / max(ref[leaf], med[_model(leaf)], 1e-30)
        if not gap <= worst:  # NaN is worst
            worst, at = gap, leaf
    return worst, at


def small_grad_leaves(ref_grad: dict) -> set:
    med = _medians(ref_grad)
    return {leaf for leaf, v in ref_grad.items() if v < SMALL_GRAD * med[_model(leaf)]}


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [...], "grad": {leaf: norm}, "change": {leaf: norm}}."""
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
        loss_gap = loss_gap if loss_gap == loss_gap else math.inf
    small = small_grad_leaves(ref["grad"])
    kept = [leaf for leaf in set(prog["change"]) | set(ref["change"])
            if leaf.replace("target_encoder.", "encoder.", 1) not in small]
    grad_gap, grad_leaf = worst_leaf(prog["grad"], ref["grad"])
    change_gap, change_leaf = worst_leaf(prog["change"], ref["change"], kept)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "_where": {"grad_gap": grad_leaf, "change_gap": change_leaf,
                       "left_out": sorted(small)}}


def embed_numbers(outputs: list, refs: dict, batch: int) -> dict:
    """outputs: (batch id, [rows, D] array) of every call; refs: batch id ->
    the reference's [batch, D] embeddings."""
    worst, missing = 0.0, 0
    for k, out in outputs:
        out = np.asarray(out, np.float64)
        ref = np.asarray(refs[k], np.float64)
        rows = min(len(out), batch)
        missing += batch - rows
        ok = np.isfinite(out[:rows]).all(1)
        missing += int((~ok).sum())
        if rows:
            gap = np.linalg.norm(out[:rows] - ref[:rows], axis=1) / np.linalg.norm(ref[:rows],
                                                                                   axis=1)
            gap = gap[ok]
            if gap.size:
                worst = max(worst, float(gap.max()))
    return {"embed_gap": worst, "missing_answers": missing}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value": v, "limit": l}}) over the limited numbers."""
    checks = {}
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        checks[name] = {"value": value, "limit": limit}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
