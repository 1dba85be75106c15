"""The numbers that decide ``correct``, each against its limit.

Training: per leaf, the gap between the program's norm and the reference's, over the reference's
norm of that leaf or of the median leaf, whichever is larger; the worst leaf counts, or the median
one where a workload compares ``*_gap_median``. Elements whose
first gradient in the reference is under a thousandth of the median leaf's root mean square element
(round-off alone moves them under Adam) are left out of the change and the accumulated gradient.

Serving: for each compared voxel, how far the reference's logit of the served label lies below
the reference's best logit there, in units of the standard deviation of the reference's logits
over the compared voxels; the widest gap counts.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional

import torch

TINY_GRAD = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names: Iterable[str]) -> Optional[Dict[str, float]]:
    """Per leaf, |program's norm - reference's| over the larger of the reference's norm of that leaf and
    of the median leaf; None where the reference's norms are all 0."""
    names = [n for n in names if n in ref]
    if not names or max(ref[n] for n in names) == 0.0:
        return None
    median = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median) for n in names}


def kept_norms(tensors: Dict[str, torch.Tensor], keep: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per leaf, the norm over its kept elements (leaves with none kept are left out)."""
    return {n: float(tensors[n][k].norm()) for n, k in keep.items() if bool(k.any())}


def kept_elements(ref: dict) -> Dict[str, torch.Tensor]:
    """The elements of each leaf whose first gradient in the reference is at least a thousandth of the
    median leaf's root mean square element: the others (a key's bias under softmax, a norm's scale
    over one channel) are moved by round-off alone."""
    rms = [float(g.norm()) / g.numel() ** 0.5 for g in ref["grad_t"].values()]
    floor = TINY_GRAD * statistics.median(rms)
    return {n: g.abs() >= floor for n, g in ref["grad_t"].items()}


def _per_leaf(prog: dict, ref: dict) -> Dict[str, tuple]:
    keep = kept_elements(ref)
    return {key: (kept_norms(prog[f"{key}_t"], keep), kept_norms(ref[f"{key}_t"], keep))
            for key in ("change", "acc") if f"{key}_t" in prog}


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``loss_gap`` (worst call); ``grad_gap`` (first gradient), ``change_gap`` and ``acc_gap`` (kept
    elements, where the reference moved or accumulated anything; ``acc_gap`` where the program
    accumulates), each of the worst leaf and, as ``*_gap_median``, of the median leaf; and
    ``moved_leaves``: leaves that one side changed and the other did not."""
    numbers = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))}
    per_leaf = _per_leaf(prog, ref)
    for key, (p, r) in {"grad": (prog["grad"], ref["grad"]), **per_leaf}.items():
        gaps = leaf_gaps(p, r, r)
        if gaps is not None:
            numbers[f"{key}_gap"] = max(gaps.values())
            numbers[f"{key}_gap_median"] = statistics.median(gaps.values())
    p, r = per_leaf["change"]
    numbers["moved_leaves"] = float(sum((p[n] > 0) != (r[n] > 0) for n in r))
    return numbers


def worst_leaves(prog: dict, ref: dict) -> Dict[str, str]:
    """For each per-leaf number, the leaf that sets it (to read beside the numbers)."""
    pairs = {"grad": (prog["grad"], ref["grad"]), **_per_leaf(prog, ref)}
    out = {}
    for key, (p, r) in pairs.items():
        if r and max(r.values()) > 0:
            median = statistics.median(r.values())
            out[key] = max(r, key=lambda n: abs(p[n] - r[n]) / max(r[n], median))
    return out


def label_gap(ref_logits: torch.Tensor, labels: torch.Tensor) -> float:
    """Widest gap of the served ``labels`` (..., int) under the reference's best logit (..., classes),
    over the standard deviation of the reference's logits."""
    best = ref_logits.max(dim=-1).values
    served = torch.gather(ref_logits, -1, labels.long()[..., None])[..., 0]
    return float((best - served).max() / ref_logits.std())


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number that has a limit, with the limit; a number past its limit fails."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name)
        out[name] = {"value": value, "limit": limit, "ok": value is not None and value <= limit}
    return out


def lines(judged: Dict[str, dict]) -> List[str]:
    return [f"{name} {v['value']!r} limit {v['limit']!r} {'ok' if v['ok'] else 'FAIL'}" for name, v in judged.items()]
