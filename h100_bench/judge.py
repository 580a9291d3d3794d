"""The numbers that decide `correct`, each a gap between what the program
produced and what the reference produced from the same inputs.

A train step's leaf is judged by the gap between the program's norm of
the leaf and the reference's, over the larger of the reference's norm of
that leaf and the median leaf's (some gradients are all but zero). The
parameters' change is taken by the worst leaf; a leaf whose reference
gradient is under a thousandth of the median leaf's moves under Adam by
round-off alone and is left out of it (the rule is on the reference's
gradient, never on names). A step's gradient is taken by the median
leaf: the BN scales' and shifts' gradients are sums over millions of
terms that cancel to a few percent of their size, so bfloat16 rounding
alone moves the worst leaf's norm by tens of percent (the reference
rounded where a bfloat16 program stores reads the same), while the
median leaf is steady from seed to seed.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch

QUIET_LEAF = 1e-3  # reference gradient norm / the median leaf's, below which a leaf is left out


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: Iterable[str]) -> Dict[str, float]:
    """Each leaf's |program - reference| over the larger of the reference's
    value for that leaf and the median leaf's."""
    keys = list(keys)
    median = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys}


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], top: int = 3):
    """The `top` largest leaf gaps: (gap, leaf, program norm, reference norm)."""
    gaps = leaf_gaps(prog, ref, ref)
    return sorted(((g, k, prog[k], ref[k]) for k, g in gaps.items()), reverse=True)[:top]


def loss_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(prog - ref) / np.abs(ref)))


def grad_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """A step's gradient as the optimizer got it, by the median leaf."""
    ref_norms = norms(ref)
    return float(np.median(list(leaf_gaps(norms(prog), ref_norms, ref_norms).values())))


def stats_gap(prog_after, prog_before, ref_after, ref_before) -> float:
    """A step's change of the BN running statistics, by the worst leaf: the
    distance between the program's change and the reference's, over the
    larger of the reference's change and the median leaf's."""
    moved = {k: float(torch.linalg.vector_norm(ref_after[k] - ref_before[k])) for k in ref_after}
    median = float(np.median(list(moved.values())))
    # the distance between the two, not a gap of norms
    apart = {k: float(torch.linalg.vector_norm((prog_after[k] - prog_before[k])
                                               - (ref_after[k] - ref_before[k])))
             for k in ref_after}
    return max(apart[k] / max(moved[k], median, 1e-30) for k in moved)


def train_numbers(prog: dict, ref: dict, replayed: dict, start: Dict[str, torch.Tensor],
                  step: int) -> Dict[str, float]:
    """The numbers a train cell compares. `prog` (the program, or a control
    in its place) holds `grads` (the gradient as the optimizer got it) of
    step 0 and of step `step`, `stats` (the BN running statistics after
    each step) and `after` (every tensor after the last step); `ref` is the
    reference's steps from the same start, `replayed` the reference's step
    `step` from the program's state before it (both as ref.train_steps
    returns them, the gradient with its weight decay). Every dict is keyed
    by the reference's names; `start` holds the tensors before the first
    step. grad_gap and stats_gap read the first step, replay_grad_gap and
    replay_stats_gap the step `step`, which the program runs as the
    capture's replay; change_gap is each parameter's change over the steps,
    by the worst leaf, quiet leaves left out. The BN statistics are a
    forward-only reading: a step's batch means and variances. The steps'
    losses are not compared (loss_gaps, and PERF.md, say why)."""
    ref_grad = norms(ref["grads"][0])
    median_grad = float(np.median(list(ref_grad.values())))
    moving = [k for k, v in ref_grad.items() if v >= QUIET_LEAF * median_grad]

    def change(after):
        return {k: float(torch.linalg.vector_norm(after[k].float() - start[k].float()))
                for k in moving}

    first = {k: start[k].float() for k in ref["stats"][0]}
    before = prog["stats"][step - 1]
    return {
        "grad_gap": grad_gap(prog["grads"][0], ref["grads"][0]),
        "stats_gap": stats_gap(prog["stats"][0], first, ref["stats"][0], first),
        "replay_grad_gap": grad_gap(prog["grads"][step], replayed["grads"][0]),
        "replay_stats_gap": stats_gap(prog["stats"][step], before, replayed["stats"][0], before),
        "change_gap": max(leaf_gaps(change(prog["after"]), change(ref["after"]),
                                    moving).values()),
    }


def loss_gaps(prog_losses, ref_losses) -> Dict[str, float]:
    """The first step's relative loss gap and the worst of the steps'. Not
    compared: the first step's reads under 2e-3 on every seed and no
    control or fault moves it (nothing has been updated yet); the later
    steps follow Adam's first update, which is lr times the sign of each
    gradient element, so an element whose gradient is round-off takes
    either sign, and the later losses drift by up to 2% even where the
    first step agrees to 1e-7 (the program in float32)."""
    return {"loss_first": loss_gap(prog_losses[:1], ref_losses[:1]),
            "loss_steps": loss_gap(prog_losses, ref_losses)}


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |program - reference| over max |reference| of one request."""
    prog, ref = prog.float(), ref.float().to(prog.device)
    return float((prog - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> (bool, List[tuple]):
    """(correct, rows): every number at or under its limit, and each as
    (name, value, limit). A number with no limit, or one that is not
    finite, fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and np.isfinite(value) and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok and bool(rows), rows
