"""The numbers that decide ``correct`` for a training cell.

Over the first three steps: each step's loss, the norm of the first
gradient as the optimizer gets it, and the norm of each parameter's
change after the three.  Each is taken by the worst leaf: the gap
between the program's norm and the reference's, over the reference's
norm of that leaf or of the median leaf, whichever is larger.  A loss
is taken alike, over the reference's loss of that step or the median
of its three, whichever is larger: a confident, right prediction makes
a loss near 0, over which rounding would read as a wide gap.  Leaves
whose reference gradient is under a thousandth of the median leaf's
move under Adam by round-off alone, so they are left out of the
change."""

from __future__ import annotations

import statistics

import torch


def norms(tensors: dict) -> dict:
    return {k: torch.linalg.vector_norm(v.float()).item()
            for k, v in tensors.items()}


def leaf_gaps(got: dict, want: dict, names) -> list:
    med = statistics.median(want[n] for n in want)
    return [abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names]


def worst_gap(got: dict, want: dict, names) -> float:
    return max(leaf_gaps(got, want, names))


def training_gaps(got: dict, want: dict) -> dict:
    """``got`` and ``want``: ``{"losses": [3 floats], "grad": {leaf:
    norm}, "change": {leaf: norm}}`` of the program (or the control) and
    of the reference."""
    g = want["grad"]
    floor = 1e-3 * statistics.median(g.values())
    moved = [n for n in g if g[n] >= floor]
    med = statistics.median(abs(b) for b in want["losses"])
    first = abs(want["losses"][0])
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), med, 1e-30)
                        for a, b in zip(got["losses"], want["losses"])),
        "first_loss_gap": abs(got["losses"][0] - want["losses"][0])
        / max(first, 1e-30),
        "grad_gap": worst_gap(got["grad"], g, list(g)),
        "change_gap": worst_gap(got["change"], want["change"], moved),
        "grad_gap_median": statistics.median(leaf_gaps(got["grad"], g,
                                                       list(g))),
        "change_gap_median": statistics.median(leaf_gaps(
            got["change"], want["change"], moved)),
    }


def explain(got: dict, want: dict, top: int = 3) -> dict:
    """The losses side by side, and the leaves of the widest gradient
    and change gaps with their norms (program, reference)."""
    out = {"losses": list(zip(got["losses"], want["losses"]))}
    for key in ("grad", "change"):
        med = statistics.median(want[key].values())
        worst = sorted(want[key], key=lambda n: -abs(got[key][n]
                                                      - want[key][n])
                       / max(want[key][n], med, 1e-30))[:top]
        out[key] = [(n, got[key][n], want[key][n]) for n in worst]
        out[key + "_median"] = med
    return out


def first_gradient(optimizer, named_params: dict) -> dict:
    """Norms of the gradient an Adam got at its first step, worked out
    from its state: exp_avg = (1 - b1) g.  A parameter it never stepped
    reads 0."""
    b1 = optimizer.param_groups[0]["betas"][0]
    out = {}
    for name, p in named_params.items():
        state = optimizer.state.get(p, {})
        out[name] = torch.linalg.vector_norm(
            state["exp_avg"].float()).item() / (1 - b1) \
            if "exp_avg" in state else 0.0
    return out
