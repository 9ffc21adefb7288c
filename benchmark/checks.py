"""The numbers that decide ``correct``, each held to its limit from the
configuration file (``limits``), which ``PERF.md`` derives from the
readings of sound runs and of the control.

Serving, per checked image (a row of logits):
``logit_gap = max_j |program_j - reference_j| / max_j |reference_j|``;
a run compares the widest over its checked requests.

Training, over the first steps the program took in set-up, each leaf's
gap ``| |v| - |v_ref| |`` over ``max(|v_ref|, the median leaf's |v_ref|)``:

- ``loss_gap``: ``|loss - loss_ref| / |loss_ref|`` of the first step;
- ``grad_gap``: the worst leaf's gap of the first step's gradient (the
  program's worked out from its momentum after one step);
- ``change_gap``: each leaf's gap of its change over the steps, leaving
  out leaves whose reference gradient is under a thousandth of the median
  leaf's (they move by round-off alone); the leaves grouped by their role
  (:func:`leaf_group`: convolution kernels, the classifier's kernel,
  BatchNorm scales, shifts and biases), the median leaf of each group, and
  of those the worst.  A step that leaves a group unmoved, or moves it
  double, reads about 1 there.

The program's first forward equals the float32 reference's, its backward
does not quite: a gradient that differs by a rounding moves a few weights
across a quantization bin, and the later steps' forwards then disagree as
two sound programs do.  The reference with float64 sums against itself
with float32 sums reads the single worst leaf's change as high as the
program does (PERF.md).  So the later steps' losses and the single worst
leaf's change are reported beside the checks (:func:`train_readings`),
not compared.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def logit_gaps(prog: torch.Tensor, ref: torch.Tensor) -> list:
    """Each row's widest gap, relative to the reference row's largest
    magnitude; a row that is not finite reads infinity."""
    prog, ref = prog.to(torch.float64), ref.to(torch.float64)
    gap = (prog - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)
    gap = torch.where(torch.isfinite(prog).all(dim=1), gap,
                      torch.full_like(gap, math.inf))
    return gap.tolist()


def leaf_norms(leaves: dict) -> dict:
    return {k: float(v.to(torch.float64).norm()) for k, v in leaves.items()}


def leaf_gaps(prog: dict, ref: dict, leaves=None) -> dict:
    """name -> the leaf's gap of norms (float64 norms), infinity where not
    finite."""
    keys = list(ref) if leaves is None else list(leaves)
    pn, rn = leaf_norms({k: prog[k] for k in keys}), \
        leaf_norms({k: ref[k] for k in keys})
    med = float(np.median([rn[k] for k in keys]))
    out = {}
    for k in keys:
        g = abs(pn[k] - rn[k]) / max(rn[k], med)
        out[k] = g if math.isfinite(g) else math.inf
    return out


def leaf_group(name: str, leaf: torch.Tensor) -> str:
    """A leaf's role, by the last part of its name and its rank:
    ``weight.4`` convolution kernels, ``weight.2`` a classifier's kernel,
    ``weight.1`` BatchNorm scales, ``bias.1`` shifts and biases."""
    return f"{name.rsplit('.', 1)[-1]}.{leaf.dim()}"


def _loss_gaps(prog: dict, ref: dict) -> list:
    return [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(prog["loss"], ref["loss"])]


def moving(grad_ref: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    rn = leaf_norms(grad_ref)
    med = float(np.median(list(rn.values())))
    return [k for k, v in rn.items() if v >= 1e-3 * med]


def _change_by_group(prog: dict, ref: dict) -> dict:
    """group -> the median leaf's change gap, over the moving leaves."""
    gaps = leaf_gaps(prog["change"], ref["change"], moving(ref["grad1"]))
    groups = {}
    for k, g in gaps.items():
        groups.setdefault(leaf_group(k, ref["change"][k]), []).append(g)
    return {k: float(np.median(v)) for k, v in sorted(groups.items())}


def train_numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers; ``prog`` / ``ref``: {"loss": [...], "grad1":
    {...}, "change": {...}}."""
    return {
        "loss_gap": _loss_gaps(prog, ref)[0],
        "grad_gap": max(leaf_gaps(prog["grad1"], ref["grad1"]).values()),
        "change_gap": max(_change_by_group(prog, ref).values()),
    }


def train_readings(prog: dict, ref: dict) -> dict:
    """What is reported and not compared: every step's loss gap, each
    group's median change gap, and the worst leaves of the first gradient
    and of the change, by name."""
    grad = leaf_gaps(prog["grad1"], ref["grad1"])
    change = leaf_gaps(prog["change"], ref["change"], moving(ref["grad1"]))
    g, c = max(grad, key=grad.get), max(change, key=change.get)
    return {
        "loss_gap_steps": _loss_gaps(prog, ref),
        "change_gap_groups": _change_by_group(prog, ref),
        "grad_gap_worst": [g, grad[g]],
        "change_gap_worst": [c, change[c]],
    }


def verdict(numbers: dict, limits: dict, **counts) -> dict:
    """{"correct", the counts, "checks": {name: {"value", "limit"}}}: a
    number at or above its limit, or not finite, is not correct."""
    ok = all(math.isfinite(v) and v < limits[k] for k, v in numbers.items())
    return {"correct": ok, **counts,
            "checks": {k: {"value": v, "limit": limits[k]}
                       for k, v in numbers.items()}}
