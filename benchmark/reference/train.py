"""Reference QAT steps in plain PyTorch: the configuration's training-mode
network, mean cross-entropy over integer labels, its gradient by autograd
(the quantizers' straight-through estimator), and the reference
repository's DSGD update (``utils/optimizer.py``):

    g'   = g + wd * p                      one rounding
    buf  = m * buf + g'                    one rounding, from a zero buffer
    d1   = -lr * buf
    p'   = p + d1 * (1 + s),  s = 2 where |Q(p) - Q(p + d1)| < tol, else 0

with ``Q`` the SLFP<3,4> weight quantizer on the raw parameter.  The
single-rounding steps are fused multiply-adds (:func:`fma`).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import common, slfp

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def trained(p: dict) -> list:
    """The names of the entries an optimizer updates."""
    return [k for k in p if not k.endswith(BUFFERS)]


def fma(y: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``y * s + t`` in float32 with one rounding.

    Frozen copy of the port's ``kernels/epilogue.py::affine_f32``: the
    product is exact in float64, the sum's rounding error is recovered
    exactly (TwoSum), and where the float64 sum landed on a float32
    midpoint that the exact sum is not on, the result is rounded toward the
    exact side, which a plain ``.float()`` of the float64 sum gets wrong."""
    p = _flush(y.to(torch.float32)).double() * s.double()
    td = t.double()
    d = p + td
    bb = d - p
    err = (p - (d - bb)) + (td - bb)
    r = d.float()
    rd = r.double()
    inf = torch.full((), float("inf"), dtype=torch.float32, device=y.device)
    other = torch.nextafter(r, torch.where(d > rd, inf, -inf))
    od = other.double()
    fix = (d == (rd + od) * 0.5) & (err != 0) & ((err > 0) == (od > rd))
    return _flush(torch.where(fix, other, r))


def _flush(x: torch.Tensor) -> torch.Tensor:
    """float32 subnormals -> zero of the same sign."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, x * 0.0, x)


def dsgd_update(p: dict, grads: dict, bufs: dict, *, lr: float,
                momentum: float, weight_decay: float, tol: float) -> None:
    """One DSGD step on the float32 leaves ``p`` (in place, by name)."""
    dev = next(iter(p.values())).device
    c = {k: torch.tensor(np.float32(v), device=dev) for k, v in
         (("wd", weight_decay), ("m", momentum), ("neg_lr", -lr),
          ("tol", tol))}
    with torch.no_grad():
        for k, g in grads.items():
            w = p[k]
            gd = fma(w, c["wd"], g)
            buf = fma(bufs.get(k, torch.zeros_like(w)), c["m"], gd)
            bufs[k] = buf
            d1 = buf * c["neg_lr"]
            moved = (slfp.quantize_weight(w)
                     - slfp.quantize_weight(w + d1)).abs()
            factor = torch.where(moved < c["tol"], 3.0, 1.0)
            p[k] = fma(d1, factor, w)


def qat_steps(model, p0: dict, batches, ka, kw, *, lr: float,
              momentum: float, weight_decay: float, tol: float,
              num: common.Numerics = common.Numerics(sums="float32")
              ) -> dict:
    """Run ``len(batches)`` steps of ``model.train_forward`` from ``p0``:
    {"loss": [per step], "grad1": {name: first gradient}, "change":
    {name: p_end - p0}}."""
    p = {k: v.detach().clone() for k, v in p0.items()}
    names = trained(p)
    bufs, losses, grad1 = {}, [], None
    for x, y in batches:
        leaves = {k: p[k].requires_grad_(True) for k in names}
        loss = common.cross_entropy(
            model.train_forward(p, x, ka, kw, num=num), y)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        losses.append(float(loss.detach()))
        for k in names:
            p[k] = p[k].detach()
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        dsgd_update(p, grads, bufs, lr=lr, momentum=momentum,
                    weight_decay=weight_decay, tol=tol)
    return {"loss": losses, "grad1": grad1,
            "change": {k: p[k] - p0[k] for k in names}}
