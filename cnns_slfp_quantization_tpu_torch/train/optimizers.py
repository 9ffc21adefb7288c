"""Quantization-aware optimizers (counterpart of the JAX
``train/optimizers.py``; reference utils/optimizer.py).

- :func:`dsgd`: "double SGD" (optimizer.py:9-73): after the ordinary
  momentum-SGD update, the step is applied twice more wherever the
  SLFP-quantized weight did not move (``|Q(w) - Q(w + d)| < 1e-4``).
- :func:`ssgd`: "scaled SGD" (optimizer.py:75-132): an extra step scaled by
  ``|w + d| + 1``.
- :func:`sgd`: NormalSGD (optimizer.py:134-190), plain momentum SGD.

Torch conventions, as in JAX: weight decay is added to the gradient before
momentum, ``buf = m*buf + (1-dampening)*g`` from a zero buffer, nesterov
uses ``g + m*buf``.  The learning rate is a float or a function of the
optimizer's own step count (optax's ``count``), which ``state_dict`` keeps.

Every scalar the QSGD update reads is a float32 0-d tensor on the
parameters' device, made once (:meth:`QSGD._const`), and the learning rate
is written into one such tensor before each step (:meth:`QSGD.ready`):
nothing is copied from host memory during a step, so a CUDA graph can
capture it (``train.loop.GraphedTrainStep``).  Under a capture the step
leaves the rate and the count to the replayer, which writes the rate of
its count before each replay.  Adam and RMSprop keep host scalars
(``capturable = False``): the graph path refuses them.

Bit for bit with JAX's jitted step on the CPU: XLA contracts a multiply
into the add that consumes it (one fused multiply-add, one rounding)
wherever the product has no other use, and folds ``1 + (|v| + 1)`` into
``|v| + 2``.  In JAX's HLO that gives ``g + wd*p``, ``m*buf + g`` and ``p +
d*(1 + scale)`` as FMAs, while ``p + d`` inside ``Q`` and ``|.|`` stays two
roundings (its product ``d = -lr*buf`` has two uses).  The update here
computes those FMAs with one rounding (``kernels/epilogue.py::affine_f32``)
on all parameters at once, flattened into one vector per step, so that the
card runs a few dozen element-wise kernels a step rather than that many per
tensor.
"""

from __future__ import annotations

from typing import Callable, Iterable, Union

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch.kernels.epilogue import affine_f32
from cnns_slfp_quantization_tpu_torch.ops import sfp

ScalarOrSchedule = Union[float, Callable[[int], float]]


def _lr_at(lr: ScalarOrSchedule, count: int) -> np.float32:
    return np.float32(lr(count) if callable(lr) else lr)


class _Counted:
    """The step count the learning rate reads, saved in ``state_dict``.
    ``capturable``: whether a CUDA graph may capture ``step``."""

    count: int = 0
    capturable: bool = False

    def state_dict(self):
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)


class QSGD(_Counted, torch.optim.Optimizer):
    """Momentum SGD with a rule for an extra step: ``"dsgd"``, ``"ssgd"``
    or ``"sgd"`` (none).  One parameter group.  ``track_stats`` (DSGD)
    counts the parameters whose quantized value moved (``updated``) and
    those that got the double step (``stuck``), cumulatively.  Under a
    model axis (``model_group`` and ``sharded``, the indices of the
    parameters that hold out-channel shards, set by
    ``parallel.steps.shard_state``) the counts of the sharded parameters
    are summed over the model group, so that the counters count each
    global parameter once, as JAX's do."""

    model_group = None
    sharded: frozenset = frozenset()
    capturable = True

    def __init__(self, params: Iterable, lr: ScalarOrSchedule, qbit: int,
                 rule: str, momentum: float = 0.9, dampening: float = 0.0,
                 weight_decay: float = 5e-4, nesterov: bool = False,
                 tol: float = 1e-4, track_stats: bool = False):
        if rule not in ("dsgd", "ssgd", "sgd"):
            raise ValueError(f"unknown rule {rule!r}")
        # the schedule stays off the param groups: state_dict pickles them
        self.lr, self.qbit, self.rule, self.tol = lr, qbit, rule, tol
        self.stats = ({"updated": 0, "stuck": 0} if track_stats else None)
        super().__init__(params, dict(momentum=momentum, dampening=dampening,
                                      weight_decay=weight_decay,
                                      nesterov=nesterov))
        if len(self.param_groups) != 1:
            raise ValueError("QSGD takes one parameter group")
        # (float32 bits, device) -> 0-d tensor; device -> the rate's tensor
        self._consts, self._neg_lr = {}, {}

    def _const(self, v, device) -> torch.Tensor:
        """float32(v) as a 0-d tensor on ``device``, made once."""
        key = (int(np.float32(v).view(np.int32)), device)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.tensor(np.float32(v), device=device)
        return t

    def ready(self) -> None:
        """Write ``-lr`` at the current count into the tensor the update
        reads: each eager step does it first, a graph's replayer before
        each replay (a fill kernel, no copy from host memory)."""
        dev = self.param_groups[0]["params"][0].device
        t = self._neg_lr.get(dev)
        if t is None:
            t = self._neg_lr[dev] = torch.zeros((), dtype=torch.float32,
                                                device=dev)
        t.fill_(float(-_lr_at(self.lr, self.count)))

    def state_dict(self):
        sd = super().state_dict()
        sd["stats"] = None if self.stats is None else dict(self.stats)
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        stats = state_dict.pop("stats", None)
        self.stats = None if stats is None else dict(stats)
        super().load_state_dict(state_dict)

    def _scale(self, p, d1):
        """The extra step's scale for the ordinary update ``d1`` of ``p``
        (JAX's ``rescale(p, delta1, quantize)``), and ``1 + scale`` as XLA
        computes it."""
        pd = p + d1
        if self.rule == "dsgd":
            moved = (sfp.quantize_weight(p, self.qbit)
                     - sfp.quantize_weight(pd, self.qbit)).abs()
            scale = torch.where(moved < np.float32(self.tol),
                                self._const(2.0, p.device),
                                self._const(0.0, p.device))
            return scale, 1.0 + scale
        return None, pd.abs() + self._const(2.0, p.device)      # ssgd

    def _count(self, flags, ps, sizes):
        """The number of set ``flags`` (one per element of ``ps``,
        flattened), each global parameter once."""
        if self.model_group is None:
            return flags.sum()
        from cnns_slfp_quantization_tpu_torch.parallel import comm

        all_ps = self.param_groups[0]["params"]
        sharded = {id(all_ps[i]) for i in self.sharded}
        parts = [f.sum() for f in flags.split(sizes)]
        mine = sum((c for c, t in zip(parts, ps) if id(t) in sharded),
                   flags.new_zeros((), dtype=torch.int64))
        rep = sum((c for c, t in zip(parts, ps) if id(t) not in sharded),
                  flags.new_zeros((), dtype=torch.int64))
        return comm.all_reduce_sum(mine, self.model_group) + rep

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        ps = [p for p in group["params"] if p.grad is not None]
        if not ps:
            return loss
        dev = ps[0].device
        # under a capture the replayer writes the rate and counts the step
        capturing = (dev.type == "cuda"
                     and torch.cuda.is_current_stream_capturing())
        if not capturing:
            self.ready()
        m, damp = group["momentum"], group["dampening"]
        wd = group["weight_decay"]
        p = torch.cat([t.reshape(-1) for t in ps])
        g = torch.cat([t.grad.reshape(-1) for t in ps])
        if wd:
            g = affine_f32(p, self._const(wd, dev), g)
        if m:
            for t in ps:
                if "momentum" not in self.state[t]:
                    self.state[t]["momentum"] = torch.zeros_like(t)
            buf = torch.cat([self.state[t]["momentum"].reshape(-1)
                             for t in ps])
            gd = g if damp == 0 else g * self._const(1.0 - damp, dev)
            buf = affine_f32(buf, self._const(m, dev), gd)
            d = (affine_f32(buf, self._const(m, dev), g) if group["nesterov"]
                 else buf)
        else:
            d = g
        neg_lr = self._neg_lr[dev]
        if self.rule == "sgd":
            # the multiply by 1 + 0.0 folds away: p + d*(-lr), one rounding
            new = affine_f32(d, neg_lr, p)
        else:
            d1 = d * neg_lr
            scale, factor = self._scale(p, d1)
            new = affine_f32(d1, factor, p)
        sizes = [t.numel() for t in ps]
        if self.rule != "sgd" and self.stats is not None \
                and scale is not None:
            self.stats["updated"] += self._count(scale == 0.0, ps, sizes)
            self.stats["stuck"] += self._count(scale == 2.0, ps, sizes)
        torch._foreach_copy_(ps, [v.view_as(t) for v, t in
                                  zip(new.split(sizes), ps)])
        if m:
            bufs = [self.state[t]["momentum"] for t in ps]
            torch._foreach_copy_(bufs, [v.view_as(t) for v, t in
                                        zip(buf.split(sizes), bufs)])
        if not capturing:
            self.count += 1
        return loss


def dsgd(params, lr: ScalarOrSchedule, qbit: int, momentum: float = 0.9,
         dampening: float = 0.0, weight_decay: float = 5e-4,
         nesterov: bool = False, tol: float = 1e-4,
         track_stats: bool = False) -> QSGD:
    """DSGD: 2x extra step where the quantized weight did not move
    (optimizer.py:58-64; tolerance 1e-4 at :62-63)."""
    return QSGD(params, lr, qbit, "dsgd", momentum, dampening, weight_decay,
                nesterov, tol, track_stats)


def ssgd(params, lr: ScalarOrSchedule, qbit: int, momentum: float = 0.9,
         dampening: float = 0.0, weight_decay: float = 5e-4,
         nesterov: bool = False) -> QSGD:
    """SSGD: extra step scaled by ``|w_after| + 1`` (optimizer.py:127-131);
    ``qbit`` is kept for CLI parity, as in JAX."""
    return QSGD(params, lr, qbit, "ssgd", momentum, dampening, weight_decay,
                nesterov)


def sgd(params, lr: ScalarOrSchedule, momentum: float = 0.9,
        dampening: float = 0.0, weight_decay: float = 5e-4,
        nesterov: bool = False) -> QSGD:
    """Plain torch-style momentum SGD (NormalSGD, optimizer.py:134-190)."""
    return QSGD(params, lr, 32, "sgd", momentum, dampening, weight_decay,
                nesterov)


class Adam(_Counted, torch.optim.Adam):
    """``torch.optim.Adam`` at optax's constants (b1 0.9, b2 0.999, eps
    1e-8, no weight decay), its learning rate read from the schedule at
    the optimizer's own count."""

    def __init__(self, params, lr: ScalarOrSchedule):
        self.schedule = lr
        super().__init__(params, lr=float(_lr_at(lr, 0)), betas=(0.9, 0.999),
                         eps=1e-8)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = float(_lr_at(self.schedule, self.count))
        loss = super().step(closure)
        self.count += 1
        return loss


class RMSprop(_Counted, torch.optim.Optimizer):
    """optax ``rmsprop(lr, decay=0.99, eps=1e-8)``: ``nu = (1-decay)*g^2 +
    decay*nu`` from zero, ``p -= lr * g * rsqrt(nu + eps)``.  Not
    ``torch.optim.RMSprop``, which divides by ``sqrt(nu) + eps``: at a
    second moment of 1e-4 the two differ by 5e-5 relative."""

    def __init__(self, params, lr: ScalarOrSchedule, decay: float = 0.99,
                 eps: float = 1e-8):
        self.schedule = lr
        super().__init__(params, dict(decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        lr_t = _lr_at(self.schedule, self.count)
        for group in self.param_groups:
            decay = np.float32(group["decay"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if "nu" not in st:
                    st["nu"] = torch.zeros_like(p)
                g = p.grad
                nu = (np.float32(1.0) - decay) * g.square() + decay * st["nu"]
                st["nu"].copy_(nu)
                u = torch.rsqrt(nu + np.float32(group["eps"])) * g
                p.add_(u * np.float32(-lr_t))
        self.count += 1
        return loss


def create_optimizer(name: str, params, lr: ScalarOrSchedule, qbit: int = 32,
                     momentum: float = 0.9, weight_decay: float = 5e-4
                     ) -> torch.optim.Optimizer:
    """By reference driver name (cifar100_train_eval.py:137-152)."""
    key = name.lower()
    if key == "dsgd":
        return dsgd(params, lr, qbit, momentum=momentum,
                    weight_decay=weight_decay)
    if key == "ssgd":
        return ssgd(params, lr, qbit, momentum=momentum,
                    weight_decay=weight_decay)
    if key in ("sgd", "normalsgd"):
        return sgd(params, lr, momentum=momentum, weight_decay=weight_decay)
    if key == "adam":
        return Adam(params, lr)
    if key == "rmsprop":
        return RMSprop(params, lr)
    raise ValueError(f"unknown optimizer {name!r}")
