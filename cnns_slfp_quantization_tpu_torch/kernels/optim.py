"""K7: QSGD's update over every parameter (hand kernel ``csrc/optim.cu``).

Momentum SGD (weight decay added to the gradient first, dampening,
nesterov) and then the rule's extra step: ``"dsgd"`` doubles it where the
quantized weight did not move, ``"ssgd"`` scales it by ``|p + d1| + 1``,
``"sgd"`` takes none (``train/optimizers.py`` holds the rules' origin).
Parameters, gradients and momentum buffers are updated in place.

:func:`qsgd_update_plain` is the plain version: every tensor flattened into
one vector, the fused multiply-adds that XLA's jitted step computes emulated
with one rounding (``kernels/epilogue.py::affine_f32``), bit for bit with
JAX on the CPU.  :func:`qsgd_update` launches the kernel on CUDA tensors:
the same arithmetic a thread per element, the tensors read where they lie,
in as many launches as :func:`plan` gives (one per :data:`MAX_TENSORS`
tensors; ``launches`` counts them).  A CPU tensor takes the plain version.
"""

from __future__ import annotations

import bisect
import ctypes
import functools

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch.kernels import _build
from cnns_slfp_quantization_tpu_torch.kernels.epilogue import affine_f32
from cnns_slfp_quantization_tpu_torch.ops import sfp

CHUNK = 4096          # elements a block (csrc/optim.cu kChunk)
MAX_TENSORS = 112     # tensors a launch (kMaxTensors)
ARG_BYTES = 4096      # CUDA's limit on one launch's kernel arguments
RULES = {"dsgd": 0, "ssgd": 1, "sgd": 2}
_WD, _MOM, _DAMP = 1, 2, 4

_T = MAX_TENSORS


class Plan(ctypes.Structure):
    """One launch's tensors, as ``csrc/optim.cu::Plan`` lays them out."""

    _fields_ = [
        ("p", ctypes.c_void_p * _T),
        ("g", ctypes.c_void_p * _T),
        ("buf", ctypes.c_void_p * _T),
        ("neg_lr", ctypes.c_void_p),
        ("counts", ctypes.c_void_p),
        ("first", ctypes.c_int * (_T + 1)),
        ("n", ctypes.c_int * _T),
        ("wd", ctypes.c_float),
        ("momentum", ctypes.c_float),
        ("gscale", ctypes.c_float),
        ("tol", ctypes.c_float),
        ("tensors", ctypes.c_int),
        ("flags", ctypes.c_int),
        ("vec", ctypes.c_ubyte * _T),
    ]


def plan(sizes) -> list:
    """The launches that update tensors of ``sizes`` elements: for each,
    (index of its first tensor, ``first``), where ``first[i]`` is the first
    block of the launch's tensor i and ``first[-1]`` its number of blocks;
    a block takes :data:`CHUNK` elements of one tensor (:func:`block_span`),
    a launch at most :data:`MAX_TENSORS` tensors."""
    out = []
    for s in range(0, len(sizes), MAX_TENSORS):
        first = [0]
        for n in sizes[s:s + MAX_TENSORS]:
            first.append(first[-1] + -(-int(n) // CHUNK))
        out.append((s, first))
    return out


def block_span(first, sizes, b: int) -> tuple:
    """(tensor, start, stop) of block ``b`` of a launch over tensors of
    ``sizes`` with prefix ``first``: the kernel's own search, the last
    tensor whose first block is at most ``b``."""
    t = bisect.bisect_right(first, b, 0, len(sizes)) - 1
    start = (b - first[t]) * CHUNK
    return t, start, min(start + CHUNK, int(sizes[t]))


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _fresh_const(v, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=device)


def rescale(p, d1, rule: str, qbit: int, tol: float, const=_fresh_const):
    """The extra step's scale for the ordinary update ``d1`` of ``p``
    (JAX's ``rescale(p, delta1, quantize)``; None for SSGD) and ``1 +
    scale`` as XLA computes it."""
    pd = p + d1
    if rule == "dsgd":
        moved = (sfp.quantize_weight(p, qbit)
                 - sfp.quantize_weight(pd, qbit)).abs()
        scale = torch.where(moved < np.float32(tol), const(2.0, p.device),
                            const(0.0, p.device))
        return scale, 1.0 + scale
    return None, pd.abs() + const(2.0, p.device)      # ssgd


def qsgd_update_plain(params, grads, bufs, neg_lr, *, rule: str, qbit: int,
                      weight_decay: float, momentum: float, dampening: float,
                      nesterov: bool, tol: float, stats: bool = False,
                      const=_fresh_const, scale=None):
    """The update on all tensors flattened into one vector.  ``bufs``: the
    momentum buffers (None without momentum); ``neg_lr``: ``-lr`` as a 0-d
    float32 tensor; ``const(v, device)``: ``float32(v)`` as a 0-d tensor
    (the optimizer's, made once); ``scale(p, d1)``: the rule's
    :func:`rescale` (a subclass's own rule).  Returns, with ``stats`` and
    a rule that gives a scale, each tensor's ("updated", "stuck") counts as
    int64 ``[tensors, 2]``, else None."""
    dev = params[0].device
    if scale is None:
        scale = functools.partial(rescale, rule=rule, qbit=qbit, tol=tol,
                                  const=const)
    p = torch.cat([t.reshape(-1) for t in params])
    g = torch.cat([t.reshape(-1) for t in grads])
    if weight_decay:
        g = affine_f32(p, const(weight_decay, dev), g)
    if momentum:
        buf = torch.cat([t.reshape(-1) for t in bufs])
        gd = (g if dampening == 0
              else g * const(1.0 - dampening, dev))
        buf = affine_f32(buf, const(momentum, dev), gd)
        d = (affine_f32(buf, const(momentum, dev), g) if nesterov
             else buf)
    else:
        d = g
    sc = None
    if rule == "sgd":
        # the multiply by 1 + 0.0 folds away: p + d*(-lr), one rounding
        new = affine_f32(d, neg_lr, p)
    else:
        d1 = d * neg_lr
        sc, factor = scale(p, d1)
        new = affine_f32(d1, factor, p)
    sizes = [t.numel() for t in params]
    out = None
    if stats and sc is not None:
        out = torch.stack([torch.stack([(f == 0.0).sum(), (f == 2.0).sum()])
                           for f in sc.split(sizes)])
    torch._foreach_copy_(list(params), [v.view_as(t) for v, t in
                                        zip(new.split(sizes), params)])
    if momentum:
        torch._foreach_copy_(list(bufs), [v.view_as(t) for v, t in
                                          zip(buf.split(sizes), bufs)])
    return out


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------


_FIELDS = [name for name, _ in Plan._fields_]
_layout_checked = False


def _check_layout() -> None:
    """Hold :class:`Plan` to the C struct's offsets and size, once."""
    global _layout_checked
    if _layout_checked:
        return
    fn = _build.load("optim").qsgd_plan_layout
    want = [getattr(Plan, f).offset for f in _FIELDS] + [
        ctypes.sizeof(Plan)]
    got = [fn(i) for i in range(len(_FIELDS))] + [fn(-1)]
    if got != want:
        raise RuntimeError(f"csrc/optim.cu's Plan layout {got} differs from "
                           f"kernels/optim.py's {want}")
    _layout_checked = True


def _dense(t: torch.Tensor) -> bool:
    return t.is_contiguous() or (
        t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last))


def _layout(t: torch.Tensor) -> tuple:
    """The strides of ``t``'s dims of more than one element: two dense
    tensors of one shape whose layouts are equal hold their elements in
    the same order (a dim of one element may carry any stride: cuDNN
    gives a 1x1 convolution's gradient other strides there than its
    channels-last weight has)."""
    return tuple(st for st, n in zip(t.stride(), t.shape) if n > 1)


def qsgd_update(params, grads, bufs, neg_lr, *, rule: str, qbit: int,
                weight_decay: float, momentum: float, dampening: float,
                nesterov: bool, tol: float, stats: bool = False,
                counts=None):
    """:func:`qsgd_update_plain`'s update, through the kernel on CUDA
    tensors: float32 ``params``, ``grads`` and ``bufs`` alike in shape and
    layout (:func:`_layout`), each dense.  With ``stats`` (DSGD) the counts go to
    ``counts`` when it is an int64 ``[tensors, 2]`` on their device (the
    buffer an earlier call returned), else to one allocated here; returned,
    else None."""
    if params[0].device.type == "cpu":
        return qsgd_update_plain(
            params, grads, bufs, neg_lr, rule=rule, qbit=qbit,
            weight_decay=weight_decay, momentum=momentum,
            dampening=dampening, nesterov=nesterov, tol=tol, stats=stats)
    if rule not in RULES or (rule == "dsgd" and qbit not in (7, 8, 32)):
        raise ValueError(f"qsgd_update: rule {rule!r}, qbit {qbit}")
    stats = bool(stats) and rule == "dsgd"
    if bool(momentum) != (bufs is not None):
        raise ValueError("qsgd_update: momentum buffers go with momentum")
    dev = params[0].device
    every = [*params, *grads, *(bufs or ()), neg_lr]
    if ({t.dtype for t in every} != {torch.float32}
            or {t.device for t in every} != {dev} or neg_lr.numel() != 1):
        raise ValueError("qsgd_update: parameters, gradients, momentum "
                         "buffers and neg_lr (0-d) float32 on one CUDA "
                         "device")
    sizes = [p.numel() for p in params]
    for i, p in enumerate(params):
        lay, sh = _layout(p), p.shape
        if (grads[i].shape != sh or _layout(grads[i]) != lay
                or (bufs is not None and (bufs[i].shape != sh
                                          or _layout(bufs[i]) != lay))
                or not _dense(p) or sizes[i] >= 2**31):
            raise ValueError(
                "qsgd_update: each parameter, its gradient and its momentum "
                "buffer alike in shape and layout, dense, under 2**31 "
                "elements")
    _check_layout()
    stream = _build.stream_of(params[0])
    if stats:
        if (counts is None or counts.shape != (len(params), 2)
                or counts.dtype != torch.int64 or counts.device != dev):
            counts = torch.empty((len(params), 2), dtype=torch.int64,
                                 device=dev)
        _build.launch("optim", "qsgd_zero_counts", counts.data_ptr(),
                      counts.numel() * 8, stream)
    flags = ((_WD if weight_decay else 0) | (_MOM if momentum else 0)
             | (_DAMP if dampening != 0 else 0))
    pp = [t.data_ptr() for t in params]
    gp = [t.data_ptr() for t in grads]
    bp = [t.data_ptr() for t in bufs] if bufs is not None else [0] * len(pp)
    vec = [int((a | b | c) % 16 == 0) for a, b, c in zip(pp, gp, bp)]
    for s, first in plan(sizes):
        k = len(first) - 1
        pl = Plan(neg_lr=neg_lr.data_ptr(),
                  counts=counts.data_ptr() + 16 * s if stats else None,
                  wd=float(np.float32(weight_decay)),
                  momentum=float(np.float32(momentum)),
                  gscale=float(np.float32(1.0 - dampening)),
                  tol=float(np.float32(tol)), tensors=k, flags=flags)
        pl.first[:k + 1] = first
        pl.p[:k], pl.g[:k], pl.buf[:k] = (pp[s:s + k], gp[s:s + k],
                                          bp[s:s + k])
        pl.n[:k], pl.vec[:k] = sizes[s:s + k], vec[s:s + k]
        _build.launch("optim", "qsgd_update", ctypes.addressof(pl),
                      RULES[rule], int(qbit), int(bool(nesterov)),
                      int(stats), stream)
        qsgd_update.launches += 1
    return counts if stats else None


qsgd_update.launches = 0
