"""K3: per-channel affine epilogue (hand kernel ``csrc/epilogue.cu``).

Counterpart of the Pallas kernel ``kernels/epilogue.py::dual_epilogue`` and
of the JAX executor's XLA epilogue ``resnet50_fused.py::xla_post``: after a
cuDNN convolution or a plain matmul with an f32 output ``y`` it computes

    v   = relu?(fma(y, s, t) (+ identity))
    raw = bf16(v)
    q   = act_bf16_bits(raw if raw is emitted else v, recip, 8, relu)

and writes raw, q or both (the dual form) in one pass.  When raw is written,
q quantizes the bf16-rounded raw value (``dual_epilogue``'s semantics);
when only q is written, it quantizes the f32 value (``xla_post`` followed by
``quantize_act_pass``).  q is bf16, or (``q_dtype=torch.float32``) the same
bf16 values widened exactly: the operand cuDNN and the plain matmuls read,
with no copy in between.  The kernel folds its flushes into FTZ
instructions when :func:`ftz_route` allows it; the executors decide that
once, when they lay out their weights, and pass it as ``ftz``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch.kernels import _build
from cnns_slfp_quantization_tpu_torch.ops import sfp


def affine_f32(y: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``fma(y, s, t)`` in float32 with a single rounding.

    The kernels use ``__fmaf_rn`` and XLA contracts ``y*s + t`` into one
    fused multiply-add, so a separate multiply and add would move values
    across quantization bins.  The product is exact in float64; the sum's
    rounding error is recovered exactly (TwoSum), and where the float64 sum
    landed on a float32 midpoint that the exact sum is not on, the result
    is rounded toward the exact side, which a plain ``.float()`` of the
    float64 sum would get wrong.
    """
    p = sfp.flush_subnormals(y.to(torch.float32)).double() * s.double()
    td = t.double()
    d = p + td
    bb = d - p
    err = (p - (d - bb)) + (td - bb)
    r = d.float()
    rd = r.double()
    # a fill, not a copy from host memory: the optimizer's update runs
    # this inside a CUDA graph
    inf = torch.full((), float("inf"), dtype=torch.float32, device=y.device)
    other = torch.nextafter(r, torch.where(d > rd, inf, -inf))
    od = other.double()
    fix = (d == (rd + od) * 0.5) & (err != 0) & ((err > 0) == (od > rd))
    return sfp.flush_subnormals(torch.where(fix, other, r))


def epilogue_value_plain(y, s, t, identity: Optional[torch.Tensor],
                         relu: bool) -> torch.Tensor:
    """The f32 value every epilogue writes: affine, residual, ReLU (+0.0)."""
    v = affine_f32(y, s, t)
    if identity is not None:
        v = sfp.flush_subnormals(
            v + sfp.flush_subnormals(identity.to(torch.float32)))
    if relu:
        v = torch.where(v > 0, v, torch.zeros((), dtype=v.dtype,
                                              device=v.device))
    return v


def bn_epilogue_plain(y, scale, shift, *, identity=None, relu=True,
                      emit_raw=True, quant_recip=None,
                      q_dtype=torch.bfloat16):
    v = epilogue_value_plain(y, scale, shift, identity, relu)
    raw = v.to(torch.bfloat16)
    q = None
    if quant_recip is not None:
        q = sfp.act_bf16_bits(raw if emit_raw else v, quant_recip, 8,
                              relu).to(q_dtype)
    return (raw if emit_raw else None), q


def ftz_route(scale: torch.Tensor, shift: torch.Tensor,
              recips=()) -> bool:
    """Whether K3 may fold its flushes into FTZ instructions and still give
    the exact route's bits: no element of ``scale`` or ``shift`` and none
    of the reciprocals ``recips`` is subnormal.  Reads the tensors (a
    device sync on the card)."""
    return (_build.no_subnormal(scale) and _build.no_subnormal(shift)
            and all(_build.normal_scalar(r) for r in recips))


def bn_epilogue(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                identity: Optional[torch.Tensor] = None, relu: bool = True,
                emit_raw: bool = True, quant_recip: Optional[float] = None,
                q_dtype: torch.dtype = torch.bfloat16,
                ftz: Optional[bool] = None):
    """(raw, q) for y f32 [..., C]; either is None when not asked for.

    identity: bf16 [..., C] residual; scale/shift: f32 [C];
    quant_recip: 1/Ka of the consumer, None for no quantized output;
    q_dtype: bf16, or float32 holding the bf16 values;
    ftz: the route, :func:`ftz_route` of these operands as the caller
    decided it once; None decides it here (a device sync).
    """
    if not emit_raw and quant_recip is None:
        raise ValueError("bn_epilogue: nothing to emit")
    if y.device.type == "cpu":
        return bn_epilogue_plain(y, scale, shift, identity=identity,
                                 relu=relu, emit_raw=emit_raw,
                                 quant_recip=quant_recip, q_dtype=q_dtype)
    c = y.shape[-1]
    if (y.dtype != torch.float32 or scale.dtype != torch.float32
            or shift.dtype != torch.float32 or scale.shape != (c,)
            or shift.shape != (c,)
            or q_dtype not in (torch.bfloat16, torch.float32)
            or (identity is not None and (identity.dtype != torch.bfloat16
                                          or identity.shape != y.shape))):
        raise ValueError("bn_epilogue: y f32 [..., C], scale/shift f32 [C], "
                         "identity bf16 like y, q bf16 or f32")
    _build.check_cuda(y, scale, shift, identity)
    if ftz is None:
        ftz = ftz_route(scale, shift, () if quant_recip is None
                        else (quant_recip,))
    raw = (torch.empty(y.shape, dtype=torch.bfloat16, device=y.device)
           if emit_raw else None)
    q = (torch.empty(y.shape, dtype=q_dtype, device=y.device)
         if quant_recip is not None else None)
    vec = c % 4 == 0 and _build.aligned16(y, scale, shift, identity, raw, q)
    _build.launch(
        "epilogue", "slfp_epilogue", y.data_ptr(),
        None if identity is None else identity.data_ptr(),
        scale.data_ptr(), shift.data_ptr(),
        None if raw is None else raw.data_ptr(),
        None if q is None else q.data_ptr(), int(q_dtype == torch.float32),
        y.numel() // max(c, 1), c,
        float(np.float32(quant_recip if quant_recip is not None else 1.0)),
        int(relu), int(ftz), int(vec), _build.stream_of(y))
    bn_epilogue.launches += 1
    bn_epilogue.ftz_launches += int(ftz)
    if raw is not None and q is not None:
        bn_epilogue.dual_launches += 1
    return raw, q


bn_epilogue.launches = 0
bn_epilogue.dual_launches = 0  # of those, the dual form (raw and q)
bn_epilogue.ftz_launches = 0   # of those, the FTZ route
