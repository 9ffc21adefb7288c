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
``quantize_act_pass``).
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
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=y.device)
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
                      emit_raw=True, quant_recip=None):
    v = epilogue_value_plain(y, scale, shift, identity, relu)
    raw = v.to(torch.bfloat16)
    q = None
    if quant_recip is not None:
        q = sfp.act_bf16_bits(raw if emit_raw else v, quant_recip, 8, relu)
    return (raw if emit_raw else None), q


def bn_epilogue(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                identity: Optional[torch.Tensor] = None, relu: bool = True,
                emit_raw: bool = True, quant_recip: Optional[float] = None):
    """(raw, q) for y f32 [..., C]; either is None when not asked for.

    identity: bf16 [..., C] residual; scale/shift: f32 [C];
    quant_recip: 1/Ka of the consumer, None for no quantized output.
    """
    if not emit_raw and quant_recip is None:
        raise ValueError("bn_epilogue: nothing to emit")
    if y.device.type == "cpu":
        return bn_epilogue_plain(y, scale, shift, identity=identity,
                                 relu=relu, emit_raw=emit_raw,
                                 quant_recip=quant_recip)
    c = y.shape[-1]
    if (y.dtype != torch.float32 or scale.dtype != torch.float32
            or shift.dtype != torch.float32 or scale.shape != (c,)
            or shift.shape != (c,)
            or (identity is not None and (identity.dtype != torch.bfloat16
                                          or identity.shape != y.shape))):
        raise ValueError("bn_epilogue: y f32 [..., C], scale/shift f32 [C], "
                         "identity bf16 like y")
    _build.check_cuda(y, scale, shift, identity)
    raw = (torch.empty(y.shape, dtype=torch.bfloat16, device=y.device)
           if emit_raw else None)
    q = (torch.empty(y.shape, dtype=torch.bfloat16, device=y.device)
         if quant_recip is not None else None)
    vec = c % 8 == 0 and _build.aligned16(y, scale, shift, identity, raw, q)
    _build.launch(
        "epilogue", "slfp_epilogue", y.data_ptr(),
        None if identity is None else identity.data_ptr(),
        scale.data_ptr(), shift.data_ptr(),
        None if raw is None else raw.data_ptr(),
        None if q is None else q.data_ptr(),
        y.numel() // max(c, 1), c,
        float(np.float32(quant_recip if quant_recip is not None else 1.0)),
        int(relu), int(vec), _build.stream_of(y))
    bn_epilogue.launches += 1
    if raw is not None and q is not None:
        bn_epilogue.dual_launches += 1
    return raw, q


bn_epilogue.launches = 0
bn_epilogue.dual_launches = 0  # of those, the dual form (raw and q)
