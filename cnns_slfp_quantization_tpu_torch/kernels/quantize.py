"""K1: standalone SLFP activation quantize (hand kernel ``csrc/quantize.cu``).

Counterpart of the Pallas kernel ``kernels/quantize.py::slfp34_act_quantize``
and of its production form ``ops/sfp.py::_act_bf16_bits`` as the JAX
executor runs it (``kernels/qmm.py::quantize_act_pass``).  A CUDA tensor
goes through the hand kernel; a CPU tensor through the plain version
(:func:`act_quantize_plain`, :func:`slfp34_act_quantize_plain`).
"""

from __future__ import annotations

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch.kernels import _build
from cnns_slfp_quantization_tpu_torch.ops import sfp

_DTYPES = (torch.float32, torch.bfloat16)


def act_quantize_plain(x: torch.Tensor, recip: float, *, qbit: int = 8,
                       nonneg: bool = True,
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    return sfp.act_bf16_bits(x, recip, qbit, nonneg).to(out_dtype)


def act_quantize(x: torch.Tensor, recip: float, *, qbit: int = 8,
                 nonneg: bool = True,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``bf16(quantize_act(x * recip, qbit))`` for f32 or bf16 x, any shape.

    ``nonneg=True`` skips sign handling (x >= 0 and never -0.0).
    ``out_dtype=torch.float32`` writes the same bf16 values widened
    exactly: the operand cuDNN and the plain matmuls read, with no copy in
    between.  The kernel takes its FTZ route when ``recip`` is not
    subnormal (``ftz_launches`` counts those launches), else the exact one.
    """
    if x.device.type == "cpu":
        return act_quantize_plain(x, recip, qbit=qbit, nonneg=nonneg,
                                  out_dtype=out_dtype)
    if (x.dtype not in _DTYPES or out_dtype not in _DTYPES
            or qbit not in (7, 8)):
        raise ValueError(f"act_quantize: dtype {x.dtype} -> {out_dtype}, "
                         f"qbit {qbit}")
    _build.check_cuda(x)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    ftz = _build.normal_scalar(recip)
    _build.launch("quantize", "slfp_quantize", x.data_ptr(),
                  int(x.dtype == torch.bfloat16), out.data_ptr(),
                  int(out_dtype == torch.float32), x.numel(),
                  float(np.float32(recip)), qbit, int(nonneg), int(ftz),
                  int(_build.aligned16(x, out)), _build.stream_of(x))
    act_quantize.launches += 1
    act_quantize.ftz_launches += int(ftz)
    return out


act_quantize.launches = 0
act_quantize.ftz_launches = 0   # of the launches, those on the FTZ route


def slfp34_act_quantize_plain(x: torch.Tensor) -> torch.Tensor:
    return sfp.slfp34_act_bits(x)


def slfp34_act_quantize(x: torch.Tensor) -> torch.Tensor:
    """SLFP<3,4> activation quantize, output in x's dtype (f32 or bf16):
    the Pallas kernel's own form."""
    if x.device.type == "cpu":
        return slfp34_act_quantize_plain(x)
    if x.dtype not in _DTYPES:
        raise ValueError(f"slfp34_act_quantize: dtype {x.dtype}")
    _build.check_cuda(x)
    out = torch.empty_like(x)
    _build.launch("quantize", "slfp_quantize_f32form", x.data_ptr(),
                  int(x.dtype == torch.bfloat16), out.data_ptr(), x.numel(),
                  int(_build.aligned16(x, out)), _build.stream_of(x))
    slfp34_act_quantize.launches += 1
    return out


slfp34_act_quantize.launches = 0


def _f32_bits(v: float) -> int:
    return int(np.float32(v).view(np.int32))


def slfp34_pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Quantize + encode to uint8 SLFP<3,4> codes (sign | 3-bit exponent |
    4-bit log mantissa) in one pass, in the float32 bit domain: a plain
    function, as JAX ``kernels/quantize.py::slfp34_pack_bits`` is (its codes
    bit for bit).  ``sfp.slfp34_decode_bits`` reads them back."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    sign7 = (bits >> 24) & 0x80
    ab = bits & 0x7FFFFFFF
    lsb = (ab >> 19) & 1
    r = (ab + 0x3FFFF + lsb) & -0x80000
    j = (r >> 19) & 15
    ml = j + ((sfp._ML_MAGIC >> j) & 1)
    e = (r >> 23) - 127  # unbiased exponent
    code7 = torch.clamp((e + 4) * 16 + ml, 0, 127)
    code7 = torch.where(ab < _f32_bits(0.125), 16, code7)  # subnormal floor
    code7 = torch.where(ab < _f32_bits(0.0625), 0, code7)  # pseudo-zero
    code7 = torch.where(ab > _f32_bits(15.32165), 127, code7)
    return (sign7 | code7).to(torch.uint8)
