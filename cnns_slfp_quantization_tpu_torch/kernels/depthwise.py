"""K5: stride-1 depthwise 3x3 conv with its epilogue (hand kernel
``csrc/depthwise.cu``).

Counterpart of the Pallas kernel ``kernels/depthwise.py::dw3x3``: on NHWC x
with per-channel taps ``w [3, 3, C]`` and SAME padding it computes, per
output element,

    acc = fma(x[i, j], w[i, j], acc)   for (i, j) = (0, 0), (0, 1), ..., (2, 2)
    v   = relu?(fma(acc, scale, shift))
    out = act_bf16_bits(v, quant_out_recip, 8, relu or nonneg_in)  (quantize)
          or v                                                     (otherwise)

in ``out_dtype``, every float operation rounded once and subnormals flushed
(``csrc/slfp.cuh``).  The fused MobileNetV1 executor runs it at each
stride-1 depthwise site as conv -> BN -> ReLU -> the pointwise conv's
quantize in one pass.

The kernel has two routes with the same bits: flushes folded into the
FTZ forms of the float instructions, taken when :func:`ftz_route` finds no
subnormal tap, scale, shift or reciprocal, and the exact route with
explicit flushes.  A caller that serves the same operands again (the
fused executor) decides the route once and passes it as ``ftz``.  :func:`plan` sizes its blocks per
shape.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cnns_slfp_quantization_tpu_torch.kernels import _build
from cnns_slfp_quantization_tpu_torch.kernels.epilogue import (
    affine_f32,
    epilogue_value_plain,
)
from cnns_slfp_quantization_tpu_torch.ops import sfp

_DTYPES = (torch.float32, torch.bfloat16)
_VEC = 4               # channels per thread of csrc/depthwise.cu
_THREADS = 256         # threads per block, at most
_MAX_ROWS = 16         # output rows per band, at most


class Plan(NamedTuple):
    """A block of ``cg`` channel groups of 4 by ``tw`` output columns walks
    a band of ``rows`` output rows (csrc/depthwise.cu)."""
    cg: int
    tw: int
    rows: int


def _pow2ceil(v: int) -> int:
    return 1 << (v - 1).bit_length()


@functools.lru_cache(maxsize=None)
def plan(h: int, w: int, c: int) -> Plan:
    """The block shape for an ``[N, h, w, c]`` input: up to 32 channel
    groups (a warp on one pixel's channels, or on whole pixels where C is
    narrow), the columns split evenly over as few tiles as the 256 threads
    allow, more channel groups where the columns are few, and the rows in
    even bands of at most 16."""
    groups = -(-c // _VEC)
    cg = min(_pow2ceil(groups), 32)
    tiles = -(-w // (_THREADS // cg))
    tw = -(-w // tiles)
    cg = min(_pow2ceil(groups), 1 << ((_THREADS // tw).bit_length() - 1))
    bands = -(-h // _MAX_ROWS)
    return Plan(cg, tw, -(-h // bands))


def ftz_route(w: torch.Tensor, scale: Optional[torch.Tensor],
              shift: Optional[torch.Tensor],
              quant_out_recip: Optional[float]) -> bool:
    """Whether K5 may fold its flushes into FTZ instructions: exact when no
    tap, scale, shift or reciprocal is subnormal (None: the wrapper's own
    ones and zeros)."""
    return (_build.normal_scalar(quant_out_recip or 0.0)
            and all(_build.no_subnormal(t) for t in (w, scale, shift)
                    if t is not None))


def dw3x3_plain(x, w, scale, shift, *, relu=False, quant_out_recip=None,
                nonneg_in=False, out_dtype=torch.bfloat16):
    """Plain version of K5: nine single-rounding FMAs in the kernel's order
    (``affine_f32`` per tap), then K3's epilogue value and the quantize."""
    n, h, wd, _ = x.shape
    xp = F.pad(sfp.flush_subnormals(x.to(torch.float32)), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(3):
        for j in range(3):
            acc = affine_f32(xp[:, i:i + h, j:j + wd, :], w[i, j], acc)
    v = epilogue_value_plain(acc, scale, shift, None, relu)
    if quant_out_recip is not None:
        v = sfp.act_bf16_bits(v, quant_out_recip, 8, relu or nonneg_in)
    return v.to(out_dtype)


def dw3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    relu: bool = False,
    quant_out_recip: Optional[float] = None,
    nonneg_in: bool = False,
    out_dtype: torch.dtype = torch.bfloat16,
    ftz: Optional[bool] = None,
) -> torch.Tensor:
    """``epilogue(dw_conv3x3(x, w))`` for stride 1, SAME padding.

    x ``[N, H, W, C]`` f32 or bf16; w ``[3, 3, C]`` f32 taps; scale/shift
    f32 ``[C]`` (folded BN times Ka*Kw), 1 and 0 when not given;
    quant_out_recip: 1/Ka of the consumer's quantize, None for none;
    ``nonneg_in``: the quantize may skip sign handling without ReLU;
    ``ftz``: the route, :func:`ftz_route` of these operands as the caller
    found it, or None to check them now (a device sync).
    """
    if x.dim() != 4:
        raise ValueError(f"dw3x3: x must be [N, H, W, C], got {tuple(x.shape)}")
    n, h, wd, c = x.shape
    given = (scale, shift)
    if scale is None:
        scale = torch.ones(c, dtype=torch.float32, device=x.device)
    if shift is None:
        shift = torch.zeros(c, dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return dw3x3_plain(x, w, scale, shift, relu=relu,
                           quant_out_recip=quant_out_recip,
                           nonneg_in=nonneg_in, out_dtype=out_dtype)
    if (x.dtype not in _DTYPES or out_dtype not in _DTYPES
            or w.dtype != torch.float32 or w.shape != (3, 3, c)
            or scale.dtype != torch.float32 or shift.dtype != torch.float32
            or scale.shape != (c,) or shift.shape != (c,)):
        raise ValueError(
            f"dw3x3: x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)} "
            f"{w.dtype}; needs f32/bf16 x, f32 w [3, 3, C], f32 scale/shift "
            f"[C], f32/bf16 out")
    _build.check_cuda(x, w, scale, shift)
    if ftz is None:
        ftz = ftz_route(w, *given, quant_out_recip)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    vec = c % _VEC == 0 and _build.aligned16(x, out, w, scale, shift)
    _build.launch(
        "depthwise", "slfp_dw3x3", x.data_ptr(), int(x.dtype == torch.bfloat16),
        w.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.float32), n, h, wd, c, int(relu),
        int(quant_out_recip is not None),
        float(np.float32(quant_out_recip or 1.0)), int(nonneg_in), int(vec),
        int(ftz), *plan(h, wd, c), _build.stream_of(x))
    dw3x3.launches += 1
    dw3x3.ftz_launches += int(ftz)
    return out


dw3x3.launches = 0
dw3x3.ftz_launches = 0   # of the launches, those on the FTZ route
