"""SLFP<3,4> fake quantizers in plain PyTorch, for the benchmark's reference.

Frozen copy of the float quantizers of the port's ``ops/sfp.py``
(``_frexp_1_2``, ``_slfp34_weight_abs``, ``_slfp34_act_abs``, ``_signed``
and the STE), which follow the reference repository's
``utils/sfp_quant.py``:

- weights: ``2**(e + round(log2(m) * 16) / 16)``;
- activations: the mantissa first rounded linearly, ``m_q = round(m * 16) /
  16``, then converted to the log form;
- ``|x| < 0.0625 -> 1e-10`` (pseudo-zero), ``[0.0625, 0.125) -> 0.125``,
  clamp at 15.32165.

Copied so that the yardstick does not move when the port's quantizers do.
"""

from __future__ import annotations

import numpy as np
import torch

PSEUDO_ZERO = 1e-10
SLFP34_CLAMP = float(np.float32(15.32165))
SUBNORMAL_LO = 0.0625
SUBNORMAL_HI = 0.125
_F32_TINY = float(np.finfo(np.float32).tiny)

# float32(2**(i/16)), i = 0..16, derived in float64 and rounded once
_EXP2_16 = (2.0 ** (np.arange(17, dtype=np.float64) / 16.0)).astype(np.float32)
# bin i of round(log2(m)*16) starts at m = 2**((i - 0.5)/16)
_LOG_BIN_BOUNDS = (
    2.0 ** ((np.arange(1, 17, dtype=np.float64) - 0.5) / 16.0)
).astype(np.float32)
# bit j: round(16*log2(1 + j/16)) - j, the linear -> log mantissa step
_ML_MAGIC = sum(
    (int(np.round(16 * np.log2(1 + j / 16.0))) - j) << j for j in range(16))


def _frexp_1_2(ax: torch.Tensor):
    """|x| -> (mantissa in [1, 2), exponent), exactly, for normal floats."""
    b = ax.to(torch.float32).contiguous().view(torch.int32)
    e = (b >> 23) - 127
    m = ((b & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    return m, e


def _pow2i(e: torch.Tensor) -> torch.Tensor:
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def _boundaries(ax, out):
    out = torch.where(ax < SUBNORMAL_LO, torch.full_like(out, PSEUDO_ZERO),
                      out)
    out = torch.where((ax >= SUBNORMAL_LO) & (ax < SUBNORMAL_HI),
                      torch.full_like(out, SUBNORMAL_HI), out)
    return torch.where(ax > SLFP34_CLAMP, torch.full_like(out, SLFP34_CLAMP),
                       out)


def _weight_abs(ax):
    m, e = _frexp_1_2(ax)
    bounds = torch.from_numpy(_LOG_BIN_BOUNDS).to(ax.device)
    idx = (m.unsqueeze(-1) >= bounds).sum(-1)
    mq = torch.from_numpy(_EXP2_16).to(ax.device)[idx]
    return _boundaries(ax, mq * _pow2i(e))


def _act_abs(ax):
    m, e = _frexp_1_2(ax)
    j = (torch.round(m * 16.0) - 16.0).to(torch.int32)
    ml = j + ((torch.full_like(j, _ML_MAGIC) >> j) & 1)
    mq = torch.from_numpy(_EXP2_16).to(ax.device)[ml.long()]
    return _boundaries(ax, mq * _pow2i(e))


def _signed(fn, x):
    x32 = x.to(torch.float32)
    x32 = torch.where(x32.abs() < _F32_TINY, x32 * 0.0, x32)
    sign = torch.copysign(torch.sign(x32), x32)
    return sign * fn(torch.abs(x32))


class _STE(torch.autograd.Function):
    """Quantize forward, identity gradient."""

    @staticmethod
    def forward(ctx, x, fn):
        return _signed(fn, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def quantize_weight(x: torch.Tensor) -> torch.Tensor:
    """SLFP<3,4> weight quantize (float32), straight-through gradient."""
    return _STE.apply(x, _weight_abs)


def quantize_act(x: torch.Tensor) -> torch.Tensor:
    """SLFP<3,4> activation quantize (float32), straight-through gradient."""
    return _STE.apply(x, _act_abs)
