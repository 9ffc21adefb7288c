"""SFP / SLFP quantizer core in PyTorch (counterpart of the JAX ``ops/sfp.py``).

Fake-quantization semantics of the reference ``utils/sfp_quant.py``:

- ``qbit == 7``  -> SFP<3,3>: ``round(m*8)/8 * 2**e``.
- ``qbit == 8`` weights -> SLFP<3,4>: ``2**(e + round(log2(m)*16)/16)``.
- ``qbit == 8`` activations -> SLFP<3,4> with a linear pre-round
  ``m_q = round(m*16)/16`` before the log conversion.

Boundaries: ``|x| < 0.0625 -> 1e-10`` (pseudo-zero), ``[0.0625, 0.125) ->
0.125``, clamp at 15 (SFP<3,3>) / 15.32165 (SLFP<3,4>).

Everything is integer arithmetic on the float32 bit pattern plus exact
float32 tables, so results are bit-identical on every device and to the JAX
package.  :func:`act_bf16_bits` is the production activation quantizer (the
math every hand kernel inlines, ``csrc/slfp.cuh``); the ``float`` quantizers
serve the module path and weight freezing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PSEUDO_ZERO = np.float32(1e-10)
SFP33_MAX = np.float32(15.0)
# Reference clamp literal (sfp_quant.py:46), just below 2**(3 + 15/16).
SLFP34_CLAMP = np.float32(15.32165)
SFP44_MAX = np.float32(248.0)
SUBNORMAL_LO = np.float32(0.0625)
SUBNORMAL_HI = np.float32(0.125)

# float32(2**(i/16)), i = 0..16, derived in float64 and rounded once.
_EXP2_16 = (2.0 ** (np.arange(17, dtype=np.float64) / 16.0)).astype(np.float32)
# bin i of round(log2(m)*16) starts at m = 2**((i - 0.5)/16); irrational, so
# a plain >= comparison in float32 is exact.
_LOG_BIN_BOUNDS = (
    2.0 ** ((np.arange(1, 17, dtype=np.float64) - 0.5) / 16.0)
).astype(np.float32)
# ml correction for the linear->log mantissa conversion: bit j of the magic
# is round(16*log2(1 + j/16)) - j, which is 0 or 1.
_ML_MAGIC = sum(
    (int(np.round(16 * np.log2(1 + j / 16.0))) - j) << j for j in range(16))
assert _ML_MAGIC == 0x7FFC
# 23-bit mantissa field of float32(2**(ml/16)), ml = 0..15.
_P_TABLE = [int(v.view(np.int32)) & 0x007FFFFF for v in _EXP2_16[:16]]


def _bf16_bits(v: float) -> int:
    """bfloat16 bit pattern of float32(v), round-to-nearest-even."""
    return int(torch.tensor(float(np.float32(v)), dtype=torch.float32)
               .to(torch.bfloat16).view(torch.int16).item()) & 0xFFFF


def _f32_bits(v: float) -> int:
    return int(np.float32(v).view(np.int32))


# Constants of the bit-domain activation quantizer (JAX sfp.py:335-358).
# M7[j] = bf16 mantissa of 2**(round(16*log2(1+j/16))/16); D3[j] = M7[j] -
# 8j + 3 lies in [0, 15] and is stored as 16 nibbles in two int32 words.
_ML_OF_J = [int(np.round(16 * np.log2((16 + j) / 16.0))) for j in range(16)]
_M7 = [_bf16_bits(2.0 ** (ml / 16.0)) & 0x7F for ml in _ML_OF_J]
_D3 = [_M7[j] - 8 * j + 3 for j in range(16)]
assert all(0 <= d <= 15 for d in _D3), _D3


def _as_i32(v: int) -> int:
    return v - (1 << 32) if v >= 1 << 31 else v


D3_LO = _as_i32(sum(_D3[j] << (4 * j) for j in range(8)))
D3_HI = _as_i32(sum(_D3[j + 8] << (4 * j) for j in range(8)))
PZ16 = _bf16_bits(1e-10)
I32_LO = _f32_bits(0.0625)
I32_CLAMP_SLFP = _f32_bits(SLFP34_CLAMP)
I32_CLAMP_SFP33 = _f32_bits(15.0)
# smallest values whose mantissa round carries into exactly 0.125
I32_FLOOR_SLFP = _f32_bits(0.123046875)
I32_FLOOR_SFP33 = _f32_bits(0.12109375)


def recip_of(ka: float) -> float:
    """1/Ka as the JAX package computes it: ``1/float64(float32(ka))``.

    Callers multiply by ``float32(recip)``; any other rounding of 1/Ka can
    move a value across a quantization bin.
    """
    return float(1.0 / np.float64(np.float32(ka)))


# ---------------------------------------------------------------------------
# Float quantizers (module path, weight freezing).
# ---------------------------------------------------------------------------


_F32_TINY = float(np.finfo(np.float32).tiny)


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """float32 subnormals -> zero of the same sign.

    XLA on the CPU and the hand kernels (built with ``-ftz=true``) flush
    subnormal inputs and results of float arithmetic; the plain versions
    emulate that around each multiply so that all three agree bit for bit.
    """
    return torch.where(x.abs() < _F32_TINY, x * 0.0, x)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def _frexp_1_2(ax: torch.Tensor):
    """|x| -> (mantissa in [1, 2), exponent), exactly, for normal floats."""
    b = _bits(ax)
    e = (b >> 23) - 127
    m = ((b & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    return m, e


def _pow2i(e: torch.Tensor) -> torch.Tensor:
    """float32(2**e); garbage outside [-126, 127], discarded by callers."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


# the constant tables the quantizers index, by name
_TABLES = {
    "exp2_16": _EXP2_16,
    "log_bin_bounds": _LOG_BIN_BOUNDS,
    "pseudo_zero": np.asarray(PSEUDO_ZERO, np.float32),
    "p_table": np.asarray(_P_TABLE, np.int32),
}
_on_device: dict = {}


def _table(name: str, device) -> torch.Tensor:
    """Constant table ``name`` on ``device``, copied there once per device:
    a copy from host memory on every call would block the host until the
    card drained its queue."""
    key = (name, torch.device(device))
    t = _on_device.get(key)
    if t is None:
        # an ordinary tensor even when first asked for under inference_mode
        with torch.inference_mode(False):
            t = torch.from_numpy(_TABLES[name].copy()).to(device)
        _on_device[key] = t
    return t


def _apply_boundaries(ax, out, *, clamp, clamp_ge):
    pz = _table("pseudo_zero", ax.device)
    out = torch.where(ax < float(SUBNORMAL_LO), pz, out)
    out = torch.where((ax >= float(SUBNORMAL_LO)) & (ax < float(SUBNORMAL_HI)),
                      torch.full_like(out, float(SUBNORMAL_HI)), out)
    big = (ax >= float(clamp)) if clamp_ge else (ax > float(clamp))
    return torch.where(big, torch.full_like(out, float(clamp)), out)


def _sfp33_abs(ax):
    m, e = _frexp_1_2(ax)
    q = torch.round(m * 8.0) * 0.125
    return _apply_boundaries(ax, q * _pow2i(e), clamp=SFP33_MAX, clamp_ge=True)


def _slfp34_weight_abs(ax):
    m, e = _frexp_1_2(ax)
    bounds = _table("log_bin_bounds", ax.device)
    idx = (m.unsqueeze(-1) >= bounds).sum(-1)
    mq = _table("exp2_16", ax.device)[idx]
    return _apply_boundaries(ax, mq * _pow2i(e), clamp=SLFP34_CLAMP,
                             clamp_ge=False)


def _slfp34_act_abs(ax):
    m, e = _frexp_1_2(ax)
    j = (torch.round(m * 16.0) - 16.0).to(torch.int32)  # 0..16, exact
    ml = j + ((torch.full_like(j, _ML_MAGIC) >> j) & 1)
    mq = _table("exp2_16", ax.device)[ml.long()]
    return _apply_boundaries(ax, mq * _pow2i(e), clamp=SLFP34_CLAMP,
                             clamp_ge=False)


def _sfp44_abs(ax, bug_compat: bool):
    """|x| -> SFP<4,4> value (reference sfp_quant.py:105-127)."""
    m, e = _frexp_1_2(ax)
    q = torch.round(m * 16.0) * 0.0625
    # two steps keep 2**e a normal float for every exponent of a normal x
    out = torch.where(ax == 0, 0.0, (q * _pow2i(e + 64)) * 2.0**-64)
    if not bug_compat:
        lo, hi = 2.0**-8, 2.0**-7
        out = torch.where(ax < lo, _table("pseudo_zero", ax.device), out)
        out = torch.where((ax >= lo) & (ax < hi), hi, out)
    return torch.where(ax >= float(SFP44_MAX), float(SFP44_MAX), out)


def _signed(fn, x):
    x32 = flush_subnormals(x.to(torch.float32))
    # JAX's sign keeps the sign of zero (torch.sign(-0.0) is +0.0), so a
    # -0.0 input gives -0.0 times the quantized magnitude
    sign = torch.copysign(torch.sign(x32), x32)
    return (sign * fn(torch.abs(x32))).to(x.dtype)


class _STE(torch.autograd.Function):
    """Quantize forward, identity gradient (reference sfp_quant.py:50-53)."""

    @staticmethod
    def forward(ctx, x, fn):
        return _signed(fn, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


_WEIGHT_FN = {7: _sfp33_abs, 8: _slfp34_weight_abs}
# qbit 7 activations use the weight path (sfp_quant.py:63-78)
_ACT_FN = {7: _sfp33_abs, 8: _slfp34_act_abs}


def _quantize(x, qbit, table):
    if qbit == 32:
        return x
    if qbit not in table:
        raise ValueError(f"unsupported qbit {qbit} (expected 7, 8 or 32)")
    return _STE.apply(x, table[qbit])


def quantize_weight(x: torch.Tensor, qbit: int) -> torch.Tensor:
    """SFP<3,3> (qbit 7) / SLFP<3,4> (qbit 8) weights; qbit 32 passes."""
    return _quantize(x, qbit, _WEIGHT_FN)


def quantize_act(x: torch.Tensor, qbit: int) -> torch.Tensor:
    """SFP<3,3> (qbit 7) / SLFP<3,4> (qbit 8) activations; qbit 32 passes."""
    return _quantize(x, qbit, _ACT_FN)


def quantize_layerout(x: torch.Tensor, qbit: int, *,
                      bug_compat: bool = True) -> torch.Tensor:
    """SFP<4,4> layer outputs for any qbit <= 8; qbit 32 passes.

    ``bug_compat=True`` keeps the reference's dead subnormal branch
    (sfp_quant.py:122-123 writes ``2^(-8)``, an XOR); ``False`` applies the
    intended ``2**-8`` / ``2**-7`` thresholds.  Exact zero gives 0.0 where
    the reference gives NaN.
    """
    if qbit == 32:
        return x
    if qbit > 8:
        raise ValueError(f"unsupported qbit {qbit} (expected <=8 or 32)")
    return _STE.apply(x, functools.partial(_sfp44_abs, bug_compat=bug_compat))


# ---------------------------------------------------------------------------
# Bit-domain scale + quantize + bf16 cast (production activation quantizer).
# ---------------------------------------------------------------------------


def act_bf16_bits(x: torch.Tensor, recip: float, qbit: int,
                  nonneg: bool) -> torch.Tensor:
    """``quantize_act(x * recip, qbit)`` as bfloat16, in the f32 bit domain.

    Plain version of the hand kernel ``csrc/quantize.cu`` (K1) and of the
    quantize inlined in K2/K3; bit-equal to JAX ``_act_bf16_bits``.
    ``nonneg=True`` skips sign handling: the caller guarantees x >= 0 and
    never -0.0 (whose bit pattern would map to the pseudo-zero).
    """
    xs = flush_subnormals(flush_subnormals(x.to(torch.float32))
                          * torch.tensor(np.float32(recip), device=x.device))
    bits = xs.contiguous().view(torch.int32)
    a = bits if nonneg else bits & 0x7FFFFFFF
    if qbit == 8:
        am = torch.clamp(torch.clamp(a, max=I32_CLAMP_SLFP), min=I32_FLOOR_SLFP)
        # round-half-even of m*16 as a carry-propagating mantissa add
        t = am + (0x3FFFF + ((am >> 19) & 1))
        r4 = t >> 19                      # ((e+127)<<4) | j, carry included
        j = r4 & 15
        sel = torch.where(j >= 8, D3_HI, D3_LO).to(torch.int32)
        d = (sel >> ((j & 7) << 2)) & 15  # mask after the arithmetic shift
        out = (r4 << 3) + (d - 3)
    elif qbit == 7:
        am = torch.clamp(torch.clamp(a, max=I32_CLAMP_SFP33),
                         min=I32_FLOOR_SFP33)
        t = am + (0x7FFFF + ((am >> 20) & 1))
        out = (t >> 20) << 4
    else:
        raise ValueError(f"unsupported qbit {qbit} (expected 7 or 8)")
    small = torch.where(a == 0, 0, PZ16).to(torch.int32)
    out = torch.where(a < I32_LO, small, out)
    if not nonneg:
        out = out | ((bits >> 16) & 0x8000)
    # low 16 bits of the f32 pattern are zero, so this cast is exact
    return (out << 16).view(torch.float32).to(torch.bfloat16)


def slfp34_act_bits(x: torch.Tensor) -> torch.Tensor:
    """SLFP<3,4> activation quantize in the f32 bit domain, output in the
    input's dtype: plain version of K1's f32 form (JAX
    ``kernels/quantize.py::slfp34_act_bits``)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    sign = bits & _as_i32(0x80000000)
    ab = bits & 0x7FFFFFFF
    lsb = (ab >> 19) & 1
    r = (ab + 0x3FFFF + lsb) & -0x80000
    j = (r >> 19) & 15
    ml = j + ((torch.full_like(j, _ML_MAGIC) >> j) & 1)
    p = _table("p_table", x.device)[ml.long()]
    out = (r & -0x00800000) | p
    small = torch.where(ab == 0, 0, _f32_bits(1e-10)).to(torch.int32)
    out = torch.where(ab < I32_LO, small, out)
    out = torch.where((ab >= I32_LO) & (ab < _f32_bits(0.125)),
                      _f32_bits(0.125), out)
    out = torch.where(ab > I32_CLAMP_SLFP, I32_CLAMP_SLFP, out)
    return (out | sign).view(torch.float32).to(x.dtype)


class _FusedScaleQuantAct(torch.autograd.Function):
    """JAX ``fused_scale_quant_act_bf16`` (its ``custom_vjp``): K1 forward,
    STE backward ``dx = g * f32(recip)``."""

    @staticmethod
    def forward(ctx, x, recip, qbit, nonneg, out_dtype):
        # K1 on a CUDA tensor, its plain version on a CPU one (imported
        # here: kernels.quantize imports this module)
        from cnns_slfp_quantization_tpu_torch.kernels.quantize import (
            act_quantize)

        ctx.recip, ctx.x_dtype = recip, x.dtype
        return act_quantize(x, recip, qbit=qbit, nonneg=nonneg,
                            out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        # JAX's primal output is bf16, so its cotangent arrives rounded to
        # bf16; a float32 output holding bf16 values gets it unrounded
        g32 = g.to(torch.bfloat16).to(torch.float32)
        # a Python scalar holding the float32 value multiplies in float32
        dx = g32 * float(np.float32(ctx.recip))
        return dx.to(ctx.x_dtype), None, None, None, None


def fused_scale_quant_act_bf16(x: torch.Tensor, recip: float, qbit: int,
                               nonneg: bool = False,
                               out_dtype: torch.dtype = torch.bfloat16
                               ) -> torch.Tensor:
    """``bf16(quantize_act(x * recip, qbit))`` with JAX's STE gradient
    ``dx = bf16(g) * f32(recip)`` in x's dtype.  ``out_dtype=torch.float32``
    writes the bf16 values widened exactly (the operand cuDNN reads)."""
    return _FusedScaleQuantAct.apply(x, recip, qbit, nonneg, out_dtype)


# ---------------------------------------------------------------------------
# Codebook and real uint8 packing (sign | 3-bit exp | 4-bit log mantissa).
# ---------------------------------------------------------------------------


@functools.cache
def _codebook(fmt: str) -> np.ndarray:
    if fmt == "sfp33":
        vals = [(8 + m) / 8.0 * 2.0**e for e in range(-3, 4) for m in range(8)]
        vals = [v for v in vals if v <= 15.0] + [float(PSEUDO_ZERO)]
    elif fmt == "slfp34":
        # e = -4 exists in the bit format although the quantizer flushes it
        vals = [float(v) * 2.0**e for e in range(-4, 4) for v in _EXP2_16[:16]]
        vals += [float(SLFP34_CLAMP), float(PSEUDO_ZERO)]
    elif fmt == "sfp44":
        vals = [(16 + m) / 16.0 * 2.0**e for e in range(-8, 8)
                for m in range(16)]
        vals = [v for v in vals if v <= 248.0] + [float(PSEUDO_ZERO)]
    else:
        raise ValueError(fmt)
    return np.unique(np.asarray(sorted(vals), dtype=np.float32))


def codebook(fmt: str) -> np.ndarray:
    """All non-negative values of fmt in {"sfp33", "slfp34", "sfp44"},
    ascending, pseudo-zero included."""
    return _codebook(fmt).copy()


def pack_slfp34(q: torch.Tensor) -> torch.Tensor:
    """SLFP<3,4>-quantized float values -> uint8 codes.  The clamp literal
    15.32165 maps to the top code (which decodes to 15.3216522)."""
    x32 = q.to(torch.float32)
    sign = (x32 < 0).to(torch.int32) << 7
    ax = torch.abs(x32)
    m, e = _frexp_1_2(ax)
    idx = (m.unsqueeze(-1) >= _table("log_bin_bounds", q.device)).sum(-1)
    code7 = torch.clamp((e + 4) * 16 + idx.to(torch.int32), 0, 127)
    code7 = torch.where(ax < float(SUBNORMAL_HI), 0, code7)
    return (sign | code7).to(torch.uint8)


def unpack_slfp34(codes: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 SLFP<3,4> codes -> float values (0 for the zero code)."""
    c = codes.to(torch.int32)
    code7 = c & 0x7F
    sign = torch.where((c & 0x80) != 0, -1.0, 1.0)
    val = _table("exp2_16", codes.device)[(code7 & 15).long()] * _pow2i(
        (code7 >> 4) - 4)
    val = torch.where(code7 == 0, 0.0, val)
    return (sign * val).to(dtype)


def slfp34_decode_bits(codes: torch.Tensor) -> torch.Tensor:
    """uint8 SLFP<3,4> codes -> exact float32 values, built as bits (the
    decode K2 runs while staging weights; JAX ``fused_matmul.py:39-48``)."""
    c = codes.to(torch.int32)
    code7 = c & 0x7F
    sign = torch.where((c & 0x80) != 0, _as_i32(0x80000000), 0).to(torch.int32)
    p = _table("p_table", codes.device)
    bits = (((code7 >> 4) - 4 + 127) << 23) | p[(code7 & 15).long()]
    bits = torch.where(code7 == 0, 0, bits).to(torch.int32)
    return (bits | sign).view(torch.float32)


def pack_sfp33(q: torch.Tensor) -> torch.Tensor:
    """SFP<3,3>-quantized float values -> uint8 codes (sign | 3-bit exp |
    3-bit mantissa in the low 7 bits)."""
    x32 = q.to(torch.float32)
    sign = (x32 < 0).to(torch.int32) << 6
    ax = torch.abs(x32)
    m, e = _frexp_1_2(ax)
    mant = torch.round(m * 8.0).to(torch.int32)   # 8..16; 16 carries into e
    code6 = torch.clamp((e + 4) * 8 + (mant - 8), 0, 63)
    code6 = torch.where(ax < float(SUBNORMAL_HI), 0, code6)
    return (sign | code6).to(torch.uint8)


def unpack_sfp33(codes: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 SFP<3,3> codes -> float values (0 for the zero code)."""
    c = codes.to(torch.int32)
    code6 = c & 0x3F
    sign = torch.where((c & 0x40) != 0, -1.0, 1.0)
    mant = (8 + (code6 & 7)).to(torch.float32) * 0.125
    val = torch.where(code6 == 0, 0.0, mant * _pow2i((code6 >> 3) - 4))
    return (sign * val).to(dtype)
