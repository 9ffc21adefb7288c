"""K4: act-quantize -> weight decode -> bf16 GEMM -> scaled epilogue (hand
kernel ``csrc/fused_matmul.cu``).

Counterpart of the Pallas kernel ``kernels/fused_matmul.py::
fused_quant_matmul``, the packed-uint8 serving substrate of the module
path: weights stay in device memory as SLFP<3,4> codes and are decoded
inside the kernel.  It computes, as the Pallas body ``_matmul_kernel``:

    out = act((Q_a(x/ka) @ decode(W) [+ b * f32(1/(ka*kw))]) * f32(ka*kw))

with ``ka*kw`` the float64 product of the two Python floats, and
:func:`quant_dense` / :func:`quant_conv1x1` around it for the layers.  The
public functions keep JAX's ``[K, N]`` weight contract; the kernel reads
either a contiguous ``[K, N]`` tensor or the transpose of a contiguous
``[N, K]`` one (the OIHW / ``[out, in]`` storage of the port's layers, so
the layers hand over ``weight.t()`` and nothing is copied per call).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch.kernels import _build, _gemm_plan
from cnns_slfp_quantization_tpu_torch.ops import sfp

_X_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _consts(ka: float, kw: float):
    """(1/Ka for the quantizer, f32(1/(ka*kw)), f32(ka*kw)), as the Pallas
    body computes them from Python floats."""
    kaw = float(ka) * float(kw)
    return 1.0 / float(ka), np.float32(1.0 / kaw), np.float32(kaw)


def _weight_values(w: torch.Tensor) -> torch.Tensor:
    """bf16 weight values: uint8 codes decoded, float values rounded."""
    if w.dtype == torch.uint8:
        return sfp.slfp34_decode_bits(w).to(torch.bfloat16)
    return w.to(torch.bfloat16)


def fused_quant_matmul_plain(x, w, *, ka, kw, bias=None, act=None,
                             quantize_x=True, nonneg=False,
                             out_dtype=torch.float32):
    """Plain version of K4 on x ``[M, K]``, w ``[K, N]``."""
    recip, c_bias, c_scale = _consts(ka, kw)
    if quantize_x:
        xq = sfp.act_bf16_bits(x, recip, 8, nonneg)
    else:
        xq = x.to(torch.bfloat16)
    # bf16 products are exact in f32; only the order of the sums differs
    # from the kernel's
    y = sfp.flush_subnormals(xq.to(torch.float32)
                             @ _weight_values(w).to(torch.float32))
    if bias is not None:
        b = sfp.flush_subnormals(bias.to(torch.float32))
        y = sfp.flush_subnormals(y + sfp.flush_subnormals(
            b * torch.tensor(c_bias, device=x.device)))
    y = sfp.flush_subnormals(y * torch.tensor(c_scale, device=x.device))
    if act == "relu":
        y = torch.where(y > 0, y, 0.0)
    return y.to(out_dtype)


def _check_args(w, bias, act, out_dtype):
    if act not in (None, "relu"):
        raise ValueError(f"act {act!r}: None or 'relu'")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype}: float32 or bfloat16")
    if w.dim() != 2 or (bias is not None and bias.shape != (w.shape[1],)):
        raise ValueError(f"w must be [K, N] and bias [N]; got "
                         f"{tuple(w.shape)}, "
                         f"{None if bias is None else tuple(bias.shape)}")


def _up8(v: int) -> int:
    return -(-v // 8) * 8


def pad_weight(w, bias):
    """K4's weight operand for any K and N: w ``[K, N]`` (values or codes)
    into a contiguous ``[K', N']`` tensor and bias into ``[N']``, K' and N'
    the next multiples of 8, padded with zeros (zero weights or codes add
    exact zeros to every sum).  A weight whose K and N are multiples of 8
    is returned as it is.  The layers pad their frozen weights once
    (``ops/layers.py::k4_args``)."""
    k, n = w.shape
    if not (k % 8 or n % 8):
        return w, bias
    wp = w.new_zeros((_up8(k), _up8(n)))
    wp[:k, :n] = w
    if bias is not None:
        bias = torch.cat([bias, bias.new_zeros(_up8(n) - n)])
    return wp, bias


def pad_x(x4, k):
    """x4 ``[B, H, W, K0]`` as the kernel reads it against a weight of K
    rows: where K0 != K or a row stride of x4 is not a multiple of 8,
    x4's channels copied into a contiguous tensor of K channels, zeros
    beyond K0 (a per-call copy: ShuffleNetV2's channel halves)."""
    if x4.shape[-1] == k and not any(st % 8 for st in x4.stride()[:3]):
        return x4
    xp = x4.new_zeros((*x4.shape[:3], k))
    xp[..., :x4.shape[-1]] = x4
    return xp


def pad_to_8(x4, w, bias):
    """Operands the kernel takes, for any K and N: w and bias padded by
    :func:`pad_weight` (unless they are already), x4 by :func:`pad_x`.
    Returns (x4, w, bias, N); the caller keeps the output's first N
    columns.  ShuffleNetV2's 58- and 116-channel layers need it."""
    n = w.shape[1]
    w, bias = pad_weight(w, bias)
    return pad_x(x4, w.shape[0]), w, bias, n


def _matmul(x4, w, *, ka, kw, bias, act, quantize_x, nonneg, out_dtype,
            n_out=None):
    """K4 over the rows of x4 ``[B, H, W, K]``; returns ``[B*H*W, N]``, or
    its first ``n_out`` columns where w and bias come padded by
    :func:`pad_weight` (x4 then has the unpadded K, or K' channels)."""
    _check_args(w, bias, act, out_dtype)
    if x4.device.type == "cpu":
        if n_out is not None:      # the plain version takes any K and N
            w = w[:x4.shape[-1], :n_out]
            bias = None if bias is None else bias[:n_out]
        return fused_quant_matmul_plain(
            x4.reshape(-1, x4.shape[-1]), w, ka=ka, kw=kw, bias=bias,
            act=act, quantize_x=quantize_x, nonneg=nonneg,
            out_dtype=out_dtype)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x4, w, bias)):
        # the float-weight route differentiates through _DiffMatmul, whose
        # forward runs with the gradient off
        raise NotImplementedError(
            "fused_quant_matmul has a backward only for float weights with "
            "act=None (quant_dense / quant_conv1x1, as JAX's _diff_matmul); "
            "uint8 codes, act and pre-padded weights are inference-only: "
            "call it under torch.no_grad()")
    if w.dtype == torch.float32:  # pre-quantized values: bf16, as the Pallas body casts
        w = w.to(torch.bfloat16)
    x4, w, bias, n = pad_to_8(x4, w, bias)
    n_out = n_out or n
    nb, h, wd, k = x4.shape
    k2, n = w.shape
    w_nk, w_store = _gemm_plan.weight_storage(w, "fused_quant_matmul")
    sb, sh, sw, sc = x4.stride()
    if (k != k2 or k % 8 or n % 8 or x4.dtype not in _X_DTYPES
            or w.dtype not in (torch.bfloat16, torch.uint8)
            or (bias is not None and bias.dtype != torch.float32)
            or sc != 1 or sb % 8 or sh % 8 or sw % 8):
        raise ValueError(
            f"fused_quant_matmul: x {tuple(x4.shape)} {x4.dtype} strides "
            f"{x4.stride()}, w {tuple(w.shape)} {w.dtype}; needs f32/bf16 x "
            f"with contiguous channels and row strides multiple of 8, "
            f"uint8/bf16 w, K and N multiples of 8, f32 bias [N]")
    _build.check_cuda(w_store, bias)
    if x4.device != w_store.device:
        raise ValueError(f"kernel operands must share one CUDA device, got "
                         f"{x4.device} and {w_store.device}")
    m = nb * h * wd
    out = torch.empty((m, n), dtype=out_dtype, device=x4.device)
    if not _build.aligned16(x4, w_store, bias, out):
        raise ValueError("fused_quant_matmul: operands must be 16-byte "
                         "aligned")
    recip, c_bias, c_scale = _consts(ka, kw)
    try:  # rows at one pitch: x goes by TMA
        a_pitch = x4.view(m, k).stride(0)
    except RuntimeError:
        a_pitch = 0
    tiles = _gemm_plan.plan(m, k, n)
    ws = _gemm_plan.workspace(tiles, m, n, x4.device)
    _build.launch(
        "fused_matmul", "slfp_fused_matmul", x4.data_ptr(),
        int(x4.dtype == torch.float32), h * wd, wd, sb, sh, sw, a_pitch,
        w_store.data_ptr(), int(w.dtype == torch.uint8), int(w_nk),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.float32), m, k, n, int(quantize_x),
        float(np.float32(recip)), int(nonneg), float(c_bias), float(c_scale),
        int(act == "relu"), *tiles, None if ws is None else ws.data_ptr(),
        _build.stream_of(x4))
    fused_quant_matmul.launches += 1
    return out if n_out == n else out[:, :n_out]


def fused_quant_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    ka: float,
    kw: float,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    quantize_x: bool = True,
    nonneg: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``act((Q_a(x/ka) @ decode(w) + b * f32(1/(ka*kw))) * f32(ka*kw))``.

    x ``[M, K]`` f32/bf16 with contiguous rows; w ``[K, N]`` uint8 SLFP<3,4>
    codes or float values (bf16, or f32 rounded to bf16), contiguous or the
    transpose of a contiguous ``[N, K]``; bias f32 ``[N]``; act None or
    ``"relu"``.  ``nonneg=True`` quantizes without sign handling (x >= 0 and
    never -0.0).  K and N must be multiples of 8 on the card.
    """
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    return _matmul(x[:, None, None, :], w, ka=ka, kw=kw, bias=bias, act=act,
                   quantize_x=quantize_x, nonneg=nonneg, out_dtype=out_dtype)


fused_quant_matmul.launches = 0


class _DiffMatmul(torch.autograd.Function):
    """JAX ``_diff_matmul``: K4 forward (its plain version on the CPU), the
    analytic STE backward in float32 with identity through Q_a:

        dx = (g @ w^T) * f32(kw)                     in x's dtype
        dw = (Q_a(x/ka)^T @ g) * f32(ka*kw)          in w's dtype
        db = sum of g over the rows

    ``Q_a(x/ka)`` is recomputed by K1 on the card.  The products are
    ``torch.matmul``, as JAX leaves them to XLA.  x4 ``[B, H, W, K]`` (a
    strided view carries dx back to its positions), w ``[K, N]`` float
    values unpadded: the forward pads for the kernel where K or N is not a
    multiple of 8, so dw reaches the layer's own weight."""

    @staticmethod
    def forward(ctx, x4, w, bias, ka, kw, nonneg, out_dtype):
        ctx.save_for_backward(x4, w)
        ctx.consts = (ka, kw, nonneg)
        return _matmul(x4, w, ka=ka, kw=kw, bias=bias, act=None,
                       quantize_x=True, nonneg=nonneg, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        from cnns_slfp_quantization_tpu_torch.kernels.quantize import (
            act_quantize)

        x4, w = ctx.saved_tensors
        ka, kw, nonneg = ctx.consts
        recip, _, c_scale = _consts(ka, kw)
        gf = g.to(torch.float32)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # Python scalars holding float32 values multiply in float32
            dx = (gf @ w.to(torch.float32).t()) * float(np.float32(kw))
            dx = dx.reshape(x4.shape).to(x4.dtype)
        if ctx.needs_input_grad[1]:
            x2 = x4.reshape(-1, x4.shape[-1]).contiguous()
            xq = act_quantize(x2, recip, qbit=8, nonneg=nonneg,
                              out_dtype=torch.float32)
            dw = (xq.t() @ gf) * float(c_scale)
            dw = dw.to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = gf.sum(dim=0)
        return dx, dw, db, None, None, None, None


def _k4(x4, w, *, ka, kw, bias, act, nonneg, out_dtype, n_out):
    """K4 over x4's rows for the layers: float weights with act=None and no
    pre-padding go through the differentiable form, as JAX's quant_dense
    sends them through ``_diff_matmul``; the rest are inference-only."""
    bias = _dense_bias(w, bias, act, x4.device)
    if w.dtype != torch.uint8 and act is None and n_out is None:
        return _DiffMatmul.apply(x4, w, bias, ka, kw, nonneg, out_dtype)
    return _matmul(x4, w, ka=ka, kw=kw, bias=bias, act=act, quantize_x=True,
                   nonneg=nonneg, out_dtype=out_dtype, n_out=n_out)


def _dense_bias(w, bias, act, device):
    """JAX's float-weight dense route (``_diff_matmul``) always passes a
    bias, zeros when there is none, which turns a -0.0 sum into +0.0; the
    uint8 route passes none.  Both kept, so that packed == float-frozen
    holds exactly where it holds in JAX."""
    if bias is None and act is None and w.dtype != torch.uint8:
        return torch.zeros(w.shape[-1], dtype=torch.float32, device=device)
    return bias


def quant_dense(x, w, *, ka, kw, bias=None, act=None, nonneg=False,
                out_dtype=torch.float32, n_out=None):
    """Dense layer on packed / pre-quantized weights; x ``[..., K]``,
    w ``[K, N]``, or w and bias padded by :func:`pad_weight` and
    ``n_out`` the N the output keeps."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = _k4(x2[:, None, None, :], w, ka=ka, kw=kw, bias=bias, act=act,
            nonneg=nonneg, out_dtype=out_dtype, n_out=n_out)
    return y.reshape(*lead, y.shape[-1])


def quant_conv1x1(x_nhwc, w, *, ka, kw, bias=None, act=None, stride: int = 1,
                  nonneg: bool = False, out_dtype=torch.float32, n_out=None):
    """1x1 convolution on packed / pre-quantized weights; x NHWC, w
    ``[Cin, Cout]`` (or padded, as :func:`quant_dense` takes it).  A stride
    is a strided view of x, read by the kernel in place."""
    if stride != 1:
        x_nhwc = x_nhwc[:, ::stride, ::stride, :]
    b, h, w_, _ = x_nhwc.shape
    y = _k4(x_nhwc, w, ka=ka, kw=kw, bias=bias, act=act, nonneg=nonneg,
            out_dtype=out_dtype, n_out=n_out)
    return y.reshape(b, h, w_, y.shape[-1])
