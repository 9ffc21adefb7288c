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


def _matmul(x4, w, *, ka, kw, bias, act, quantize_x, nonneg, out_dtype):
    """K4 over the rows of x4 ``[B, H, W, K]``; returns ``[B*H*W, N]``."""
    _check_args(w, bias, act, out_dtype)
    if x4.device.type == "cpu":
        return fused_quant_matmul_plain(
            x4.reshape(-1, x4.shape[-1]), w, ka=ka, kw=kw, bias=bias,
            act=act, quantize_x=quantize_x, nonneg=nonneg,
            out_dtype=out_dtype)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x4, w, bias)):
        raise NotImplementedError(
            "fused_quant_matmul has no backward on the card yet (the STE "
            "backward is ROADMAP work); call it under torch.no_grad()")
    if w.dtype == torch.float32:  # pre-quantized values: bf16, as the Pallas body casts
        w = w.to(torch.bfloat16)
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
    return out


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


def _dense_bias(w, bias, act, device):
    """JAX's float-weight dense route (``_diff_matmul``) always passes a
    bias, zeros when there is none, which turns a -0.0 sum into +0.0; the
    uint8 route passes none.  Both kept, so that packed == float-frozen
    holds exactly where it holds in JAX."""
    if bias is None and act is None and w.dtype != torch.uint8:
        return torch.zeros(w.shape[-1], dtype=torch.float32, device=device)
    return bias


def quant_dense(x, w, *, ka, kw, bias=None, act=None, nonneg=False,
                out_dtype=torch.float32):
    """Dense layer on packed / pre-quantized weights; x ``[..., K]``,
    w ``[K, N]``."""
    lead = x.shape[:-1]
    y = fused_quant_matmul(x.reshape(-1, x.shape[-1]), w, ka=ka, kw=kw,
                           bias=_dense_bias(w, bias, act, x.device), act=act,
                           nonneg=nonneg, out_dtype=out_dtype)
    return y.reshape(*lead, y.shape[-1])


def quant_conv1x1(x_nhwc, w, *, ka, kw, bias=None, act=None, stride: int = 1,
                  nonneg: bool = False, out_dtype=torch.float32):
    """1x1 convolution on packed / pre-quantized weights; x NHWC, w
    ``[Cin, Cout]``.  A stride is a strided view of x, read by the kernel
    in place."""
    if stride != 1:
        x_nhwc = x_nhwc[:, ::stride, ::stride, :]
    b, h, w_, _ = x_nhwc.shape
    y = _matmul(x_nhwc, w, ka=ka, kw=kw,
                bias=_dense_bias(w, bias, act, x_nhwc.device), act=act,
                quantize_x=True, nonneg=nonneg, out_dtype=out_dtype)
    return y.reshape(b, h, w_, y.shape[-1])
