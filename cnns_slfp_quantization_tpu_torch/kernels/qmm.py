"""K2: fused quantize -> bf16 GEMM -> epilogue (hand kernel ``csrc/qmm.cu``).

Counterpart of the Pallas kernel ``kernels/qmm.py::qmm_fused``: the 1x1
convolutions of the fused ResNet-50 executor as

    out = epilogue(Q_a(x * quant_in_recip) @ w)

with an optional quantize prologue (for non-negative input: every caller
feeds it a ReLU output, as in JAX), bf16 or uint8-code weights, the folded
BN affine ``fma(acc, scale, shift)``, an optional residual, ReLU and an
optional quantize for the next layer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch.kernels import _build, _gemm_plan
from cnns_slfp_quantization_tpu_torch.kernels.epilogue import (
    epilogue_value_plain)
from cnns_slfp_quantization_tpu_torch.kernels.quantize import act_quantize
from cnns_slfp_quantization_tpu_torch.ops import sfp


def quantize_act_pass(x: torch.Tensor, recip: float, *, nonneg: bool = True,
                      qbit: int = 8,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The standalone scale + quantize + bf16 pass (K1), as the JAX
    ``quantize_act_pass`` names it; ``out_dtype=torch.float32`` for a
    consumer that reads float32 (cuDNN, a plain matmul)."""
    return act_quantize(x, recip, qbit=qbit, nonneg=nonneg,
                        out_dtype=out_dtype)


def qmm_plain(x, w, scale, shift, *, residual=None, relu=False,
              quant_in_recip=None, quant_out_recip=None,
              out_dtype=torch.bfloat16):
    if quant_in_recip is not None:
        xq = sfp.act_bf16_bits(x, quant_in_recip, 8, True)
    else:
        xq = x.to(torch.bfloat16)
    if w.dtype == torch.uint8:
        wv = sfp.slfp34_decode_bits(w).to(torch.bfloat16)
    else:
        wv = w.to(torch.bfloat16)
    # bf16 products are exact in f32; only the order of the sums differs
    # from the kernel's
    y = xq.to(torch.float32) @ wv.to(torch.float32)
    v = epilogue_value_plain(y, scale, shift, residual, relu)
    if quant_out_recip is not None:
        v = sfp.act_bf16_bits(v, quant_out_recip, 8, relu)
    return v.to(out_dtype)


def qmm_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    *,
    residual: Optional[torch.Tensor] = None,
    relu: bool = False,
    quant_in_recip: Optional[float] = None,
    quant_out_recip: Optional[float] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """x [M, K] bf16; w [K, N] bf16 values or uint8 codes, contiguous or
    the transpose of a contiguous [N, K] (the executor's storage, which the
    kernel reads fastest); scale/shift f32 [N]; residual bf16 [M, N].  K and
    N must be multiples of 8 on the card.
    """
    if x.device.type == "cpu":
        return qmm_plain(x, w, scale, shift, residual=residual, relu=relu,
                         quant_in_recip=quant_in_recip,
                         quant_out_recip=quant_out_recip, out_dtype=out_dtype)
    m, k = x.shape
    k2, n = w.shape
    if (k != k2 or k % 8 or n % 8 or x.dtype != torch.bfloat16
            or w.dtype not in (torch.bfloat16, torch.uint8)
            or scale.dtype != torch.float32 or shift.dtype != torch.float32
            or scale.shape != (n,) or shift.shape != (n,)
            or out_dtype not in (torch.bfloat16, torch.float32)
            or (residual is not None and (residual.dtype != torch.bfloat16
                                          or residual.shape != (m, n)))):
        raise ValueError(
            f"qmm_fused: x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)} "
            f"{w.dtype}; needs bf16 x, bf16/uint8 w, K and N multiples of 8, "
            f"f32 scale/shift [N], bf16 residual [M, N]")
    w_nk, w_store = _gemm_plan.weight_storage(w, "qmm_fused")
    _build.check_cuda(x, w_store, scale, shift, residual)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if not _build.aligned16(x, w_store, scale, shift, residual, out):
        raise ValueError("qmm_fused: operands must be 16-byte aligned")
    tiles = _gemm_plan.plan(m, k, n, residual is not None)
    ws = _gemm_plan.workspace(tiles, m, n, x.device)
    _build.launch(
        "qmm", "slfp_qmm", x.data_ptr(), w_store.data_ptr(),
        int(w.dtype == torch.uint8), int(w_nk), scale.data_ptr(),
        shift.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.float32), m, k, n,
        int(quant_in_recip is not None),
        float(np.float32(quant_in_recip or 1.0)), int(relu),
        int(quant_out_recip is not None),
        float(np.float32(quant_out_recip or 1.0)), *tiles,
        None if ws is None else ws.data_ptr(), _build.stream_of(x))
    qmm_fused.launches += 1
    return out


qmm_fused.launches = 0
