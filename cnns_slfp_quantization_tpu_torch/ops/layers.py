"""Quantized conv / dense layers (counterpart of the JAX ``ops/layers.py``).

Semantics (reference utils/conv2d_func.py:20-25, 41-47, 60-65):

    input_q  = Q_act(x / Ka)
    weight_q = Q_weight(w / Kw)
    y        = (conv(input_q, weight_q) [+ b/(Ka*Kw)]) * Ka * Kw

PyTorch layout inside the layers: NCHW activations and OIHW weights (the
reference's own), registered as ``weight`` / ``bias`` so that a state_dict
in reference registration order loads.  ``frozen_weights`` layers hold
``Q(w/Kw)`` already (``ops/freeze.py``), as float/bf16 values or uint8
SLFP<3,4> codes.  ``compute_dtype=torch.bfloat16`` quantizes through the
bit-domain ``act_bf16_bits`` and convolves bf16 values with float32 sums;
``None`` keeps float32 throughout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cnns_slfp_quantization_tpu_torch.ops import sfp


def he_normal_(w: torch.Tensor, fan_in: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``he_normal``: truncated normal (+-2 sigma) of variance
    2/fan_in, sigma corrected for the truncation."""
    std = float(np.sqrt(2.0 / fan_in) / 0.87962566103423978)
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class _QuantBase(nn.Module):
    def __init__(self, qbit, ka, kw, frozen_weights, nonneg_input,
                 compute_dtype, layer_id):
        super().__init__()
        self.qbit = qbit
        self.ka = float(ka)
        self.kw = float(kw)
        self.frozen_weights = frozen_weights
        self.nonneg_input = nonneg_input
        self.compute_dtype = compute_dtype
        self.layer_id = layer_id
        # float32 scale constants as device tensors: a division by a tensor
        # is a true division on every device (a Python scalar may become a
        # reciprocal multiply)
        self.register_buffer("ka32", torch.tensor(np.float32(ka)),
                             persistent=False)
        self.register_buffer("kw32", torch.tensor(np.float32(kw)),
                             persistent=False)
        self.register_buffer("kaw32", torch.tensor(np.float32(ka)
                                                   * np.float32(kw)),
                             persistent=False)

    def weight_q(self) -> torch.Tensor:
        w = self.weight
        if w.dtype == torch.uint8:
            return sfp.unpack_slfp34(w)
        if self.frozen_weights:
            return w
        return sfp.quantize_weight(w / self.kw32, self.qbit)

    def input_q(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.bfloat16 and self.qbit in (7, 8):
            return sfp.act_bf16_bits(x, sfp.recip_of(self.ka), self.qbit,
                                     self.nonneg_input)
        return sfp.quantize_act(x / self.ka32, self.qbit)

    def operands(self, x):
        xq, wq = self.input_q(x), self.weight_q()
        if self.compute_dtype is not None:
            # bf16 values, float32 sums (the JAX preferred_element_type=f32)
            xq = xq.to(self.compute_dtype)
            wq = wq.to(self.compute_dtype)
        return xq.to(torch.float32), wq.to(torch.float32)

    def rescale(self, y: torch.Tensor) -> torch.Tensor:
        if self.bias is not None:
            y = y + self.bias / self.kaw32
        y = y * self.kaw32
        if self.compute_dtype is not None:
            y = y.to(self.compute_dtype)
        return y


class QuantConv(_QuantBase):
    """Quantized 2-D convolution with per-tensor max scaling (NCHW)."""

    def __init__(self, in_features: int, features: int, kernel_size: int, *,
                 stride: int = 1, padding: int = 0, use_bias: bool = False,
                 qbit: int = 32, ka: float = 1.0, kw: float = 1.0,
                 frozen_weights: bool = False, nonneg_input: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 layer_id: Optional[int] = None):
        super().__init__(qbit, ka, kw, frozen_weights, nonneg_input,
                         compute_dtype, layer_id)
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(
            features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator=None):
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        with torch.no_grad():
            he_normal_(self.weight, fan_in, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, wq = self.operands(x)
        y = F.conv2d(xq, wq, stride=self.stride, padding=self.padding)
        return self.rescale(y)


class QuantDense(_QuantBase):
    """Quantized fully-connected layer (``linear_Q``); weight [out, in]."""

    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = True, qbit: int = 32, ka: float = 1.0,
                 kw: float = 1.0, frozen_weights: bool = False,
                 nonneg_input: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 layer_id: Optional[int] = None):
        super().__init__(qbit, ka, kw, frozen_weights, nonneg_input,
                         compute_dtype, layer_id)
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            he_normal_(self.weight, self.weight.shape[1], generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, wq = self.operands(x)
        return self.rescale(xq @ wq.t())
