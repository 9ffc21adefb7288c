"""Quantized conv / dense layers (counterpart of the JAX ``ops/layers.py``).

Semantics (reference utils/conv2d_func.py:20-25, 41-47, 60-65):

    input_q  = Q_act(x / Ka)
    weight_q = Q_weight(w / Kw)
    y        = (conv(input_q, weight_q) [+ b/(Ka*Kw)]) * Ka * Kw

PyTorch layout inside the layers: NCHW activations and OIHW weights (the
reference's own), registered as ``weight`` / ``bias`` so that a state_dict
in reference registration order loads.  The models feed NHWC images as an
NCHW view, so activations run in ``torch.channels_last`` memory throughout.
``frozen_weights`` layers hold ``Q(w/Kw)`` already (``ops/freeze.py``), as
float/bf16 values or uint8 SLFP<3,4> codes.  ``compute_dtype=torch.bfloat16``
quantizes through the bit-domain activation quantizer (K1 on the card, its
plain version on the CPU) and convolves bf16 values with float32 sums;
``None`` keeps float32 throughout.

``use_pallas`` routes a layer to K4 (``kernels/fused_matmul.py``), as the
JAX ``_pallas_eligible`` / ``pallas_ok`` do: ``True`` sends every eligible
layer (qbit 8; for convs 1x1 with no padding), ``None`` sends it when its
weights are uint8 codes, the compute dtype is bf16 and the input lies on the
card, ``False`` never.  K4 reads the ``[N, K]`` storage of the weight as it
is (``weight.t()`` is a view), so nothing is copied or transposed per
forward, and returns the layer's output with no second rescale.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cnns_slfp_quantization_tpu_torch.kernels import fused_matmul
from cnns_slfp_quantization_tpu_torch.kernels.quantize import act_quantize
from cnns_slfp_quantization_tpu_torch.ops import sfp


def relu(x: torch.Tensor) -> torch.Tensor:
    """ReLU that yields +0.0 for -0.0, as JAX's ``jnp.maximum(x, 0)``, in
    one pass (``x <= 0 -> +0.0``): ``F.relu`` keeps -0.0, whose bit pattern
    the ``nonneg`` quantizer maps to the pseudo-zero."""
    return F.threshold(x, 0.0, 0.0)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NHWC view of an NCHW tensor in channels_last memory (a copy only if
    it is in another layout)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def he_normal_(w: torch.Tensor, fan_in: int,
               generator: Optional[torch.Generator] = None,
               scale: float = 2.0) -> torch.Tensor:
    """flax's ``he_normal``: truncated normal (+-2 sigma) of variance
    scale/fan_in, sigma corrected for the truncation; ``scale=1`` is
    ``lecun_normal``, flax ``Dense``'s default."""
    std = float(np.sqrt(scale / fan_in) / 0.87962566103423978)
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class _QuantBase(nn.Module):
    def __init__(self, qbit, ka, kw, frozen_weights, nonneg_input,
                 compute_dtype, layer_id, use_pallas):
        super().__init__()
        self.qbit = qbit
        self.ka = float(ka)
        self.kw = float(kw)
        self.frozen_weights = frozen_weights
        self.nonneg_input = nonneg_input
        self.compute_dtype = compute_dtype
        self.layer_id = layer_id
        self.use_pallas = use_pallas
        # JAX's weight quotient ``kernel / kw`` divides by a constant, which
        # XLA computes as ``kernel * f32(1/kw)``: the port multiplies by the
        # same float32 reciprocal, so its frozen and packed codes are JAX's
        self.register_buffer("rkw32", torch.tensor(np.float32(1)
                                                   / np.float32(kw)),
                             persistent=False)
        self.register_buffer("kaw32", torch.tensor(np.float32(ka)
                                                   * np.float32(kw)),
                             persistent=False)
        # so do its float32 activation and bias quotients ``x / ka`` and
        # ``bias / (ka * kw)``: the port multiplies by f32(1/ka) and
        # f32(1/(ka*kw))
        self.register_buffer("rka32", torch.tensor(np.float32(1)
                                                   / np.float32(ka)),
                             persistent=False)
        self.register_buffer("rkaw32", torch.tensor(
            np.float32(1) / (np.float32(ka) * np.float32(kw))),
            persistent=False)

    def weight_frozen(self) -> torch.Tensor:
        """``Q(w/Kw)`` as stored (values or uint8 codes) or computed now."""
        w = self.weight
        if self.frozen_weights or w.dtype == torch.uint8:
            return w
        return sfp.quantize_weight(w * self.rkw32, self.qbit)

    def weight_q(self) -> torch.Tensor:
        w = self.weight_frozen()
        return sfp.unpack_slfp34(w) if w.dtype == torch.uint8 else w

    def input_q(self, x: torch.Tensor) -> torch.Tensor:
        """``Q_act(x / Ka)`` as the float32 operand cuDNN and the matmuls
        read, holding compute-dtype values."""
        if self.compute_dtype == torch.bfloat16 and self.qbit in (7, 8):
            # K1 on the card, its plain version on the CPU; it writes the
            # bf16 values as float32 itself, so no copy widens them
            args = dict(qbit=self.qbit, nonneg=self.nonneg_input,
                        out_dtype=torch.float32)
            recip = sfp.recip_of(self.ka)
            if x.dim() == 4:
                return act_quantize(_nhwc(x), recip, **args).permute(
                    0, 3, 1, 2)
            return act_quantize(x.contiguous(), recip, **args)
        xq = sfp.quantize_act(x * self.rka32, self.qbit)
        if self.compute_dtype is not None:
            # bf16 values, float32 sums (the JAX preferred_element_type=f32)
            xq = xq.to(self.compute_dtype)
        return xq.to(torch.float32)

    def operands(self, x):
        wq = self.weight_q()
        if self.compute_dtype is not None:
            wq = wq.to(self.compute_dtype)
        return self.input_q(x), wq.to(torch.float32)

    def rescale(self, y: torch.Tensor) -> torch.Tensor:
        if self.bias is not None:
            b = self.bias * self.rkaw32
            y = y + (b[:, None, None] if y.dim() == 4 else b)  # NCHW: per C
        y = y * self.kaw32
        if self.compute_dtype is not None:
            y = y.to(self.compute_dtype)
        return y

    def k4_args(self) -> dict:
        """K4's keyword arguments, as the JAX layers pass them."""
        return dict(ka=float(np.float32(self.ka)),
                    kw=float(np.float32(self.kw)), bias=self.bias,
                    nonneg=self.nonneg_input,
                    out_dtype=self.compute_dtype or torch.float32)

    def k4_wanted(self, x: torch.Tensor) -> bool:
        return self.use_pallas is True or (
            self.use_pallas is None and self.weight.dtype == torch.uint8
            and self.compute_dtype == torch.bfloat16 and x.is_cuda)


class QuantConv(_QuantBase):
    """Quantized 2-D convolution with per-tensor max scaling (NCHW).
    ``groups`` is JAX's ``feature_group_count``: the weight is ``[features,
    in_features/groups, k, k]``."""

    def __init__(self, in_features: int, features: int, kernel_size: int, *,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 use_bias: bool = False,
                 qbit: int = 32, ka: float = 1.0, kw: float = 1.0,
                 frozen_weights: bool = False, nonneg_input: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 layer_id: Optional[int] = None,
                 use_pallas: Optional[bool] = None):
        super().__init__(qbit, ka, kw, frozen_weights, nonneg_input,
                         compute_dtype, layer_id, use_pallas)
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(
            features, in_features // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator=None):
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        with torch.no_grad():
            he_normal_(self.weight, fan_in, generator)
            if self.bias is not None:
                self.bias.zero_()

    def uses_k4(self, x: torch.Tensor) -> bool:
        """JAX ``QuantConv._pallas_eligible``."""
        return (self.use_pallas is not False and self.qbit == 8
                and self.weight.shape[-2:] == (1, 1) and self.padding == 0
                and self.groups == 1 and self.k4_wanted(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.uses_k4(x):
            w = self.weight_frozen()
            y = fused_matmul.quant_conv1x1(
                _nhwc(x), w.reshape(w.shape[0], w.shape[1]).t(),
                stride=self.stride, **self.k4_args())
            return y.permute(0, 3, 1, 2)
        xq, wq = self.operands(x)
        y = F.conv2d(xq, wq, stride=self.stride, padding=self.padding,
                     groups=self.groups)
        return self.rescale(y)


class QuantDense(_QuantBase):
    """Quantized fully-connected layer (``linear_Q``); weight [out, in]."""

    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = True, qbit: int = 32, ka: float = 1.0,
                 kw: float = 1.0, frozen_weights: bool = False,
                 nonneg_input: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 layer_id: Optional[int] = None,
                 use_pallas: Optional[bool] = None):
        super().__init__(qbit, ka, kw, frozen_weights, nonneg_input,
                         compute_dtype, layer_id, use_pallas)
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            he_normal_(self.weight, self.weight.shape[1], generator)
            if self.bias is not None:
                self.bias.zero_()

    def uses_k4(self, x: torch.Tensor) -> bool:
        """JAX ``QuantDense``'s ``pallas_ok``."""
        return (self.use_pallas is not False and self.qbit == 8
                and self.compute_dtype == torch.bfloat16
                and self.k4_wanted(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.uses_k4(x):
            return fused_matmul.quant_dense(x, self.weight_frozen().t(),
                                            **self.k4_args())
        xq, wq = self.operands(x)
        return self.rescale(xq @ wq.t())


class LayeroutQuant(nn.Module):
    """SFP<4,4> layer-output quantizer (reference sfp_quant.py:163-175),
    with the reference's subnormal branch as it is (``bug_compat``): no
    model asks for the other."""

    def __init__(self, qbit: int = 32):
        super().__init__()
        self.qbit = qbit

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sfp.quantize_layerout(x, self.qbit)
