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

Calibration capture (JAX's ``capture=`` sows), set per layer by
:func:`set_capture` (``models.create_model(..., capture=...)`` calls it)
and read by :func:`captured`: ``"absmax"`` keeps ``max|x|`` of the raw
input, ``max|kernel|`` of the float weight and ``max|y|`` of the output
after the rescale and the cast, as 0-d float32 tensors on the layer's
device under the tags ``in{id}``, ``w{id}`` and ``out{id}``, reduced with
max from 0 over the calls since the last :func:`reset_capture`;
``"full"`` appends ``input_q``, ``weight_q``, ``input_raw`` and
``nonneg_hint`` at each call.  Under a capture a layer takes neither K4
nor the fused bf16 quantizer (K1): its input quantize is
``quantize_act(x / Ka)`` in float32, as JAX's is.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cnns_slfp_quantization_tpu_torch.kernels import fused_matmul
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


def _storage_key(*tensors):
    """What identifies the tensors' contents while their storages live:
    (address, version, shape, dtype) of each; None where a tensor keeps no
    version (made under inference_mode)."""
    try:
        return tuple(None if t is None else (t.data_ptr(), t._version,
                                             tuple(t.shape), t.dtype)
                     for t in tensors)
    except RuntimeError:
        return None


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
        self.capture = None        # None | "absmax" | "full" (set_capture)
        self.captured = {}
        self._k4_pad = None        # K4's padded operands (k4_args)
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
        if (self.compute_dtype == torch.bfloat16 and self.qbit in (7, 8)
                and self.capture is None):
            # K1 on the card, its plain version on the CPU, with JAX's STE
            # gradient; it writes the bf16 values as float32 itself, so no
            # copy widens them
            args = (sfp.recip_of(self.ka), self.qbit, self.nonneg_input,
                    torch.float32)
            if x.dim() == 4:
                return sfp.fused_scale_quant_act_bf16(_nhwc(x), *args).permute(
                    0, 3, 1, 2)
            return sfp.fused_scale_quant_act_bf16(x.contiguous(), *args)
        xq = sfp.quantize_act(x.to(torch.float32) * self.rka32, self.qbit)
        if self.compute_dtype is not None:
            # bf16 values, float32 sums (the JAX preferred_element_type=f32)
            xq = xq.to(self.compute_dtype)
        return xq.to(torch.float32)

    def operands(self, x):
        if self.capture == "absmax":
            self._absmax("in", x)
            self._absmax("w", self.weight)
        wq = self.weight_q()
        xq = self.input_q(x)
        if self.capture == "full":
            for key, v in (("input_q", xq), ("weight_q", wq),
                           ("input_raw", x),
                           ("nonneg_hint", self.nonneg_input)):
                self.captured.setdefault(key, []).append(v)
        if self.compute_dtype is not None:
            wq = wq.to(self.compute_dtype)
        return xq, wq.to(torch.float32)

    def rescale(self, y: torch.Tensor) -> torch.Tensor:
        if self.bias is not None:
            b = self.bias * self.rkaw32
            y = y + (b[:, None, None] if y.dim() == 4 else b)  # NCHW: per C
        y = y * self.kaw32
        if self.compute_dtype is not None:
            y = y.to(self.compute_dtype)
        if self.capture == "absmax":
            self._absmax("out", y)
        return y

    def _absmax(self, tag: str, v: torch.Tensor) -> None:
        """JAX ``_sow_absmax``: ``max|v|`` as float32, reduced with max."""
        key = tag if self.layer_id is None else f"{tag}{self.layer_id}"
        m = v.detach().abs().max().to(torch.float32)
        cur = self.captured.get(key)
        self.captured[key] = m if cur is None else torch.maximum(cur, m)

    def k4_args(self, pad: bool):
        """K4's ``[K, N]`` weight operand (the transpose of the layer's
        ``[N, K]`` storage) and keyword arguments, as the JAX layers pass
        them.  With ``pad`` (on the card), where K or N is not a multiple of
        8 (ShuffleNetV2's 58- and 116-channel layers), a frozen layer's
        weight and bias come zero-padded (``fused_matmul.pad_weight``) with
        the N the output keeps, padded once and kept while its weight and
        bias stay the same storage, unchanged."""
        w = self.weight_frozen()
        w = w.reshape(w.shape[0], -1).t()
        args = dict(ka=float(np.float32(self.ka)),
                    kw=float(np.float32(self.kw)), bias=self.bias,
                    nonneg=self.nonneg_input,
                    out_dtype=self.compute_dtype or torch.float32)
        k, n = w.shape
        if not pad or not (k % 8 or n % 8) or not self.frozen_weights:
            # a weight computed now goes unpadded: the differentiable K4
            # form pads it per call, so its gradient reaches the weight
            return w, args
        key = _storage_key(self.weight, self.bias)
        if key is not None and self._k4_pad and self._k4_pad[0] == key:
            wp, bias = self._k4_pad[1]
        else:
            wp, bias = fused_matmul.pad_weight(w, fused_matmul._dense_bias(
                w, self.bias, None, w.device))
            if key is not None:   # the aliases keep the key's storages
                self._k4_pad = (key, (wp, bias), self.weight.detach(),
                                None if self.bias is None
                                else self.bias.detach())
        return wp, dict(args, bias=bias, n_out=n)

    def k4_wanted(self, x: torch.Tensor) -> bool:
        if self.capture is not None:
            return False
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
            w, args = self.k4_args(pad=x.is_cuda)
            y = fused_matmul.quant_conv1x1(_nhwc(x), w, stride=self.stride,
                                           **args)
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
            w, args = self.k4_args(pad=x.is_cuda)
            return fused_matmul.quant_dense(x, w, **args)
        xq, wq = self.operands(x)
        return self.rescale(xq @ wq.t())


def set_capture(model: nn.Module, capture: Optional[str]) -> nn.Module:
    """Set every quantized layer's capture mode (None, ``"absmax"`` or
    ``"full"``) and empty its store."""
    if capture not in (None, "absmax", "full"):
        raise ValueError(f"capture={capture!r}: None, 'absmax' or 'full'")
    for m in model.modules():
        if isinstance(m, _QuantBase):
            m.capture = capture
            m.captured = {}
    return model


def reset_capture(model: nn.Module) -> None:
    """Empty every quantized layer's store (a new forward's collection)."""
    for m in model.modules():
        if isinstance(m, _QuantBase):
            m.captured = {}


def captured(model: nn.Module) -> dict:
    """The stores of the model's quantized layers, by the layer's module
    name: JAX's ``calib`` / ``intermediates`` collection of one apply."""
    return {name: dict(m.captured) for name, m in model.named_modules()
            if isinstance(m, _QuantBase) and m.captured}


class LayeroutQuant(nn.Module):
    """SFP<4,4> layer-output quantizer (reference sfp_quant.py:163-175),
    with the reference's subnormal branch as it is (``bug_compat``): no
    model asks for the other."""

    def __init__(self, qbit: int = 32):
        super().__init__()
        self.qbit = qbit

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sfp.quantize_layerout(x, self.qbit)


class BatchNorm2d(nn.BatchNorm2d):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` on NCHW, the one every
    model builds.  Eval mode is torch's (the running statistics, which the
    executors fold).  Training mode is flax's: the batch statistics reduced
    in float32 whatever the stream's type, the *biased* variance
    ``max(0, E[x^2] - E[x]^2)`` (torch's own keeps the unbiased one in its
    running variance), ``ra = 0.9 * ra + 0.1 * batch``, and the output in
    x's type.  Under a data axis (``data_group``, set by
    ``parallel.mesh.shard_module``) ``E[x]`` and ``E[x^2]`` are the global
    batch's: the ranks' means averaged over the group, as GSPMD reduces
    JAX's over the sharded batch."""

    data_group = None

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=(0, 2, 3))
        ex2 = x32.square().mean(dim=(0, 2, 3))
        if self.data_group is not None:
            from cnns_slfp_quantization_tpu_torch.parallel import comm

            mean, ex2 = comm.all_reduce_mean(
                torch.cat([mean, ex2]), self.data_group).chunk(2)
        var = torch.clamp(ex2 - mean.square(), min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(0.9 * self.running_mean
                                    + 0.1 * mean.detach())
            self.running_var.copy_(0.9 * self.running_var
                                   + 0.1 * var.detach())
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


class Dropout(nn.Dropout):
    """flax ``Dropout``: in training mode keep each element with
    probability ``1 - p`` and scale it by ``1 / (1 - p)``, drawing from
    ``generator`` when one is set (the training loop sets it per step);
    the identity in eval mode.  Under a data axis (``data_shard``, the
    rank's index and the axis size, set by ``parallel.mesh.shard_module``)
    it draws the global batch's mask and keeps its rows, so a sharded step
    drops what the single-device step drops."""

    generator: Optional[torch.Generator] = None
    data_shard: Optional[tuple] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        keep = 1.0 - self.p
        n = x.shape[0]
        i, size = self.data_shard or (0, 1)
        mask = torch.rand((n * size, *x.shape[1:]), generator=self.generator,
                          device=x.device)[i * n:(i + 1) * n] < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)
