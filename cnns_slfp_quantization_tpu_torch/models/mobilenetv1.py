"""MobileNetV1, CIFAR-100 and ImageNet-1k variants (counterpart of the JAX
``models/mobilenetv1.py``; reference nets_cifar/mobilenetv1.py and
nets_imgnet/mobilenetv1.py).

A 3x3 stride-2 stem conv and 13 depthwise-separable blocks (depthwise 3x3,
then pointwise 1x1), each conv followed by BatchNorm and its activation,
then the mean over H and W and the classifier.  Scale indices: 0 for the
stem, ``1+2b`` (depthwise) and ``2+2b`` (pointwise) for block ``b``, 27 for
the classifier.  Submodules carry the flax names (``conv{i}``, ``bn{i}``,
``loq{i}``, ``fc``) in flax's call order.

Variants:
- CIFAR ``mobilenet``: BN + ReLU, quantized classifier (``QuantDense``).
- CIFAR ``mobilenet_swish``: BN, SFP<4,4> layer-output quantize, then ReLU,
  or Swish in the last ``swish_tail`` blocks.
- ImageNet ``mobilenetv1``: BN + ReLU, 1000 classes, a plain float32
  classifier (``nn.Linear``, reference nets_imgnet/mobilenetv1.py:61).

Inputs are NHWC float32, as in JAX; the layers run NCHW views in
channels_last memory.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cnns_slfp_quantization_tpu_torch.calib import ScaleSet
from cnns_slfp_quantization_tpu_torch.ops import activations
from cnns_slfp_quantization_tpu_torch.ops.backend import full_f32_matmul
from cnns_slfp_quantization_tpu_torch.ops.layers import (
    BatchNorm2d,
    LayeroutQuant,
    QuantConv,
    QuantDense,
    he_normal_,
)

# (in, out, stride) of the 13 depthwise-separable blocks, JAX
# mobilenetv1.py:34-38
DW_CONFIG = [
    (32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2), (256, 256, 1),
    (256, 512, 2), (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
    (512, 512, 1), (512, 1024, 2), (1024, 1024, 1),
]
FC_ID = 27


class MobileNetV1(nn.Module):
    def __init__(self, scales: ScaleSet, num_classes: int = 100,
                 qbit: int = 32, swish_tail: int = 0,
                 layerout_quant: bool = False, quant_classifier: bool = True,
                 frozen_weights: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_pallas: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scales = scales
        self.qbit = qbit
        self.swish_tail = swish_tail
        self.layerout_quant = layerout_quant
        self.quant_classifier = quant_classifier

        def conv(i, cin, cout, k, stride, groups=1, pad=1, nonneg=False):
            setattr(self, f"conv{i}", QuantConv(
                cin, cout, k, stride=stride, padding=pad, groups=groups,
                qbit=qbit, ka=scales.ka[i], kw=scales.kw[i],
                frozen_weights=frozen_weights, nonneg_input=nonneg,
                compute_dtype=compute_dtype, layer_id=i,
                use_pallas=use_pallas))
            setattr(self, f"bn{i}", BatchNorm2d(cout))
            if layerout_quant:
                setattr(self, f"loq{i}", LayeroutQuant(qbit))

        conv(0, 3, 32, 3, 2)
        # Swish outputs are signed: a conv after one takes signed input
        # (the nonneg_input hints of JAX mobilenetv1.py:78-88)
        prev_relu = True
        for b, (inp, oup, stride) in enumerate(DW_CONFIG):
            is_relu = self.block_is_relu(b)
            conv(1 + 2 * b, inp, inp, 3, stride, groups=inp, nonneg=prev_relu)
            conv(2 + 2 * b, inp, oup, 1, 1, pad=0, nonneg=is_relu)
            prev_relu = is_relu
        width = DW_CONFIG[-1][1]
        if quant_classifier:
            self.fc = QuantDense(
                width, num_classes, qbit=qbit, ka=scales.ka[FC_ID],
                kw=scales.kw[FC_ID], frozen_weights=frozen_weights,
                nonneg_input=prev_relu, compute_dtype=compute_dtype,
                layer_id=FC_ID, use_pallas=use_pallas)
        else:
            self.fc = nn.Linear(width, num_classes)
        self.reset_parameters(generator)

    def block_is_relu(self, b: int) -> bool:
        return b < len(DW_CONFIG) - self.swish_tail

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: he_normal conv kernels, lecun_normal for the plain
        classifier, zero biases, unit BatchNorm."""
        for m in self.modules():
            if isinstance(m, (QuantConv, QuantDense)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        if isinstance(self.fc, nn.Linear):
            with torch.no_grad():
                he_normal_(self.fc.weight, self.fc.in_features, generator,
                           scale=1.0)
                self.fc.bias.zero_()

    def flax_order(self):
        """Modules holding variables, in flax's init order (JAX
        mobilenetv1.py): the reference ``.pth`` import's positional match
        follows it."""
        n = 1 + 2 * len(DW_CONFIG)
        return [f"{k}{i}" for i in range(n) for k in ("conv", "bn")] + ["fc"]

    def _post(self, i: int, x: torch.Tensor, act) -> torch.Tensor:
        x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
        if self.layerout_quant:
            x = getattr(self, f"loq{i}")(x)
        return act(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._post(0, x.permute(0, 3, 1, 2), activations.relu)
        for b in range(len(DW_CONFIG)):
            act = (activations.relu if self.block_is_relu(b)
                   else activations.swish)
            x = self._post(1 + 2 * b, x, act)
            x = self._post(2 + 2 * b, x, act)
        x = torch.mean(x, dim=(2, 3))
        if self.quant_classifier:
            return self.fc(x)
        # flax Dense promotes a bf16 input to its float32 parameters
        with full_f32_matmul():
            return self.fc(x.to(torch.float32))
