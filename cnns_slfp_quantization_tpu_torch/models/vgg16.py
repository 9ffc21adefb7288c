"""VGG16 for CIFAR-100 (counterpart of the JAX ``models/vgg16.py``;
reference nets_cifar/vgg16.py), in its two variants:

- ``vgg16`` (VGG16_Q): biased quantized convs, BN + ReLU; the three dense
  layers all use scale index 13, as the reference threads ``Kw[13]`` into
  each; dropout 0.5.
- ``vgg16_gelu``: unbiased quantized convs, BN + SFP<4,4> layer-output
  quantize + GELU, after the dense layers too; dense scale indices 13, 14,
  15; dropout 0.4.

Thirteen 3x3 convs (scale indices 0..12 in order) in five groups, each
group ending in a 2x2 max pool; then the mean over H and W and dense layers
512 -> 256 -> classes.  Dropout is the identity at inference.  Submodules
carry the flax names (``conv{i}``, ``bn{i}``, ``loq{i}``, ``fc1``,
``fc1_loq``, ...) in flax's call order.  Inputs are NHWC float32, as in
JAX; the layers run NCHW views in channels_last memory.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cnns_slfp_quantization_tpu_torch.calib import ScaleSet
from cnns_slfp_quantization_tpu_torch.ops import activations
from cnns_slfp_quantization_tpu_torch.ops.layers import (
    BatchNorm2d,
    Dropout,
    LayeroutQuant,
    QuantConv,
    QuantDense,
)

# (features, convs) per group, VGG16-D (JAX vgg16.py:27)
GROUPS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


class VGG16(nn.Module):
    def __init__(self, scales: ScaleSet, num_classes: int = 100,
                 qbit: int = 32, gelu_variant: bool = False,
                 frozen_weights: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_pallas: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scales = scales
        self.qbit = qbit
        self.gelu_variant = gelu_variant
        common = dict(qbit=qbit, frozen_weights=frozen_weights,
                      compute_dtype=compute_dtype, use_pallas=use_pallas)
        i, cin = 0, 3
        for feat, n in GROUPS:
            for _ in range(n):
                # the ReLU variant's inputs are post-ReLU or pool but for the
                # image's; GELU outputs are signed
                setattr(self, f"conv{i}", QuantConv(
                    cin, feat, 3, padding=1, use_bias=not gelu_variant,
                    ka=scales.ka[i], kw=scales.kw[i],
                    nonneg_input=i > 0 and not gelu_variant, layer_id=i,
                    **common))
                setattr(self, f"bn{i}", BatchNorm2d(feat))
                if gelu_variant:
                    setattr(self, f"loq{i}", LayeroutQuant(qbit))
                i, cin = i + 1, feat
        sids = (13, 14, 15) if gelu_variant else (13, 13, 13)
        for k, (fin, fout) in enumerate(((cin, 512), (512, 256),
                                         (256, num_classes))):
            name = f"fc{k + 1}"
            setattr(self, name, QuantDense(
                fin, fout, ka=scales.ka[sids[k]], kw=scales.kw[sids[k]],
                nonneg_input=not gelu_variant, layer_id=sids[k], **common))
            if gelu_variant and k < 2:
                setattr(self, f"{name}_loq", LayeroutQuant(qbit))
        # after fc1 and fc2 in training mode (JAX vgg16.py:83)
        self.drop = Dropout(0.4 if gelu_variant else 0.5)
        for m in self.modules():
            if isinstance(m, (QuantConv, QuantDense)):
                m.reset_parameters(generator)

    def flax_order(self):
        """Modules holding variables, in flax's init order (JAX
        vgg16.py:47-91): the reference ``.pth`` import's positional match
        follows it."""
        n = sum(k for _, k in GROUPS)
        return ([f"{k}{i}" for i in range(n) for k in ("conv", "bn")]
                + ["fc1", "fc2", "fc3"])

    def _act(self, x: torch.Tensor, loq: str) -> torch.Tensor:
        if self.gelu_variant:
            return activations.gelu(getattr(self, loq)(x))
        return activations.relu(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        i = 0
        for _, n in GROUPS:
            for _ in range(n):
                x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
                x = self._act(x, f"loq{i}")
                i += 1
            x = F.max_pool2d(x, 2, 2)
        x = torch.mean(x, dim=(2, 3))
        x = self.drop(self._act(self.fc1(x), "fc1_loq"))
        x = self.drop(self._act(self.fc2(x), "fc2_loq"))
        return self.fc3(x)
