"""SqueezeNet 1.0 for ImageNet-1k (counterpart of the JAX
``models/squeezenet.py``; reference nets_imgnet/squeezenet1_0.py).

All Fire-module convs and the final 1x1 classifier conv are biased
quantized convs.  Scale indices: 0 stem; Fire f (f = 0..7) uses 1+3f
(squeeze), 2+3f (expand1x1), 3+3f (expand3x3); the classifier conv is 25.
No BatchNorm.  Max pools in ceil mode before fires 0, 3 and 7; dropout is
the identity at inference.  Submodules carry the flax names (``conv0``,
``fire{f}_squeeze|expand1|expand3``, ``classifier``) in flax's call order.
Inputs are NHWC float32, as in JAX; the layers run NCHW views in
channels_last memory.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cnns_slfp_quantization_tpu_torch.calib import ScaleSet
from cnns_slfp_quantization_tpu_torch.ops.layers import QuantConv, relu

FIRE_PLAN = [  # (squeeze, expand1x1, expand3x3), JAX squeezenet.py:23-27
    (16, 64, 64), (16, 64, 64), (32, 128, 128),
    (32, 128, 128), (48, 192, 192), (48, 192, 192), (64, 256, 256),
    (64, 256, 256),
]
POOL_BEFORE = {0, 3, 7}


def ceil_max_pool(x: torch.Tensor) -> torch.Tensor:
    """torch ``MaxPool2d(3, 2, ceil_mode=True)`` (JAX ``_ceil_max_pool``)."""
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


class SqueezeNet(nn.Module):
    def __init__(self, scales: ScaleSet, num_classes: int = 1000,
                 qbit: int = 32, frozen_weights: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_pallas: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scales = scales
        self.qbit = qbit

        def conv(sid, cin, cout, k, stride=1, pad=0, nonneg=True):
            # every conv input but the stem's (the signed image) is
            # post-ReLU/maxpool
            return QuantConv(cin, cout, k, stride=stride, padding=pad,
                             use_bias=True, qbit=qbit, ka=scales.ka[sid],
                             kw=scales.kw[sid], frozen_weights=frozen_weights,
                             nonneg_input=nonneg, compute_dtype=compute_dtype,
                             layer_id=sid, use_pallas=use_pallas)

        self.conv0 = conv(0, 3, 96, 7, stride=2, nonneg=False)
        in_ch = 96
        for f, (sq, e1, e3) in enumerate(FIRE_PLAN):
            sid = 1 + 3 * f
            setattr(self, f"fire{f}_squeeze", conv(sid, in_ch, sq, 1))
            setattr(self, f"fire{f}_expand1", conv(sid + 1, sq, e1, 1))
            setattr(self, f"fire{f}_expand3", conv(sid + 2, sq, e3, 3, pad=1))
            in_ch = e1 + e3
        self.classifier = conv(25, in_ch, num_classes, 1)
        for m in self.modules():
            if isinstance(m, QuantConv):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = relu(self.conv0(x.permute(0, 3, 1, 2)))
        for f in range(len(FIRE_PLAN)):
            if f in POOL_BEFORE:
                x = ceil_max_pool(x)
            x = relu(getattr(self, f"fire{f}_squeeze")(x))
            a = relu(getattr(self, f"fire{f}_expand1")(x))
            b = relu(getattr(self, f"fire{f}_expand3")(x))
            x = torch.cat([a, b], dim=1)
        x = relu(self.classifier(x))
        return torch.mean(x, dim=(2, 3))
