"""ResNet-50 v1.5 for ImageNet-1k (counterpart of the JAX
``models/resnet50.py``; reference nets_imgnet/resnet50.py).

54 quantized layers: the stem conv (scale index 0), 16 bottlenecks of three
convs plus 4 downsample convs, and the FC (index 53).  Within a stage with
scale base ``base``, the downsample conv uses ``base`` and block ``b``'s
conv1..3 use ``base+3b+1..+3``.  Submodules carry the flax names (``conv1``,
``bn1``, ``layer1_0_conv1``, ..., ``fc``) in flax's call order.  Inputs are
NHWC float32, as in JAX; the layers run NCHW views in channels_last
memory.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cnns_slfp_quantization_tpu_torch.calib import ScaleSet
from cnns_slfp_quantization_tpu_torch.ops.layers import (
    QuantConv,
    QuantDense,
    relu,
)

STAGES = [  # (planes, blocks, stride, scale_base), JAX resnet50.py:31-36
    (64, 3, 1, 1),
    (128, 4, 2, 11),
    (256, 6, 2, 24),
    (512, 3, 2, 43),
]
EXPANSION = 4


def block_names():
    """(stage index, block index, name prefix, scale id base, stride,
    planes, in channels) of every bottleneck, in order."""
    out, in_ch = [], 64
    for s, (planes, blocks, stride, base) in enumerate(STAGES):
        for b in range(blocks):
            out.append((s, b, f"layer{s + 1}_{b}", base + 3 * b,
                        stride if b == 0 else 1, planes, in_ch))
            in_ch = planes * EXPANSION
    return out


def _bn(ch):
    # flax BatchNorm(momentum=0.9, epsilon=1e-5)
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class ResNet50(nn.Module):
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
                             qbit=qbit, ka=scales.ka[sid], kw=scales.kw[sid],
                             frozen_weights=frozen_weights,
                             nonneg_input=nonneg, compute_dtype=compute_dtype,
                             layer_id=sid, use_pallas=use_pallas)

        self.conv1 = conv(0, 3, 64, 7, 2, 3, nonneg=False)
        self.bn1 = _bn(64)
        for _, b, pre, sid, stride, planes, in_ch in block_names():
            out_ch = planes * EXPANSION
            setattr(self, f"{pre}_conv1", conv(sid + 1, in_ch, planes, 1))
            setattr(self, f"{pre}_bn1", _bn(planes))
            setattr(self, f"{pre}_conv2",
                    conv(sid + 2, planes, planes, 3, stride, 1))
            setattr(self, f"{pre}_bn2", _bn(planes))
            setattr(self, f"{pre}_conv3", conv(sid + 3, planes, out_ch, 1))
            setattr(self, f"{pre}_bn3", _bn(out_ch))
            if b == 0:
                base = sid
                setattr(self, f"{pre}_down_conv",
                        conv(base, in_ch, out_ch, 1, stride))
                setattr(self, f"{pre}_down_bn", _bn(out_ch))
        self.fc = QuantDense(512 * EXPANSION, num_classes, qbit=qbit,
                             ka=scales.ka[53], kw=scales.kw[53],
                             frozen_weights=frozen_weights, nonneg_input=True,
                             compute_dtype=compute_dtype, layer_id=53,
                             use_pallas=use_pallas)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: he_normal kernels, zero biases, unit BatchNorm."""
        for m in self.modules():
            if isinstance(m, (QuantConv, QuantDense)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for _, b, pre, *_ in block_names():
            identity = x
            y = relu(getattr(self, f"{pre}_bn1")(
                getattr(self, f"{pre}_conv1")(x)))
            y = relu(getattr(self, f"{pre}_bn2")(
                getattr(self, f"{pre}_conv2")(y)))
            y = getattr(self, f"{pre}_bn3")(getattr(self, f"{pre}_conv3")(y))
            if b == 0:
                identity = getattr(self, f"{pre}_down_bn")(
                    getattr(self, f"{pre}_down_conv")(x))
            x = relu(y + identity)
        return self.fc(torch.mean(x, dim=(2, 3)))
