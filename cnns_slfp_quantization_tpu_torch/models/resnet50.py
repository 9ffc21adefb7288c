"""ResNet-50 v1.5 for ImageNet-1k (counterpart of the JAX
``models/resnet50.py``; reference nets_imgnet/resnet50.py).

54 quantized layers: the stem conv (scale index 0), 16 bottlenecks of three
convs plus 4 downsample convs, and the FC (index 53).  Within a stage with
scale base ``base``, the downsample conv uses ``base`` and block ``b``'s
conv1..3 use ``base+3b+1..+3``.  Submodules carry the flax names (``conv1``,
``bn1``, ``layer1_0_conv1``, ..., ``fc``) in flax's call order.

``act`` (relu, swish, stl or gelu) and ``layerout_quant`` (an SFP<4,4>
layer-output quantize before each activation, ``loq1``, ``{block}_loq1..3``)
make the activation-optimized variants ``resnet_stl`` / ``resnet_swish``
(JAX resnet50.py:52-53).  A smooth activation emits signed values, so every
quantizer keeps its sign handling there.  Inputs are
NHWC float32, as in JAX; the layers run NCHW views in channels_last
memory.
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
    LayeroutQuant,
    QuantConv,
    QuantDense,
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


class ResNet50(nn.Module):
    def __init__(self, scales: ScaleSet, num_classes: int = 1000,
                 qbit: int = 32, frozen_weights: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_pallas: Optional[bool] = None,
                 act: str = "relu", layerout_quant: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scales = scales
        self.qbit = qbit
        self.act = act
        self.act_fn = activations.get(act)
        self.layerout_quant = layerout_quant
        # with ReLU every conv input but the stem's (the signed image) is
        # post-ReLU/maxpool
        nonneg_in = act == "relu"

        def conv(sid, cin, cout, k, stride=1, pad=0, nonneg=nonneg_in):
            return QuantConv(cin, cout, k, stride=stride, padding=pad,
                             qbit=qbit, ka=scales.ka[sid], kw=scales.kw[sid],
                             frozen_weights=frozen_weights,
                             nonneg_input=nonneg, compute_dtype=compute_dtype,
                             layer_id=sid, use_pallas=use_pallas)

        def loq(name):
            if layerout_quant:
                setattr(self, name, LayeroutQuant(qbit))

        self.conv1 = conv(0, 3, 64, 7, 2, 3, nonneg=False)
        self.bn1 = BatchNorm2d(64)
        loq("loq1")
        for _, b, pre, sid, stride, planes, in_ch in block_names():
            out_ch = planes * EXPANSION
            setattr(self, f"{pre}_conv1", conv(sid + 1, in_ch, planes, 1))
            setattr(self, f"{pre}_bn1", BatchNorm2d(planes))
            loq(f"{pre}_loq1")
            setattr(self, f"{pre}_conv2",
                    conv(sid + 2, planes, planes, 3, stride, 1))
            setattr(self, f"{pre}_bn2", BatchNorm2d(planes))
            loq(f"{pre}_loq2")
            setattr(self, f"{pre}_conv3", conv(sid + 3, planes, out_ch, 1))
            setattr(self, f"{pre}_bn3", BatchNorm2d(out_ch))
            if b == 0:
                base = sid
                setattr(self, f"{pre}_down_conv",
                        conv(base, in_ch, out_ch, 1, stride))
                setattr(self, f"{pre}_down_bn", BatchNorm2d(out_ch))
            loq(f"{pre}_loq3")
        self.fc = QuantDense(512 * EXPANSION, num_classes, qbit=qbit,
                             ka=scales.ka[53], kw=scales.kw[53],
                             frozen_weights=frozen_weights,
                             nonneg_input=nonneg_in,
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

    def flax_order(self):
        """Modules holding variables, in flax's init order (JAX
        resnet50.py:81-123): the reference ``.pth`` import's positional
        match follows it."""
        out = ["conv1", "bn1"]
        for _, b, pre, *_ in block_names():
            out += [f"{pre}_{n}" for n in ("conv1", "bn1", "conv2", "bn2",
                                            "conv3", "bn3")]
            if b == 0:
                out += [f"{pre}_down_conv", f"{pre}_down_bn"]
        return out + ["fc"]

    def _act(self, x: torch.Tensor, loq: str) -> torch.Tensor:
        if self.layerout_quant:
            x = getattr(self, loq)(x)
        return self.act_fn(x)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """conv1 -> bn1 -> act -> max pool, on NCHW."""
        x = self._act(self.bn1(self.conv1(x)), "loq1")
        return F.max_pool2d(x, 3, 2, 1)

    def block(self, x: torch.Tensor, pre: str) -> torch.Tensor:
        """The bottleneck named ``pre`` (``layer1_0``, ...), on NCHW."""
        identity = x
        y = self._act(getattr(self, f"{pre}_bn1")(
            getattr(self, f"{pre}_conv1")(x)), f"{pre}_loq1")
        y = self._act(getattr(self, f"{pre}_bn2")(
            getattr(self, f"{pre}_conv2")(y)), f"{pre}_loq2")
        y = getattr(self, f"{pre}_bn3")(getattr(self, f"{pre}_conv3")(y))
        if hasattr(self, f"{pre}_down_conv"):
            identity = getattr(self, f"{pre}_down_bn")(
                getattr(self, f"{pre}_down_conv")(x))
        return self._act(y + identity, f"{pre}_loq3")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.permute(0, 3, 1, 2))
        for _, _, pre, *_ in block_names():
            x = self.block(x, pre)
        return self.fc(torch.mean(x, dim=(2, 3)))
