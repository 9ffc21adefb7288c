"""ShuffleNetV2 for CIFAR-100 (counterpart of the JAX
``models/shufflenetv2.py``; reference nets_cifar/shufflenet_v2.py).

Width plans 0.5/1/1.5/2x (``ratio``).  Every conv is quantized; the BNs the
reference's ShuffleUnit marks are followed by the SFP<4,4> layer-output
quantize and ReLU.  The stem is a 3x3 conv + BN with no activation.  Scale
indices: 0 the stem; a stage with base ``b`` gives its stride-2 unit
``b+1..b+5`` (residual conv1, dw, conv3; shortcut dw, conv) and its k-th
stride-1 unit ``b+6+3k..+2``; stage bases 0, 14, 40; 55 ``conv5``; 56 the
classifier.  Submodules carry the flax names (``pre_conv``,
``stage2_u0.res_conv1``, ..., ``conv5_loq``, ``fc``) in flax's call order.
Inputs are NHWC float32, as in JAX; the layers run NCHW views in
channels_last memory.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cnns_slfp_quantization_tpu_torch.calib import ScaleSet
from cnns_slfp_quantization_tpu_torch.ops.layers import (
    BatchNorm2d,
    LayeroutQuant,
    QuantConv,
    QuantDense,
    relu,
)

# per ratio: the three stages' widths and conv5's, JAX shufflenetv2.py:113
STAGE_CHANNELS = {0.5: [48, 96, 192, 1024], 1: [116, 232, 464, 1024],
                  1.5: [176, 352, 704, 1024], 2: [244, 488, 976, 2048]}
# (name, scale base, stride-1 units after the stride-2 one), JAX :162-164
STAGES = [("stage2", 0, 3), ("stage3", 14, 7), ("stage4", 40, 3)]
CONV5_ID, FC_ID = 55, 56


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """NCHW channel shuffle (reference :31-45): channel ``g*(C/groups) + j``
    moves to ``j*groups + g``."""
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(
        b, c, h, w)


def units(ratio: float = 1):
    """(unit name, scale ids, in channels, out channels, stride, nonneg_in)
    of every unit, in order (JAX ``stage``, :146-160)."""
    out_ch = STAGE_CHANNELS[ratio]
    out, in_c = [], 24
    for s, (sname, base, repeat) in enumerate(STAGES):
        c = out_ch[s]
        # the first unit's input is the stem's BN output, signed
        out.append((f"{sname}_u0", [base + 1 + j for j in range(5)], in_c, c,
                    2, base != 0))
        out += [(f"{sname}_u{k + 1}", [base + 6 + 3 * k + j for j in range(3)],
                 c, c, 1, True) for k in range(repeat)]
        in_c = c
    return out


class ShuffleUnit(nn.Module):
    """One unit (reference ShuffleUnit :47-114): the downsample form
    (stride 2, or a change of width) has a residual and a shortcut branch
    over the whole input; the identity form splits the channels and runs
    the residual branch on the second half."""

    def __init__(self, scales: ScaleSet, scale_ids, in_channels: int,
                 out_channels: int, stride: int, nonneg_in: bool = True,
                 qbit: int = 32, frozen_weights: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_pallas: Optional[bool] = None):
        super().__init__()
        ids = list(scale_ids)
        self.downsample = stride != 1 or in_channels != out_channels
        rc = in_channels if self.downsample else in_channels // 2
        out_half = out_channels // 2 if self.downsample else rc

        def conv(sid, cin, cout, k, stride=1, groups=1, pad=0, nonneg=False):
            return QuantConv(cin, cout, k, stride=stride, padding=pad,
                             groups=groups, qbit=qbit, ka=scales.ka[sid],
                             kw=scales.kw[sid], frozen_weights=frozen_weights,
                             nonneg_input=nonneg, compute_dtype=compute_dtype,
                             layer_id=sid, use_pallas=use_pallas)

        self.res_conv1 = conv(ids[0], rc, rc, 1, nonneg=nonneg_in)
        self.res_bn1 = BatchNorm2d(rc)
        self.res_loq1 = LayeroutQuant(qbit)
        self.res_conv2 = conv(ids[1], rc, rc, 3, stride, groups=rc, pad=1,
                              nonneg=True)
        self.res_bn2 = BatchNorm2d(rc)
        self.res_conv3 = conv(ids[2], rc, out_half, 1)
        self.res_bn3 = BatchNorm2d(out_half)
        self.res_loq3 = LayeroutQuant(qbit)
        if self.downsample:
            self.short_conv1 = conv(ids[3], rc, rc, 3, stride, groups=rc,
                                    pad=1, nonneg=nonneg_in)
            self.short_bn1 = BatchNorm2d(rc)
            self.short_conv2 = conv(ids[4], rc, out_channels // 2, 1)
            self.short_bn2 = BatchNorm2d(out_channels // 2)
            self.short_loq2 = LayeroutQuant(qbit)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            s = r = x
        else:
            half = x.shape[1] // 2
            s, r = x[:, :half], x[:, half:]
        r = relu(self.res_loq1(self.res_bn1(self.res_conv1(r))))
        r = self.res_bn2(self.res_conv2(r))
        r = relu(self.res_loq3(self.res_bn3(self.res_conv3(r))))
        if self.downsample:
            s = self.short_bn1(self.short_conv1(s))
            s = relu(self.short_loq2(self.short_bn2(self.short_conv2(s))))
        return channel_shuffle(torch.cat([s, r], dim=1), 2)


class ShuffleNetV2(nn.Module):
    def __init__(self, scales: ScaleSet, num_classes: int = 100,
                 qbit: int = 32, ratio: float = 1,
                 frozen_weights: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_pallas: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scales = scales
        self.qbit = qbit
        self.ratio = ratio
        common = dict(qbit=qbit, frozen_weights=frozen_weights,
                      compute_dtype=compute_dtype, use_pallas=use_pallas)
        self.pre_conv = QuantConv(3, 24, 3, padding=1, ka=scales.ka[0],
                                  kw=scales.kw[0], layer_id=0, **common)
        self.pre_bn = BatchNorm2d(24)
        for name, ids, cin, cout, stride, nonneg_in in units(ratio):
            setattr(self, name, ShuffleUnit(scales, ids, cin, cout, stride,
                                            nonneg_in, **common))
        width, c5 = STAGE_CHANNELS[ratio][2:]
        self.conv5 = QuantConv(width, c5, 1, ka=scales.ka[CONV5_ID],
                               kw=scales.kw[CONV5_ID], nonneg_input=True,
                               layer_id=CONV5_ID, **common)
        self.conv5_bn = BatchNorm2d(c5)
        self.conv5_loq = LayeroutQuant(qbit)
        self.fc = QuantDense(c5, num_classes, ka=scales.ka[FC_ID],
                             kw=scales.kw[FC_ID], nonneg_input=True,
                             layer_id=FC_ID, **common)
        for m in self.modules():
            if isinstance(m, (QuantConv, QuantDense)):
                m.reset_parameters(generator)

    def flax_order(self):
        """Modules holding variables, in flax's init order (JAX
        shufflenetv2.py:86-184): the reference ``.pth`` import's positional
        match follows it."""
        out = ["pre_conv", "pre_bn"]
        for name, _, cin, cout, stride, _ in units(self.ratio):
            parts = ["res_conv1", "res_bn1", "res_conv2", "res_bn2",
                     "res_conv3", "res_bn3"]
            if stride != 1 or cin != cout:
                parts += ["short_conv1", "short_bn1", "short_conv2",
                          "short_bn2"]
            out += [f"{name}.{p}" for p in parts]
        return out + ["conv5", "conv5_bn", "fc"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre_bn(self.pre_conv(x.permute(0, 3, 1, 2)))
        for name, *_ in units(self.ratio):
            x = getattr(self, name)(x)
        x = relu(self.conv5_loq(self.conv5_bn(self.conv5(x))))
        return self.fc(torch.mean(x, dim=(2, 3)))
