"""Reference SLFP8 MobileNetV1 1.0-224 in plain PyTorch (Howard et al.,
arXiv:1704.04861; the reference repository's ``nets_imgnet/mobilenetv1.py``),
over a dict of tensors named as the port's state_dict names them.

A 3x3 stride-2 stem, 13 depthwise-separable blocks (depthwise 3x3, then
pointwise 1x1), each conv followed by BatchNorm and ReLU, the mean over H
and W, and a float32 classifier (``nn.Linear``, not quantized).  Scale
indices: 0 for the stem, ``1 + 2b`` and ``2 + 2b`` for block ``b``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import common
from benchmark.reference.common import Numerics

# (in, out, stride) of the 13 depthwise-separable blocks
DW_CONFIG = [
    (32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2), (256, 256, 1),
    (256, 512, 2), (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
    (512, 512, 1), (512, 1024, 2), (1024, 1024, 1),
]
N_SCALES = 28          # the classifier's index 27 is kept, not used


def convs():
    """(scale index, in, out, kernel, stride, groups) of the 27 convs."""
    out = [(0, 3, 32, 3, 2, 1)]
    for b, (cin, cout, stride) in enumerate(DW_CONFIG):
        out.append((1 + 2 * b, cin, cin, 3, stride, cin))
        out.append((2 + 2 * b, cin, cout, 1, 1, 1))
    return out


def param_shapes(num_classes: int = 1000) -> dict:
    out = {}
    for i, cin, cout, k, _, groups in convs():
        out[f"conv{i}.weight"] = (cout, cin // groups, k, k)
        for key in ("weight", "bias", "running_mean", "running_var"):
            out[f"bn{i}.{key}"] = (cout,)
        out[f"bn{i}.num_batches_tracked"] = ()
    out["fc.weight"] = (num_classes, DW_CONFIG[-1][1])
    out["fc.bias"] = (num_classes,)
    return out


def weight_ids() -> dict:
    """weight name -> scale index of each quantized layer."""
    return {f"conv{i}.weight": i for i, *_ in convs()}


def serve_forward(p: dict, x_nhwc: torch.Tensor, ka, kw, *, policy=None,
                  num: Numerics = Numerics()) -> torch.Tensor:
    """Float32 logits of NHWC float32 images, the served network's
    numerics: every quantized input taken from the float32 value its layer
    computed (BatchNorm's inference form, ReLU); the last block's output
    held in bf16, pooled in float32, and the float32 classifier in full
    float32.  Every ``policy`` of the executor gives these numerics."""
    q = common.quant
    y = q(x_nhwc.permute(0, 3, 1, 2), ka[0], num)
    layers = convs()
    for j, (i, _, _, k, stride, groups) in enumerate(layers):
        wq = common.quant_weight(p[f"conv{i}.weight"], kw[i], num)
        v = common.conv(y, wq, num, stride=stride, pad=k // 2,
                        groups=groups) * common.kaw(ka[i], kw[i])
        v = common.relu(common.batch_norm(v, p, f"bn{i}", False))
        y = (q(v, ka[i + 1], num) if j + 1 < len(layers)
             else common.bf16(v))
    xa = torch.mean(y.permute(0, 2, 3, 1), dim=(1, 2))
    with common.tf32(False):
        return xa @ p["fc.weight"].t() + p["fc.bias"]


def calibrate(p: dict, x_nhwc: torch.Tensor, cal: common.Calibrator):
    """An unquantized float32 forward that records every quantized layer's
    input max (the classifier's too, for a complete scale set) and lets
    ``cal`` set each BatchNorm as it reaches it."""
    with torch.no_grad():
        y = x_nhwc.to(torch.float32).permute(0, 3, 1, 2)
        for i, _, _, k, stride, groups in convs():
            cal.seen(i, y)
            y = F.conv2d(y, p[f"conv{i}.weight"], stride=stride,
                         padding=k // 2, groups=groups)
            y = common.relu(cal.bn(p, y, f"bn{i}"))
        cal.seen(N_SCALES - 1, torch.mean(y, dim=(2, 3)))
