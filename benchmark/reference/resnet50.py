"""Reference SLFP8 ResNet-50 v1.5 in plain PyTorch (He et al.,
arXiv:1512.03385; torchvision ``resnet50``: the stride on the 3x3 conv),
over a dict of tensors named as the port's state_dict names them.

Scale indices as the reference repository's ``nets_imgnet/resnet50.py``:
the stem 0, then per stage with base ``b0`` the downsample conv ``b0`` and
block ``b``'s conv1..3 ``b0 + 3b + 1..3``, the classifier 53.

Two forms, as the configuration states them:

- :func:`serve_forward`, the served network: BatchNorm's inference form;
  every quantized input taken from the float32 value its layer computed,
  except where a value is held in bfloat16 first: the stem's output, the
  downsample branch, the residual stream between blocks of a stage, and
  the last block's output.  A block inside a stage quantizes the stream as
  held in bf16, except after a block of a stage in the policy's ``chain``
  (any but the stage's first), whose successor takes its quantized input
  from the float32 value.  A stage's last block hands the next stage the
  float32 value quantized.  The head pools the bf16 stream in float32,
  quantizes it, and returns bf16 logits.
- :func:`train_forward`, the QAT step's network (compute dtype bf16):
  every layer's output, every BatchNorm's output and each residual sum in
  bf16; BatchNorm on the batch's statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import common
from benchmark.reference.common import Numerics

STAGES = [(64, 3, 1, 1), (128, 4, 2, 11), (256, 6, 2, 24), (512, 3, 2, 43)]
EXPANSION = 4
FC_ID = 53
N_SCALES = 54


def blocks():
    """(stage, block, name prefix, scale base, stride, planes, in
    channels)."""
    out, cin = [], 64
    for s, (planes, n, stride, base) in enumerate(STAGES):
        for b in range(n):
            out.append((s, b, f"layer{s + 1}_{b}", base + 3 * b,
                        stride if b == 0 else 1, planes, cin))
            cin = planes * EXPANSION
    return out


def param_shapes(num_classes: int = 1000) -> dict:
    """name -> shape of every tensor of the state_dict, in order; a
    BatchNorm's ``num_batches_tracked`` is shape ()."""
    out = {}

    def conv(name, cin, cout, k):
        out[f"{name}.weight"] = (cout, cin, k, k)

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{k}"] = (c,)
        out[f"{name}.num_batches_tracked"] = ()

    conv("conv1", 3, 64, 7)
    bn("bn1", 64)
    for _, b, pre, _, _, planes, cin in blocks():
        conv(f"{pre}_conv1", cin, planes, 1)
        bn(f"{pre}_bn1", planes)
        conv(f"{pre}_conv2", planes, planes, 3)
        bn(f"{pre}_bn2", planes)
        conv(f"{pre}_conv3", planes, planes * EXPANSION, 1)
        bn(f"{pre}_bn3", planes * EXPANSION)
        if b == 0:
            conv(f"{pre}_down_conv", cin, planes * EXPANSION, 1)
            bn(f"{pre}_down_bn", planes * EXPANSION)
    out["fc.weight"] = (num_classes, 512 * EXPANSION)
    out["fc.bias"] = (num_classes,)
    return out


def weight_ids() -> dict:
    """weight name -> scale index of each quantized layer."""
    out = {"conv1.weight": 0}
    for _, b, pre, sid, *_ in blocks():
        for j in (1, 2, 3):
            out[f"{pre}_conv{j}.weight"] = sid + j
        if b == 0:
            out[f"{pre}_down_conv.weight"] = sid
    out["fc.weight"] = FC_ID
    return out


def _layer(p, ka, kw, num):
    """conv(xq, name, sid, stride, pad): the float32 sums times Ka Kw."""
    def conv(xq, name, sid, stride, pad):
        wq = common.quant_weight(p[f"{name}.weight"], kw[sid], num)
        return common.conv(xq, wq, num, stride=stride,
                           pad=pad) * common.kaw(ka[sid], kw[sid])
    return conv


def _head(p, xa, ka, kw, num):
    """Quantized classifier on pooled float32 features."""
    xq = common.quant(xa, ka[FC_ID], num)
    wq = common.quant_weight(p["fc.weight"], kw[FC_ID], num)
    k = common.kaw(ka[FC_ID], kw[FC_ID])
    y = common.matmul(xq, wq.t(), num)
    return (y + p["fc.bias"] * common.recip(k)) * k


def serve_forward(p: dict, x_nhwc: torch.Tensor, ka, kw, *, policy: dict,
                  num: Numerics = Numerics()) -> torch.Tensor:
    """bf16 logits of NHWC float32 images, the served network's numerics
    under the executor's ``policy`` (its ``chain`` stages)."""
    chain = set(policy["chain"])
    conv = _layer(p, ka, kw, num)
    relu, bf16, q = common.relu, common.bf16, common.quant

    def bn(v, name):
        return common.batch_norm(v, p, name, False)

    x = x_nhwc.permute(0, 3, 1, 2)
    raw = bf16(relu(bn(conv(q(x, ka[0], num), "conv1", 0, 2, 3), "bn1")))
    raw = F.max_pool2d(raw, 3, 2, 1)
    xq = None                 # the next block's quantized input, if given
    for s, b, pre, sid, stride, _, _ in blocks():
        xin = xq if xq is not None else q(raw, ka[sid + 1], num)
        identity = (bf16(bn(conv(xin, f"{pre}_down_conv", sid, stride, 0),
                            f"{pre}_down_bn")) if b == 0 else raw)
        y = q(relu(bn(conv(xin, f"{pre}_conv1", sid + 1, 1, 0),
                      f"{pre}_bn1")), ka[sid + 2], num)
        y = q(relu(bn(conv(y, f"{pre}_conv2", sid + 2, stride, 1),
                      f"{pre}_bn2")), ka[sid + 3], num)
        v = relu(bn(conv(y, f"{pre}_conv3", sid + 3, 1, 0), f"{pre}_bn3")
                 + identity)
        if b == STAGES[s][1] - 1 and s + 1 < len(STAGES):
            xq, raw = q(v, ka[STAGES[s + 1][3] + 1], num), None
        elif b == STAGES[s][1] - 1:
            xq, raw = None, bf16(v)
        else:
            raw = bf16(v)
            xq = (q(v, ka[sid + 4], num) if s in chain and b > 0 else None)
    xa = torch.mean(raw.permute(0, 2, 3, 1), dim=(1, 2))
    return _head(p, xa, ka, kw, num).to(torch.bfloat16)


def train_forward(p: dict, x_nhwc: torch.Tensor, ka, kw, *,
                  num: Numerics = Numerics()) -> torch.Tensor:
    """bf16 logits of NHWC float32 images, the QAT step's numerics
    (training-mode BatchNorm)."""
    conv = _layer(p, ka, kw, num)
    relu, q = common.relu, common.quant

    def layer(v, name, sid, stride, pad, bn_name):
        y = conv(q(v, ka[sid], num), name, sid, stride, pad)
        return common.batch_norm(y.to(torch.bfloat16), p, bn_name, True)

    x = x_nhwc.permute(0, 3, 1, 2)
    y = F.max_pool2d(relu(layer(x, "conv1", 0, 2, 3, "bn1")), 3, 2, 1)
    for _, b, pre, sid, stride, _, _ in blocks():
        z = relu(layer(y, f"{pre}_conv1", sid + 1, 1, 0, f"{pre}_bn1"))
        z = relu(layer(z, f"{pre}_conv2", sid + 2, stride, 1, f"{pre}_bn2"))
        z = layer(z, f"{pre}_conv3", sid + 3, 1, 0, f"{pre}_bn3")
        identity = (layer(y, f"{pre}_down_conv", sid, stride, 0,
                          f"{pre}_down_bn") if b == 0 else y)
        y = relu(z + identity)
    return _head(p, torch.mean(y, dim=(2, 3)), ka, kw,
                 num).to(torch.bfloat16)


def calibrate(p: dict, x_nhwc: torch.Tensor, cal: common.Calibrator):
    """An unquantized float32 forward that records every quantized layer's
    input max and lets ``cal`` set each BatchNorm as it reaches it."""

    def conv(v, name, sid, stride, pad):
        cal.seen(sid, v)
        return F.conv2d(v, p[f"{name}.weight"], stride=stride, padding=pad)

    def bn(v, name):
        return cal.bn(p, v, name)

    relu = common.relu
    with torch.no_grad():
        x = x_nhwc.to(torch.float32).permute(0, 3, 1, 2)
        y = F.max_pool2d(relu(bn(conv(x, "conv1", 0, 2, 3), "bn1")), 3, 2, 1)
        for _, b, pre, sid, stride, _, _ in blocks():
            z = relu(bn(conv(y, f"{pre}_conv1", sid + 1, 1, 0), f"{pre}_bn1"))
            z = relu(bn(conv(z, f"{pre}_conv2", sid + 2, stride, 1),
                        f"{pre}_bn2"))
            z = bn(conv(z, f"{pre}_conv3", sid + 3, 1, 0), f"{pre}_bn3")
            identity = (bn(conv(y, f"{pre}_down_conv", sid, stride, 0),
                           f"{pre}_down_bn") if b == 0 else y)
            y = relu(z + identity)
        cal.seen(FC_ID, torch.mean(y, dim=(2, 3)))
