"""Reference SLFP8 ShuffleNet V2 1.0x in plain PyTorch (Ma et al.,
"ShuffleNet V2: Practical Guidelines for Efficient CNN Architecture
Design", ECCV 2018, arXiv:1807.11164, Table 5; torchvision
``shufflenet_v2_x1_0`` computes the same float network), over a dict of
tensors named as the port's state_dict names them.

The network: a 3x3/s2 stem (3 -> 24) with BatchNorm and ReLU, a 3x3/s2/p1
max pool, three stages of 4, 8 and 4 units 116, 232 and 464 wide, a 1x1
conv5 (464 -> 1024) with BatchNorm and ReLU, the mean over H and W and a
1024 -> 1000 classifier.  A stride-1 unit passes the first half of its
channels through and runs the second half through 1x1 -> depthwise 3x3 ->
1x1; a downsample unit runs the whole input through a shortcut (depthwise
3x3/s2 -> 1x1 to ``out/2``) and a residual branch (1x1 ``in -> out/2``,
depthwise 3x3/s2, 1x1 ``out/2 -> out/2``).  Each unit concatenates
[shortcut or passed half, residual] and shuffles the channels in two
groups.  The split, the concatenation and the shuffle are plain indexing.

Departures from the paper, as the configuration states them:

- every conv (56) and the classifier are quantized to SLFP<3,4>, 8 bits:
  ``y = conv(Q_act(x / Ka), Q_weight(w / Kw)) * Ka Kw`` with float32 sums;
- the BatchNorms that the reference repository's ShuffleUnit marks (each
  unit's residual 1x1s, the shortcut's 1x1, and conv5) are followed by an
  SFP<4,4> layer-output quantize before their ReLU (:func:`sfp44`,
  written here from the format's definition);
- the stem's BatchNorm has no layer-output quantize (an assumption: the
  reference repository has no ImageNet ShuffleNetV2);
- BatchNorm in its inference form, weights and statistics from the seed
  (``benchmark/inputs.py``); no trained checkpoint.

Scale indices: 0 the stem; a stage with base ``b`` (0, 14, 40) gives its
downsample unit ``b+1..b+5`` (residual 1x1, depthwise, 1x1; shortcut
depthwise, 1x1) and its k-th stride-1 unit ``b+6+3(k-1)..+2``; 55 conv5,
56 the classifier.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import common
from benchmark.reference.common import Numerics

# (name, scale base, stride-1 units after the downsample one, width)
STAGES = [("stage2", 0, 3, 116), ("stage3", 14, 7, 232),
          ("stage4", 40, 3, 464)]
STEM_WIDTH, CONV5_WIDTH = 24, 1024
CONV5_ID, FC_ID = 55, 56
N_SCALES = 57

SFP44_MAX = 248.0            # (1 + 15/16) * 2**7
_F32_TINY = float(np.finfo(np.float32).tiny)


def units():
    """(unit name, scale ids, in channels, out channels, stride) of the 16
    units, in order."""
    out, cin = [], STEM_WIDTH
    for sname, base, repeat, c in STAGES:
        out.append((f"{sname}_u0", [base + 1 + j for j in range(5)], cin, c,
                    2))
        out += [(f"{sname}_u{k + 1}", [base + 6 + 3 * k + j for j in range(3)],
                 c, c, 1) for k in range(repeat)]
        cin = c
    return out


def convs():
    """(module name, scale index, in, out, kernel, stride, groups) of the 56
    convs, in order."""
    out = [("pre_conv", 0, 3, STEM_WIDTH, 3, 2, 1)]
    for name, ids, cin, cout, stride in units():
        h = cout // 2
        if stride == 2:
            out += [(f"{name}.res_conv1", ids[0], cin, h, 1, 1, 1),
                    (f"{name}.res_conv2", ids[1], h, h, 3, 2, h),
                    (f"{name}.res_conv3", ids[2], h, h, 1, 1, 1),
                    (f"{name}.short_conv1", ids[3], cin, cin, 3, 2, cin),
                    (f"{name}.short_conv2", ids[4], cin, h, 1, 1, 1)]
        else:
            out += [(f"{name}.res_conv1", ids[0], h, h, 1, 1, 1),
                    (f"{name}.res_conv2", ids[1], h, h, 3, 1, h),
                    (f"{name}.res_conv3", ids[2], h, h, 1, 1, 1)]
    out.append(("conv5", CONV5_ID, STAGES[-1][3], CONV5_WIDTH, 1, 1, 1))
    return out


def bn_name(conv_name: str) -> str:
    """The BatchNorm after a conv: ``pre_conv`` -> ``pre_bn``, ``conv5`` ->
    ``conv5_bn``, ``<unit>.res_convN`` -> ``<unit>.res_bnN``."""
    if conv_name == "pre_conv":
        return "pre_bn"
    if conv_name == "conv5":
        return "conv5_bn"
    return conv_name.replace("_conv", "_bn")


def param_shapes(num_classes: int = 1000) -> dict:
    """name -> shape of every tensor of the state_dict; a BatchNorm's
    ``num_batches_tracked`` is shape ()."""
    out = {}
    for name, _, cin, cout, k, _, groups in convs():
        out[f"{name}.weight"] = (cout, cin // groups, k, k)
        bn = bn_name(name)
        for key in ("weight", "bias", "running_mean", "running_var"):
            out[f"{bn}.{key}"] = (cout,)
        out[f"{bn}.num_batches_tracked"] = ()
    out["fc.weight"] = (num_classes, CONV5_WIDTH)
    out["fc.bias"] = (num_classes,)
    return out


def weight_ids() -> dict:
    """weight name -> scale index of each quantized layer."""
    out = {f"{name}.weight": sid for name, sid, *_ in convs()}
    out["fc.weight"] = FC_ID
    return out


def sfp44(x: torch.Tensor) -> torch.Tensor:
    """SFP<4,4> layer-output quantize of float32 values: a sign, 4 exponent
    bits and 4 fraction bits, so a magnitude ``(1 + f/16) * 2**e``; the
    fraction rounded to nearest, ties to even, and magnitudes of 248 and
    above saturated to 248.  As the reference repository applies it, no
    lower bound (its subnormal branch never fires): a small magnitude keeps
    its exponent.  float32 subnormal inputs count as zero."""
    x = x.to(torch.float32)
    x = torch.where(x.abs() < _F32_TINY, torch.zeros_like(x), x)
    ax = x.abs()
    m, e = torch.frexp(ax)                # ax = m * 2**e, m in [0.5, 1)
    # 5 significant bits: round(m * 32) in 16..32, times 2**(e - 5)
    mag = torch.round(m * 32.0) * torch.exp2((e - 5).to(torch.float32))
    mag = torch.where(ax >= SFP44_MAX, torch.full_like(mag, SFP44_MAX), mag)
    return torch.copysign(mag, x)


def channel_shuffle(x: torch.Tensor) -> torch.Tensor:
    """NCHW shuffle in two groups: channel ``j`` of the first half goes to
    ``2j``, channel ``j`` of the second to ``2j + 1``."""
    h = x.shape[1] // 2
    out = torch.empty_like(x)
    out[:, 0::2] = x[:, :h]
    out[:, 1::2] = x[:, h:]
    return out


def _head(p, xa, ka, kw, num):
    """Quantized classifier on pooled float32 features."""
    xq = common.quant(xa, ka[FC_ID], num)
    wq = common.quant_weight(p["fc.weight"], kw[FC_ID], num)
    k = common.kaw(ka[FC_ID], kw[FC_ID])
    y = common.matmul(xq, wq.t(), num)
    return (y + p["fc.bias"] * common.recip(k)) * k


def serve_forward(p: dict, x_nhwc: torch.Tensor, ka, kw, *, policy=None,
                  num: Numerics = Numerics(),
                  layer_outputs: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """bf16 logits of NHWC float32 images, the served network's numerics:
    every quantized input taken from the float32 value its layer computed,
    except where a value is held in bfloat16 first: the stem's pooled
    output, each unit's output (so each unit's input, whose second half a
    stride-1 unit quantizes) and conv5's output, which is pooled in
    float32.  TF32 stays off throughout.  The executor takes no
    ``policy``.

    ``layer_outputs=torch.bfloat16`` holds besides every conv's output,
    every BatchNorm's output and the pooled features in bfloat16: the
    numerics of the port's module path (``fused=False``), not the served
    network's."""
    with common.tf32(False):
        return _serve(p, x_nhwc, ka, kw, num, layer_outputs)


def _serve(p, x_nhwc, ka, kw, num, layer_outputs):
    relu, bf16, q = common.relu, common.bf16, common.quant
    held = bf16 if layer_outputs == torch.bfloat16 else (lambda v: v)
    layers = {name: (sid, k, stride, groups)
              for name, sid, _, _, k, stride, groups in convs()}

    def conv(xq, name):
        sid, k, stride, groups = layers[name]
        wq = common.quant_weight(p[f"{name}.weight"], kw[sid], num)
        v = held(common.conv(xq, wq, num, stride=stride, pad=k // 2,
                             groups=groups) * common.kaw(ka[sid], kw[sid]))
        return held(common.batch_norm(v, p, bn_name(name), False))

    def post(v):
        return relu(sfp44(v))

    x = x_nhwc.permute(0, 3, 1, 2)
    y = bf16(relu(conv(q(x, ka[0], num), "pre_conv")))
    y = F.max_pool2d(y, 3, 2, 1)
    for name, ids, _, _, stride in units():
        if stride == 2:
            xs = xr = y
        else:
            h = y.shape[1] // 2
            xs, xr = y[:, :h], y[:, h:]
        r = q(post(conv(q(xr, ka[ids[0]], num), f"{name}.res_conv1")),
              ka[ids[1]], num)
        r = q(conv(r, f"{name}.res_conv2"), ka[ids[2]], num)
        r = bf16(post(conv(r, f"{name}.res_conv3")))
        if stride == 2:
            s = q(conv(q(xs, ka[ids[3]], num), f"{name}.short_conv1"),
                  ka[ids[4]], num)
            s = bf16(post(conv(s, f"{name}.short_conv2")))
        else:
            s = xs
        y = channel_shuffle(torch.cat([s, r], dim=1))
    y = bf16(post(conv(q(y, ka[CONV5_ID], num), "conv5")))
    xa = held(torch.mean(y.permute(0, 2, 3, 1), dim=(1, 2)))
    return _head(p, xa, ka, kw, num).to(torch.bfloat16)


def calibrate(p: dict, x_nhwc: torch.Tensor, cal: common.Calibrator):
    """An unquantized float32 forward (no layer-output quantize either) that
    records every quantized layer's input max and lets ``cal`` set each
    BatchNorm as it reaches it."""
    layers = {name: (sid, k, stride, groups)
              for name, sid, _, _, k, stride, groups in convs()}
    relu = common.relu

    def conv(v, name):
        sid, k, stride, groups = layers[name]
        cal.seen(sid, v)
        v = F.conv2d(v, p[f"{name}.weight"], stride=stride, padding=k // 2,
                     groups=groups)
        return cal.bn(p, v, bn_name(name))

    with torch.no_grad():
        x = x_nhwc.to(torch.float32).permute(0, 3, 1, 2)
        y = F.max_pool2d(relu(conv(x, "pre_conv")), 3, 2, 1)
        for name, _, _, _, stride in units():
            if stride == 2:
                xs = xr = y
            else:
                h = y.shape[1] // 2
                xs, xr = y[:, :h], y[:, h:]
            r = relu(conv(xr, f"{name}.res_conv1"))
            r = conv(r, f"{name}.res_conv2")
            r = relu(conv(r, f"{name}.res_conv3"))
            if stride == 2:
                s = relu(conv(conv(xs, f"{name}.short_conv1"),
                              f"{name}.short_conv2"))
            else:
                s = xs
            y = channel_shuffle(torch.cat([s, r], dim=1))
        y = relu(conv(y, "conv5"))
        cal.seen(FC_ID, torch.mean(y, dim=(2, 3)))
