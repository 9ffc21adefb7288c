"""Fused SLFP8 ShuffleNetV2 inference executor (counterpart of the JAX
``models/shufflenetv2_fused.py::fused_apply``), over the same frozen (or
packed) :class:`ShuffleNetV2` the module path serves.

:func:`prepare` lays the model out once: BatchNorm folded with Ka*Kw into a
per-channel ``scale``/``shift`` (``resnet50_fused.bn_fold``), uint8 codes
decoded, the 1x1 kernels as ``[Cin, Cout]`` float32 holding the bf16
values, the 3x3 stem and the depthwise kernels as OIHW in channels_last
memory, the classifier bias as ``bias * f32(1/(ka*kw))`` (XLA's quotient by
a constant).  :func:`fused_apply` then runs the network on NHWC
activations.  Each conv's output goes through JAX's ``post``: the folded
affine, then for the BNs the reference marks the SFP<4,4> layer-output
quantize and ReLU, then the next conv's SLFP<3,4> input quantize:

  stem        K1 signed quantize -> 3x3 conv (cuDNN, f32 out) -> K3 (affine,
              raw bf16, no ReLU)
  unit input  K1: one pass shared by both branches of a downsample unit
              when their Ka agree (else one per branch), the second half of
              the channels in a stride-1 unit
  res conv1   matmul -> affine, layer-output quantize, ReLU (plain ops) ->
              K1 for the depthwise conv
  res / short depthwise conv (cuDNN, f32 out) -> K3 (affine, signed
              quantize for the next 1x1 conv, no ReLU)
  res conv3,  matmul -> affine, layer-output quantize, ReLU (plain ops) ->
  short conv2 bf16; then concat, channel shuffle (one copy)
  head        K1 -> conv5 matmul -> affine, layer-output quantize, ReLU ->
              f32 mean -> K1 -> f32 matmul -> ``(y + b') * kaw`` in bf16

Per forward: K1 35 launches and K3 20 (38 and 20 when a downsample unit's
two Ka differ).  Every quantize site JAX runs as ``quantize_act_pass``
runs on K1 or, where JAX quantizes a bare affine output (``loq=False``),
on K3, which computes the same ``act_bf16_bits(fma(y, s, t))`` in one
pass.  The affine -> layer-output quantize -> ReLU chain of the other
sites is XLA's fused elementwise work in JAX, not a Pallas kernel; here it
runs as PyTorch ops (``affine_f32``, ``sfp.quantize_layerout``,
``relu``).  The convolutions and matmuls take float32 tensors that hold
bf16 values, under :func:`backend_flags`, as in :mod:`.resnet50_fused`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch.kernels import epilogue as k3
from cnns_slfp_quantization_tpu_torch.kernels.epilogue import affine_f32
from cnns_slfp_quantization_tpu_torch.kernels.quantize import act_quantize
from cnns_slfp_quantization_tpu_torch.models.resnet50_fused import (
    ConvKxK,
    _bf16_values,
    _conv_f32,
    _flat,
    _mm_f32,
    bn_fold,
)
from cnns_slfp_quantization_tpu_torch.models.shufflenetv2 import (
    CONV5_ID,
    FC_ID,
    ShuffleNetV2,
    units,
)
from cnns_slfp_quantization_tpu_torch.ops import freeze, sfp
from cnns_slfp_quantization_tpu_torch.ops.backend import backend_flags
from cnns_slfp_quantization_tpu_torch.ops.layers import relu


@dataclasses.dataclass
class Unit:
    ids: list              # the unit's scale ids (5 downsample, 3 stride-1)
    downsample: bool
    nonneg_in: bool        # the unit input is a ReLU output
    shared: bool           # downsample: one quantize feeds both branches
    res1: ConvKxK          # w [Cin, Cout] float32 (bf16 values)
    res2: ConvKxK          # depthwise, OIHW channels_last
    res3: ConvKxK          # [Cin, Cout]
    short1: Optional[ConvKxK] = None   # depthwise
    short2: Optional[ConvKxK] = None   # [Cin, Cout]


@dataclasses.dataclass
class FusedWeights:
    stem: ConvKxK          # 3x3/s1/p1, OIHW channels_last
    units: list
    conv5: ConvKxK         # [Cin, 1024] float32 (bf16 values)
    fc_w: torch.Tensor     # [1024, classes] float32 (bf16 values)
    fc_b: torch.Tensor     # float32(b) * float32(1/kaw)
    kaw_fc: torch.Tensor   # float32 0-d
    recips: list           # recips[i] = 1/Ka as JAX computes it


def prepare(model: ShuffleNetV2, *, device="cuda") -> FusedWeights:
    """Fold and lay out a frozen SLFP8 ShuffleNetV2 for
    :func:`fused_apply`."""
    for _, layer in freeze.quant_layers(model):
        if not layer.frozen_weights or layer.qbit != 8:
            raise ValueError("fused executor needs frozen SLFP8 weights "
                             "(ops.freeze.prequantize or pack at qbit 8)")
    ka, kw = model.scales.ka, model.scales.kw
    recips = [sfp.recip_of(a) for a in ka]

    def vec(a):
        return torch.from_numpy(a).to(device)

    def conv(layer, bn, *, pointwise):
        i = layer.layer_id
        s, t = bn_fold(bn, float(ka[i]) * float(kw[i]))
        w = _bf16_values(layer.weight).float()
        if pointwise:                     # [Cout, Cin, 1, 1] -> [Cin, Cout]
            w = w[:, :, 0, 0].t().contiguous()
        else:
            w = w.contiguous(memory_format=torch.channels_last)
        return ConvKxK(w=w.to(device), scale=vec(s), shift=vec(t),
                       stride=layer.stride, pad=layer.padding,
                       groups=layer.groups,
                       # K3's route, decided here once
                       ftz=k3.ftz_route(torch.from_numpy(s),
                                        torch.from_numpy(t), recips))

    out = []
    for name, ids, _, _, _, nonneg_in in units(model.ratio):
        u = getattr(model, name)
        out.append(Unit(
            ids=ids, downsample=u.downsample, nonneg_in=nonneg_in,
            shared=u.downsample and float(ka[ids[0]]) == float(ka[ids[3]]),
            res1=conv(u.res_conv1, u.res_bn1, pointwise=True),
            res2=conv(u.res_conv2, u.res_bn2, pointwise=False),
            res3=conv(u.res_conv3, u.res_bn3, pointwise=True),
            short1=(conv(u.short_conv1, u.short_bn1, pointwise=False)
                    if u.downsample else None),
            short2=(conv(u.short_conv2, u.short_bn2, pointwise=True)
                    if u.downsample else None)))
    kaw = np.float32(float(ka[FC_ID]) * float(kw[FC_ID]))
    fc_b = model.fc.bias.detach().cpu().numpy().astype(np.float32)
    return FusedWeights(
        stem=conv(model.pre_conv, model.pre_bn, pointwise=False),
        units=out,
        conv5=conv(model.conv5, model.conv5_bn, pointwise=True),
        fc_w=_bf16_values(model.fc.weight).float().t().contiguous().to(
            device),
        fc_b=vec((fc_b * (np.float32(1) / kaw)).astype(np.float32)),
        kaw_fc=torch.tensor(kaw, device=device), recips=recips)


def fused_apply(fw: FusedWeights, x: torch.Tensor, *,
                policy: Optional[dict] = None) -> torch.Tensor:
    """SLFP8 ShuffleNetV2 logits (bf16, as JAX) for NHWC float32 images.
    The executor has no policy: ``policy`` must be empty."""
    if policy:
        raise ValueError(f"policy {policy!r}: the ShuffleNetV2 executor "
                         f"takes none")
    with backend_flags():
        return _fused_apply(fw, x)


def _mm(x: torch.Tensor, c: ConvKxK) -> torch.Tensor:
    """1x1 conv of NHWC float32 bf16 values as a plain f32 matmul."""
    return _mm_f32(_flat(x), c.w).reshape(*x.shape[:-1], c.w.shape[1])


def _post_loq(y: torch.Tensor, c: ConvKxK) -> torch.Tensor:
    """JAX ``post(..., loq=True)`` up to its quantize: the folded affine as
    one FMA, the SFP<4,4> layer-output quantize, ReLU (+0.0), in f32."""
    return relu(sfp.quantize_layerout(affine_f32(y, c.scale, c.shift), 8))


def _fused_apply(fw: FusedWeights, x: torch.Tensor) -> torch.Tensor:
    rc = fw.recips
    f32, bf16 = torch.float32, torch.bfloat16

    def quant(v, i, nonneg=True):
        """K1 for conv ``i``, written as the f32 its consumer reads."""
        return act_quantize(v, rc[i], nonneg=nonneg, out_dtype=f32)

    def quant_post(y, c, i):
        """JAX ``post(..., loq=False, quant_next=i, nonneg_next=False)``:
        K3's signed quantize of the affine output."""
        _, q = k3.bn_epilogue(y, c.scale, c.shift, relu=False,
                              emit_raw=False, quant_recip=rc[i],
                              q_dtype=f32, ftz=c.ftz)
        return q

    # --- stem: 3x3/p1 conv + BN, no activation -----------------------------
    y = _conv_f32(quant(x, 0, nonneg=False), fw.stem)
    y, _ = k3.bn_epilogue(y, fw.stem.scale, fw.stem.shift, relu=False,
                          ftz=fw.stem.ftz)

    # --- 16 units: y is the bf16 unit input --------------------------------
    for u in fw.units:
        ids = u.ids
        if u.downsample:
            short_in = None
            rq = quant(y, ids[0], u.nonneg_in)
            sq = rq if u.shared else quant(y, ids[3], u.nonneg_in)
        else:
            half = y.shape[-1] // 2
            short_in = y[..., :half]
            rq = quant(y[..., half:].contiguous(), ids[0], u.nonneg_in)
        r = quant(_post_loq(_mm(rq, u.res1), u.res1), ids[1])
        r = quant_post(_conv_f32(r, u.res2), u.res2, ids[2])
        r = _post_loq(_mm(r, u.res3), u.res3).to(bf16)
        if u.downsample:
            s = quant_post(_conv_f32(sq, u.short1), u.short1, ids[4])
            s = _post_loq(_mm(s, u.short2), u.short2).to(bf16)
        else:
            s = short_in
        # concat [s, r] then the channel shuffle of 2 groups: channel j of
        # s goes to 2j, channel j of r to 2j + 1
        y = torch.stack([s, r], dim=-1).reshape(*r.shape[:-1],
                                                 2 * r.shape[-1])

    # --- conv5 + BN + layer-output quantize + ReLU, mean, classifier -------
    y = _post_loq(_mm(quant(y, CONV5_ID), fw.conv5), fw.conv5).to(bf16)
    xa = torch.mean(y.to(f32), dim=(1, 2))
    yl = _mm_f32(quant(xa, FC_ID), fw.fc_w)
    return ((yl + fw.fc_b) * fw.kaw_fc).to(bf16)
