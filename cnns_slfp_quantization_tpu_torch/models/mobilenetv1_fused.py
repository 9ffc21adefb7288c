"""Fused SLFP8 MobileNetV1 inference executor (counterpart of the JAX
``models/mobilenetv1_fused.py::fused_apply``), for the ReLU variants: CIFAR
``mobilenet`` (quantized classifier) and ImageNet ``mobilenetv1`` (float32
classifier).  The Swish / layer-output variant keeps the module path, as in
JAX.

:func:`prepare` turns a frozen (or packed) :class:`MobileNetV1` into
:class:`FusedWeights` once: BatchNorm folded with Ka*Kw into per-channel
``scale``/``shift`` (``resnet50_fused.bn_fold``), uint8 codes decoded, the
depthwise taps as ``[3, 3, C]`` float32 for K5 beside their OIHW form, the
pointwise kernels as ``[Cin, Cout]``.  :func:`fused_apply` then runs the
network on NHWC activations, each conv's epilogue emitting the next conv's
quantized input:

  stem       K1 signed quantize -> 3x3/s2 conv (cuDNN, f32 out) -> K3
             (BN, ReLU, quantize for block 0's depthwise conv)
  depthwise  stride 1 with ``dw="kernel"``: K5 (conv, BN, ReLU, quantize for
             the pointwise conv in one pass); stride 2, or ``dw="torch"``:
             grouped conv (cuDNN, f32 out) -> K3
  pointwise  f32 matmul -> K3 (BN, ReLU, quantize for the next depthwise
             conv); the last block's K3 writes raw bf16
  head       f32 mean -> ImageNet: f32 ``x @ W + b``; CIFAR: K1 -> f32
             matmul -> ``(y + b/kaw) * kaw`` in bf16

Each quantized activation is written in the type its consumer reads:
float32 holding the bf16 values for cuDNN and the matmuls (the stem's K1,
K5, every K3 whose next conv is cuDNN's), bf16 for K5; no copy widens one
in between.

``dw="torch"`` is JAX's own placement (XLA's grouped conv,
``mobilenetv1_fused.py:72``); JAX reaches its depthwise kernel only from
its A/B tool.  The convolutions and matmuls take float32 tensors that hold
bf16 values, as in :mod:`.resnet50_fused`, under the same numerics flags.

Over a model axis :func:`shard_weights` keeps each rank's out-channel
shards (every conv's weight and folded affine, K5's taps, the
classifier's columns).  Each forward gathers what the hand kernels read
whole, K5's taps and affine and every affine K3 reads; cuDNN's convs
and the plain matmuls compute their out-channel shard and gather the
channels, a grouped conv from its own channels of the input.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cnns_slfp_quantization_tpu_torch.kernels import depthwise as k5
from cnns_slfp_quantization_tpu_torch.kernels import epilogue as k3
from cnns_slfp_quantization_tpu_torch.kernels.quantize import act_quantize
from cnns_slfp_quantization_tpu_torch.models.mobilenetv1 import (
    DW_CONFIG,
    FC_ID,
    MobileNetV1,
)
from cnns_slfp_quantization_tpu_torch.models.resnet50_fused import (
    ConvKxK,
    _bf16_values,
    _conv_f32,
    _flat,
    _mm_f32,
    _s2d_stem,
    _s2d_weight,
    bn_fold,
    shard_conv,
    whole_affine,
)
from cnns_slfp_quantization_tpu_torch.ops import sfp
from cnns_slfp_quantization_tpu_torch.ops.backend import (
    backend_flags,
    full_f32_matmul,
)
from cnns_slfp_quantization_tpu_torch.ops.layers import QuantDense
from cnns_slfp_quantization_tpu_torch.parallel import comm
from cnns_slfp_quantization_tpu_torch.parallel import mesh as mesh_lib

DEFAULT_POLICY = {"dw": "kernel"}


@dataclasses.dataclass
class FusedWeights:
    stem: ConvKxK          # 3x3/s2/p1, OIHW
    stem_s2d: ConvKxK      # the same, a 2x2/s1 conv on a space-to-depth input
    dw: list               # per block: ConvKxK (grouped, OIHW) ...
    dw_taps: list          # ... and its taps [3, 3, C] float32, for K5
    dw_ftz: list           # ... and K5's route for them (k5.ftz_route)
    pw: list               # per block: ConvKxK, w [Cin, Cout] f32
    fc_w: torch.Tensor     # [1024, classes] float32 (bf16 values if quantized)
    fc_b: torch.Tensor     # bias, or float32(b) / float32(kaw) if quantized
    kaw_fc: Optional[torch.Tensor]   # float32 0-d, quantized classifier only
    quant_classifier: bool
    recips: list           # recips[i] = 1/Ka as JAX computes it
    # the mesh whose model axis the tensors are sharded over, and the group
    # the classifier's column shards are gathered over (shard_weights)
    mesh: Optional[object] = None
    fc_group: Optional[object] = None


def prepare(model: MobileNetV1, *, device="cuda") -> FusedWeights:
    """Fold and lay out a frozen SLFP8 ReLU MobileNetV1 for
    :func:`fused_apply`."""
    if model.swish_tail or model.layerout_quant:
        raise ValueError("the fused executor serves the ReLU variants; the "
                         "Swish / layer-output variant runs the module path")
    for _, layer in model.named_children():
        if hasattr(layer, "frozen_weights") and not layer.frozen_weights:
            raise ValueError("fused executor needs frozen weights "
                             "(ops.freeze.prequantize or pack)")
    ka, kw = model.scales.ka, model.scales.kw
    recips = [sfp.recip_of(a) for a in ka]

    def vec(a):
        return torch.from_numpy(a).to(device)

    def conv_kxk(i, w=None, stride=None, pad=None):
        conv = getattr(model, f"conv{i}")
        s, t = bn_fold(getattr(model, f"bn{i}"), float(ka[i]) * float(kw[i]))
        w = _bf16_values(conv.weight).float() if w is None else w
        return ConvKxK(
            w=w.to(device).contiguous(memory_format=torch.channels_last),
            scale=vec(s), shift=vec(t),
            stride=conv.stride if stride is None else stride,
            pad=conv.padding if pad is None else pad, groups=conv.groups,
            # K3's route, decided here once
            ftz=k3.ftz_route(torch.from_numpy(s), torch.from_numpy(t),
                             recips))

    stem = conv_kxk(0)
    stem_s2d = conv_kxk(0, w=_s2d_weight(stem.w.cpu()), stride=1, pad=0)
    dw, dw_taps, dw_ftz, pw = [], [], [], []
    for b in range(len(DW_CONFIG)):
        c = conv_kxk(1 + 2 * b)
        dw.append(c)
        # OIHW [C, 1, 3, 3] -> [3, 3, C]
        dw_taps.append(c.w[:, 0].permute(1, 2, 0).contiguous())
        dw_ftz.append(k5.ftz_route(dw_taps[-1], c.scale, c.shift,
                                   recips[2 + 2 * b]))
        p = conv_kxk(2 + 2 * b)
        pw.append(dataclasses.replace(p, w=p.w[:, :, 0, 0].t().contiguous()))
    quant_fc = isinstance(model.fc, QuantDense)
    fc_b = model.fc.bias.detach().cpu().numpy().astype(np.float32)
    if quant_fc:
        kaw = np.float32(float(ka[FC_ID]) * float(kw[FC_ID]))
        fc_w = _bf16_values(model.fc.weight).float()
        fc_b, kaw_fc = fc_b / kaw, torch.tensor(kaw, device=device)
    else:
        fc_w, kaw_fc = model.fc.weight.detach().float(), None
    return FusedWeights(
        stem=stem, stem_s2d=stem_s2d, dw=dw, dw_taps=dw_taps,
        dw_ftz=dw_ftz, pw=pw,
        fc_w=fc_w.t().contiguous().to(device),
        fc_b=vec(fc_b.astype(np.float32)), kaw_fc=kaw_fc,
        quant_classifier=quant_fc, recips=recips)


def fused_apply(fw: FusedWeights, x: torch.Tensor, *,
                policy: Optional[dict] = None,
                quant_classifier: Optional[bool] = None,
                s2d_stem: bool = False) -> torch.Tensor:
    """SLFP8 MobileNetV1 logits for NHWC float32 images: bf16 with the
    quantized classifier, float32 with the plain one (as JAX).
    ``quant_classifier`` defaults to the prepared model's; another value
    raises."""
    pol = dict(DEFAULT_POLICY, **(policy or {}))
    for key, val in pol.items():
        if key not in DEFAULT_POLICY or val not in ("kernel", "torch"):
            raise ValueError(f"policy {key}={val!r}: key dw, values 'kernel' "
                             f"or 'torch'")
    if quant_classifier is not None and quant_classifier != fw.quant_classifier:
        raise ValueError(f"quant_classifier={quant_classifier}, but the "
                         f"prepared model's classifier is "
                         f"{'quantized' if fw.quant_classifier else 'float'}")
    with backend_flags():
        if fw.mesh is not None:
            fw = _gathered(fw)
        return _fused_apply(fw, x, pol["dw"] == "kernel", s2d_stem)


def shard_weights(fw: FusedWeights, mesh) -> FusedWeights:
    """What a rank of ``mesh`` stores of ``fw``: every conv's out-channel
    shard over the model axis with its folded affine
    (``resnet50_fused.shard_conv``), K5's taps for the rank's channels and
    the classifier's columns; :func:`fused_apply` gathers per forward."""
    m = mesh_lib.axis_size(mesh, "model")
    dw = [shard_conv(d, mesh) for d in fw.dw]
    taps = [t if d.tp_group is None
            else mesh_lib.local_shard(t, (None, None, "model"), mesh)
            for d, t in zip(dw, fw.dw_taps)]
    fc = fw.fc_w.shape[1] % m == 0
    return dataclasses.replace(
        fw, stem=shard_conv(fw.stem, mesh),
        stem_s2d=shard_conv(fw.stem_s2d, mesh), dw=dw, dw_taps=taps,
        pw=[shard_conv(p, mesh, 1) for p in fw.pw],
        fc_w=mesh_lib.local_shard(fw.fc_w, (None, "model"), mesh)
        if fc else fw.fc_w,
        fc_b=mesh_lib.local_shard(fw.fc_b, ("model",), mesh)
        if fc else fw.fc_b,
        fc_group=mesh.get_group("model") if fc else None, mesh=mesh)


def _gathered(fw: FusedWeights) -> FusedWeights:
    """What one forward of a model-sharded ``fw`` reads whole: K5's taps
    and every affine K3 or K5 reads (the weights of cuDNN's convs and the
    matmuls stay shards)."""
    taps = [t if d.tp_group is None
            else comm.all_gather_cat(t, 2, d.tp_group).contiguous()
            for d, t in zip(fw.dw, fw.dw_taps)]
    return dataclasses.replace(
        fw, stem=whole_affine(fw.stem), stem_s2d=whole_affine(fw.stem_s2d),
        dw=[whole_affine(d) for d in fw.dw], dw_taps=taps,
        pw=[whole_affine(p) for p in fw.pw], mesh=None)


def _fused_apply(fw: FusedWeights, x: torch.Tensor, dw_kernel: bool,
                 s2d_stem: bool):
    rc = fw.recips
    f32, bf16 = torch.float32, torch.bfloat16
    last = len(DW_CONFIG) - 1

    def dw_in(b):
        """The type block b's depthwise conv reads: bf16 for K5, f32 for
        cuDNN's grouped conv."""
        return bf16 if dw_kernel and DW_CONFIG[b][2] == 1 else f32

    # --- stem: 3x3/s2/p1, signed input quantize ----------------------------
    xq = act_quantize(x, rc[0], nonneg=False, out_dtype=f32)
    if s2d_stem:
        y = _s2d_stem(xq, fw.stem_s2d, 3, pad=1)
    else:
        y = _conv_f32(xq, fw.stem)
    _, y = k3.bn_epilogue(y, fw.stem.scale, fw.stem.shift, relu=True,
                          emit_raw=False, quant_recip=rc[1], q_dtype=dw_in(0),
                          ftz=fw.stem.ftz)

    # --- 13 depthwise-separable blocks -------------------------------------
    for b in range(len(DW_CONFIG)):
        i_dw, i_pw = 1 + 2 * b, 2 + 2 * b
        d = fw.dw[b]
        # the depthwise conv's quantized output is the pointwise matmul's
        # f32 operand
        if dw_in(b) == bf16:
            y = k5.dw3x3(y, fw.dw_taps[b], scale=d.scale, shift=d.shift,
                         relu=True, quant_out_recip=rc[i_pw], out_dtype=f32,
                         ftz=fw.dw_ftz[b])
        else:
            _, y = k3.bn_epilogue(_conv_f32(y, d), d.scale, d.shift,
                                  relu=True, emit_raw=False,
                                  quant_recip=rc[i_pw], q_dtype=f32,
                                  ftz=d.ftz)
        p = fw.pw[b]
        z = _mm_f32(_flat(y), p.w)
        if p.tp_group is not None:   # the rank's out-channels: gather them
            z = comm.all_gather_cat(z, -1, p.tp_group)
        z = z.reshape(*y.shape[:-1], z.shape[-1])
        # the classifier quantizes after pooling (the reference pools raw
        # activations), so the last block writes raw bf16
        if b == last:
            y, _ = k3.bn_epilogue(z, p.scale, p.shift, relu=True, ftz=p.ftz)
        else:
            _, y = k3.bn_epilogue(z, p.scale, p.shift, relu=True,
                                  emit_raw=False, quant_recip=rc[i_dw + 2],
                                  q_dtype=dw_in(b + 1), ftz=p.ftz)

    # --- head: mean over H and W, then the classifier ----------------------
    xa = torch.mean(y.to(torch.float32), dim=(1, 2))
    if not fw.quant_classifier:
        with full_f32_matmul():
            y = xa @ fw.fc_w + fw.fc_b
    else:
        xq = act_quantize(xa, rc[FC_ID], out_dtype=f32)
        y = ((_mm_f32(xq, fw.fc_w) + fw.fc_b) * fw.kaw_fc).to(bf16)
    if fw.fc_group is not None:      # the rank's classes: gather them
        y = comm.all_gather_cat(y, -1, fw.fc_group)
    return y
