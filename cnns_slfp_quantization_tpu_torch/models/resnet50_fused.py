"""Fused SLFP8 ResNet-50 inference executor (counterpart of the JAX
``models/resnet50_fused.py::fused_apply``).

:func:`prepare` turns a frozen (or packed) :class:`ResNet50` into
:class:`FusedWeights` once: BatchNorm folded with Ka*Kw into a per-channel
``scale``/``shift`` (numpy float32, the JAX ``_bn_fold`` expression), the
1x1 kernels as [K, N] bf16 values or uint8 codes for K2, the spatial
kernels as float32 tensors holding the bf16 values, and the stem rewritten
as a 4x4 convolution over a 2x2 space-to-depth input.  :func:`fused_apply`
then runs the network on NHWC activations:

  stem     K1 signed quantize -> s2d 4x4 conv (cuDNN, f32 out) -> K3 BN+ReLU
           -> max pool -> K1 quantize shared by conv1 and the downsample
  block    conv1 1x1: K2 (quantize prologue when its input is raw, BN, ReLU,
           quantize for conv2, written as f32); conv2 3x3: cuDNN f32 out ->
           K3 (q only); conv3 1x1: K2 (BN, +identity, ReLU; at a stage end
           also the next stage's quantize); downsample: cuDNN f32 out -> K3
           (raw, no ReLU)
  head     f32 mean -> K1 (f32 out) -> f32 matmul -> (y + b/kaw) * kaw

``policy`` chooses per 1x1 site between the hand kernel K2 (``"kernel"``,
JAX ``"pallas"``) and a plain f32 matmul followed by K3 (``"torch"``, JAX
``"xla"``).  With ``conv3="torch"`` the mid-stage block outputs use K3's
dual form (raw + quantized in one pass), bit-equal to JAX's default
placement, the raw output with the quantize left to the consumer
(``tests/test_torch_port_ptq.py::test_blockin_levers_match_consumer``
holds it; the private ``_diag_blockin_fuse`` selects either).
``policy["chain"]``, a set of stage indices (JAX's ``chain``), runs every
stride-1 bottleneck of those stages (blocks 1 and on) as one launch of
K6, whose conv1 and conv2 outputs never leave the card's shared memory;
on the card K6 takes stages 1-3 and raises for stage 0.  The port's
default is ``{2, 3}``, where JAX's is empty: each of the
two stages served more images/s through K6 than without it at batch 64
and 256, timed in turns on the H100 (``utils/bench_chain.py --serve``,
PERF.md); ``frozenset()`` is JAX's placement.  Whether a kernel or its
plain version runs is decided by the tensors' device alone.

The spatial convolutions and the plain matmuls take float32 tensors that
hold bf16 values: every product is exact and the sums are float32, which is
JAX's ``preferred_element_type=float32`` (a bf16 ``F.conv2d`` would round
its output to bf16).  :func:`backend_flags` says why TF32 is exact here;
the executor sets those flags around its own calls only.  Each kernel
writes its output in the type its consumer reads: float32 (the bf16
values widened exactly) for cuDNN and the plain matmuls, bf16 for K2 and
K6, so no copy widens it in between.  A bf16 tensor reaches cuDNN only
where the same quantized tensor also feeds a kernel that reads bf16 alone:
the stage inputs, which K2's conv1 reads too (or K6's output, which it
writes in bf16 only).  The K3 epilogues take their FTZ route when
:func:`prepare` finds no subnormal scale, shift or reciprocal
(``ConvKxK.ftz``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cnns_slfp_quantization_tpu_torch.kernels import chain as k6
from cnns_slfp_quantization_tpu_torch.kernels import epilogue as k3
from cnns_slfp_quantization_tpu_torch.kernels import qmm as k2
from cnns_slfp_quantization_tpu_torch.kernels import quantize as k1
from cnns_slfp_quantization_tpu_torch.models.resnet50 import (
    STAGES,
    ResNet50,
    block_names,
)
from cnns_slfp_quantization_tpu_torch.ops import sfp
from cnns_slfp_quantization_tpu_torch.ops.backend import backend_flags

DEFAULT_POLICY = {"conv1": "kernel", "conv3": "kernel",
                  "chain": frozenset({2, 3})}


def bn_fold(bn: torch.nn.BatchNorm2d, kaw: float):
    """Folded inference BN with Ka*Kw merged (JAX ``_bn_fold``), float32."""
    g = bn.weight.detach().cpu().numpy().astype(np.float32)
    b = bn.bias.detach().cpu().numpy().astype(np.float32)
    mean = bn.running_mean.detach().cpu().numpy().astype(np.float32)
    var = bn.running_var.detach().cpu().numpy().astype(np.float32)
    scale = g / np.sqrt(var + np.float32(1e-5))
    shift = b - mean * scale
    return ((scale * np.float32(kaw)).astype(np.float32),
            shift.astype(np.float32))


@dataclasses.dataclass
class Conv1x1:
    w: torch.Tensor        # [K, N] view of [N, K] storage (bf16 values or
                           # uint8 codes), as K2 reads it fastest
    scale: torch.Tensor    # [N] f32, BN fold with Ka*Kw
    shift: torch.Tensor    # [N] f32
    ftz: Optional[bool] = None   # K3's route after a plain matmul


@dataclasses.dataclass
class ConvKxK:
    w: torch.Tensor        # OIHW float32 holding bf16 values, channels last
    scale: torch.Tensor
    shift: torch.Tensor
    stride: int
    pad: int
    groups: int = 1
    # K3's route for this conv's epilogue (k3.ftz_route), decided when the
    # weights are laid out; None decides it at each call (a device sync)
    ftz: Optional[bool] = None


@dataclasses.dataclass
class FusedWeights:
    stem: ConvKxK          # 4x4 space-to-depth form (stride 1, no padding)
    stem_k: int            # original kernel size (7)
    blocks: dict           # prefix -> {"conv1", "conv2", "conv3", "down"}
    fc_w: torch.Tensor     # [2048, classes] float32 holding bf16 values
    fc_b_over_kaw: torch.Tensor   # float32(b) / float32(kaw53)
    kaw53: torch.Tensor           # float32 0-d
    recips: list           # recips[sid] = 1/Ka as JAX computes it
    # prefix -> K6's weights (w1 [C, M], w2 [3, 3, M, M], w3 [M, C], bf16
    # values) and route, laid out at the first forward that runs the block
    # on K6
    chain: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ChainWeights:
    w1: torch.Tensor
    w2: torch.Tensor
    w3: torch.Tensor
    ftz: bool     # K6's route for the block's affines and reciprocals


def _chain_weights(fw: FusedWeights, pre: str, recips) -> ChainWeights:
    """Block ``pre``'s weights in K6's layout, built once: uint8 codes are
    decoded (the values JAX's ``_wv`` decodes in-graph), the conv2 kernel
    goes from cuDNN's OIHW to HWIO; the route is decided for its affines
    and ``recips`` (recip2, recip3, recip_next)."""
    cw = fw.chain.get(pre)
    if cw is None:
        blk = fw.blocks[pre]
        affines = [getattr(blk[c], f) for c in ("conv1", "conv2", "conv3")
                   for f in ("scale", "shift")]
        cw = ChainWeights(
            w1=_bf16_values(blk["conv1"].w).contiguous(),
            w2=blk["conv2"].w.permute(2, 3, 1, 0).to(
                torch.bfloat16).contiguous(),
            w3=_bf16_values(blk["conv3"].w).contiguous(),
            ftz=k6.ftz_route(affines, recips))
        fw.chain[pre] = cw
    return cw


def _bf16_values(w: torch.Tensor) -> torch.Tensor:
    """Frozen weights as bf16 values (decoding uint8 codes)."""
    w = w.detach()
    if w.dtype == torch.uint8:
        return sfp.slfp34_decode_bits(w).to(torch.bfloat16)
    return w.to(torch.bfloat16)


def _s2d_weight(w_oihw: torch.Tensor) -> torch.Tensor:
    """kxk stem kernel -> (k'/2)x(k'/2) kernel over 4x the channels
    (JAX ``_space_to_depth_stem``), OIHW."""
    f, c, k, _ = w_oihw.shape
    k2 = -(-k // 2) * 2
    kb = k2 // 2
    w = F.pad(w_oihw.permute(2, 3, 1, 0), (0, 0, 0, 0, 0, k2 - k, 0, k2 - k))
    wb = w.reshape(kb, 2, kb, 2, c, f).permute(0, 2, 1, 3, 4, 5)
    return wb.reshape(kb, kb, 4 * c, f).permute(3, 2, 0, 1).contiguous()


def prepare(model: ResNet50, *, device="cuda") -> FusedWeights:
    """Fold and lay out a frozen SLFP8 ResNet-50 for :func:`fused_apply`."""
    if model.act != "relu" or model.layerout_quant:
        raise ValueError("the fused executor serves the ReLU ResNet-50; the "
                         "STL / Swish variants run the module path")
    scales = model.scales
    ka, kw = scales.ka, scales.kw
    # conv1 and the downsample conv share one quantized input at every stage
    # boundary, which needs their calibrated Ka to be equal
    for _, _, _, base in STAGES:
        if float(ka[base]) != float(ka[base + 1]):
            raise ValueError(
                f"fused executor requires ka[{base}] == ka[{base + 1}] "
                f"(downsample shares conv1's quantized input); got "
                f"{float(ka[base])} != {float(ka[base + 1])}")
    for _, layer in model.named_children():
        if hasattr(layer, "frozen_weights") and not layer.frozen_weights:
            raise ValueError("fused executor needs frozen weights "
                             "(ops.freeze.prequantize or pack)")

    def kaw(sid):
        return float(ka[sid]) * float(kw[sid])

    def vec(a):
        return torch.from_numpy(a).to(device)

    recips = [sfp.recip_of(a) for a in ka]

    def ftz(s, t):
        """K3's route for an epilogue with this affine, decided on the
        host arrays (every reciprocal a K3 may quantize by included)."""
        return k3.ftz_route(torch.from_numpy(s), torch.from_numpy(t), recips)

    def conv1x1(conv, bn, sid):
        s, t = bn_fold(bn, kaw(sid))
        w = conv.weight.detach()                      # [N, K, 1, 1]
        if w.dtype != torch.uint8:                    # K2 decodes codes
            w = _bf16_values(w)
        return Conv1x1(w=w[:, :, 0, 0].contiguous().to(device).t(),
                       scale=vec(s), shift=vec(t), ftz=ftz(s, t))

    def conv_kxk(conv, bn, sid, w=None, stride=None, pad=None):
        s, t = bn_fold(bn, kaw(sid))
        w = _bf16_values(conv.weight).float() if w is None else w
        return ConvKxK(
            w=w.to(device).contiguous(memory_format=torch.channels_last),
            scale=vec(s), shift=vec(t),
            stride=conv.stride if stride is None else stride,
            pad=conv.padding if pad is None else pad, ftz=ftz(s, t))

    stem = conv_kxk(model.conv1, model.bn1, 0,
                    w=_s2d_weight(_bf16_values(model.conv1.weight).float()),
                    stride=1, pad=0)
    blocks = {}
    for _, b, pre, sid, *_ in block_names():
        g = lambda n: getattr(model, f"{pre}_{n}")  # noqa: E731
        blk = {"conv1": conv1x1(g("conv1"), g("bn1"), sid + 1),
               "conv2": conv_kxk(g("conv2"), g("bn2"), sid + 2),
               "conv3": conv1x1(g("conv3"), g("bn3"), sid + 3)}
        if b == 0:
            blk["down"] = conv_kxk(g("down_conv"), g("down_bn"), sid)
        blocks[pre] = blk
    k53 = np.float32(kaw(53))
    fc_b = model.fc.bias.detach().cpu().numpy().astype(np.float32)
    return FusedWeights(
        stem=stem, stem_k=model.conv1.weight.shape[-1], blocks=blocks,
        fc_w=_bf16_values(model.fc.weight).float().t().contiguous().to(device),
        fc_b_over_kaw=vec((fc_b / k53).astype(np.float32)),
        kaw53=torch.tensor(k53, device=device), recips=recips)


def _conv_f32(xq: torch.Tensor, c: ConvKxK) -> torch.Tensor:
    """NHWC bf16 values (as float32, or bf16 widened here) -> NHWC float32
    conv output (cuDNN, channels last)."""
    x = xq.to(torch.float32).permute(0, 3, 1, 2)
    y = F.conv2d(x, c.w, stride=c.stride, padding=c.pad, groups=c.groups)
    return y.permute(0, 2, 3, 1).contiguous()


def _mm_f32(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[M, K] bf16 values (as float32, or bf16 widened here) @ [K, N]
    float32: a plain matmul with float32 sums."""
    return xq.to(torch.float32) @ w


def _s2d_stem(xq: torch.Tensor, c: ConvKxK, k: int, pad: int = 3):
    """kxk/s2/p3 stem as a 4x4/s1 conv on a 2x2 space-to-depth input
    (JAX ``_space_to_depth_stem``; exact: the same sum over zero taps)."""
    n, h, w, ch = xq.shape
    k2 = -(-k // 2) * 2
    oh, ow = (h + 2 * pad - k) // 2 + 1, (w + 2 * pad - k) // 2 + 1

    def trailing(extent, out):
        t = max(2 * out - 2 + k2 - pad - extent, 0)
        return t + ((pad + extent + t) & 1)

    th, tw = trailing(h, oh), trailing(w, ow)
    xp = F.pad(xq, (0, 0, pad, tw, pad, th))
    hp, wp = h + pad + th, w + pad + tw
    s2d = xp.reshape(n, hp // 2, 2, wp // 2, 2, ch).permute(
        0, 1, 3, 2, 4, 5).reshape(n, hp // 2, wp // 2, 4 * ch)
    return _conv_f32(s2d, c)[:, :oh, :ow, :].contiguous()


def _flat(x):
    return x.reshape(-1, x.shape[-1])


BLOCKIN_FUSE = ("consumer", "producer", "pallas_dual", "packed")


def fused_apply(fw: FusedWeights, x: torch.Tensor, *,
                policy: Optional[dict] = None,
                _diag_blockin_fuse: str = "pallas_dual") -> torch.Tensor:
    """SLFP8 ResNet-50 logits (bf16, as JAX) for NHWC float32 images.

    ``_diag_blockin_fuse`` is a measurement lever (JAX
    ``resnet50_fused.py:338-375``): where conv3 runs as a plain matmul
    (``conv3="torch"``), how a block output that is not the last of its
    stage reaches the next block.  ``"pallas_dual"`` (the default): K3's
    dual form writes raw and quantized in one pass; ``"consumer"``: K3
    writes raw and the next block quantizes it (K1, or K2's prologue);
    ``"producer"``: two K3 passes over the conv output, raw and quantized;
    ``"packed"``: raw, then uint8 codes of it (``slfp34_pack_bits``)
    decoded back, which sends the pseudo-zero code to 0.0 and so differs
    from the others.
    """
    if _diag_blockin_fuse not in BLOCKIN_FUSE:
        raise ValueError(f"_diag_blockin_fuse={_diag_blockin_fuse!r}: one "
                         f"of {BLOCKIN_FUSE}")
    pol = dict(DEFAULT_POLICY, **(policy or {}))
    for key, val in pol.items():
        if key == "chain":
            try:
                pol[key] = frozenset(val)
            except TypeError:
                pol[key] = None
            if pol[key] is None or not pol[key] <= {0, 1, 2, 3}:
                raise ValueError(f"policy chain={val!r}: a set of stage "
                                 f"indices in 0..3")
        elif key not in DEFAULT_POLICY or val not in ("kernel", "torch"):
            raise ValueError(f"policy {key}={val!r}: keys conv1/conv3 with "
                             f"values 'kernel' or 'torch', and chain")
    with backend_flags():
        return _fused_apply(fw, x, pol, _diag_blockin_fuse)


def _fused_apply(fw: FusedWeights, x: torch.Tensor, pol: dict,
                 blockin: str):
    rc = fw.recips
    f32, bf16 = torch.float32, torch.bfloat16
    # conv1 as a plain matmul reads f32; K2 and K6 read bf16
    c1_dt = f32 if pol["conv1"] == "torch" else bf16

    def mm(xf, conv: Conv1x1, **kw):
        """1x1 conv as K2 on [M, K]."""
        lead = xf.shape[:-1]
        y = k2.qmm_fused(_flat(xf), conv.w, conv.scale, conv.shift, **kw)
        return y.reshape(*lead, y.shape[-1])

    def mm_f32(xq, conv: Conv1x1):
        """1x1 conv as a plain f32 matmul of bf16 values."""
        lead = xq.shape[:-1]
        y = _mm_f32(_flat(xq), _bf16_values(conv.w).float())
        return y.reshape(*lead, y.shape[-1])

    # --- stem --------------------------------------------------------------
    # K1 writes the f32 its conv reads: faster, if by 0.1%, in every turn on
    # the H100 than bf16 widened after the space-to-depth layout copies,
    # which then move half the bytes (utils/bench_epilogue.py --stem)
    xq = k2.quantize_act_pass(x, rc[0], nonneg=False, out_dtype=f32)
    y = _s2d_stem(xq, fw.stem, fw.stem_k)
    y, _ = k3.bn_epilogue(y, fw.stem.scale, fw.stem.shift, relu=True,
                          ftz=fw.stem.ftz)
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(
        0, 2, 3, 1).contiguous()

    # block stream: raw bf16 (residual) and, when a producer emitted it,
    # the same tensor quantized for the next conv1
    xr_raw, xr_q = y, None
    for s_idx, b, pre, sid, _, _, _ in block_names():
        blk = fw.blocks[pre]
        # at a stage end only the next stage's quantized input is needed
        last = b == STAGES[s_idx][1] - 1
        if last:
            qn = STAGES[s_idx + 1][3] + 1 if s_idx + 1 < len(STAGES) else None
        else:
            qn = sid + 4
        if b == 0:
            # the stage input feeds the downsample conv (cuDNN) and conv1:
            # f32 only where conv1 reads f32 too
            xq_sh = xr_q if xr_q is not None else k2.quantize_act_pass(
                xr_raw, rc[sid + 1], out_dtype=c1_dt)
            d = blk["down"]
            identity, _ = k3.bn_epilogue(_conv_f32(xq_sh, d), d.scale,
                                         d.shift, relu=False, ftz=d.ftz)
            c1_in, c1_recip = xq_sh, None
        else:
            identity = xr_raw
            if xr_q is not None:
                c1_in, c1_recip = xr_q, None
            else:
                c1_in, c1_recip = xr_raw, rc[sid + 1]

        c1, c2, c3 = blk["conv1"], blk["conv2"], blk["conv3"]
        if b > 0 and s_idx in pol["chain"]:
            # the whole bottleneck as one K6 launch (JAX :262-296)
            xq_in = (c1_in if c1_recip is None
                     else k2.quantize_act_pass(xr_raw, c1_recip))
            recips = (rc[sid + 2], rc[sid + 3],
                      rc[qn] if qn is not None else 1.0)
            cw = _chain_weights(fw, pre, recips)
            raw, q = k6.bottleneck_chain(
                xq_in, identity, cw.w1, cw.w2, cw.w3, c1.scale, c1.shift,
                c2.scale, c2.shift, c3.scale, c3.shift, recip2=recips[0],
                recip3=recips[1], recip_next=recips[2],
                emit_raw=not (last and qn is not None),
                emit_q=qn is not None, ftz=cw.ftz)
            if last:
                xr_raw, xr_q = (q if qn is not None else raw), q
            else:
                xr_raw, xr_q = raw, q
            continue

        # conv1 1x1: (quantize) -> mm -> BN+ReLU -> quantize for conv2,
        # written as the f32 operand cuDNN's conv2 reads
        if pol["conv1"] == "kernel":
            y1q = mm(c1_in, c1, relu=True, quant_in_recip=c1_recip,
                     quant_out_recip=rc[sid + 2], out_dtype=f32)
        else:
            c1q = (c1_in if c1_recip is None
                   else k2.quantize_act_pass(c1_in, c1_recip, out_dtype=f32))
            _, y1q = k3.bn_epilogue(mm_f32(c1q, c1), c1.scale, c1.shift,
                                    relu=True, emit_raw=False,
                                    quant_recip=rc[sid + 2], q_dtype=f32,
                                    ftz=c1.ftz)

        # conv2 3x3 (stride): cuDNN, then BN+ReLU+quantize from f32
        _, y2q = k3.bn_epilogue(
            _conv_f32(y1q, c2), c2.scale, c2.shift, relu=True,
            emit_raw=False, quant_recip=rc[sid + 3],
            q_dtype=f32 if pol["conv3"] == "torch" else bf16, ftz=c2.ftz)

        # conv3 1x1: mm -> BN -> +identity -> ReLU -> block output; a
        # quantized output feeds the next conv1 (and at a stage end the
        # downsample conv), or K6 where the next block is on the chain
        if pol["conv3"] == "kernel":
            end_q = last and qn is not None
            xr_raw = mm(y2q, c3, relu=True, residual=_flat(identity),
                        quant_out_recip=rc[qn] if end_q else None,
                        out_dtype=c1_dt if end_q else bf16)
            xr_q = xr_raw if end_q else None
        else:
            y3 = mm_f32(y2q, c3)
            if last:
                raw, q = k3.bn_epilogue(
                    y3, c3.scale, c3.shift, identity=identity, relu=True,
                    emit_raw=qn is None,
                    quant_recip=rc[qn] if qn is not None else None,
                    q_dtype=c1_dt, ftz=c3.ftz)
                xr_raw = q if qn is not None else raw
                xr_q = q
            else:
                q_dt = bf16 if s_idx in pol["chain"] else c1_dt
                post = dict(identity=identity, relu=True, ftz=c3.ftz)
                if blockin == "pallas_dual":
                    xr_raw, xr_q = k3.bn_epilogue(  # the dual form
                        y3, c3.scale, c3.shift, quant_recip=rc[qn],
                        q_dtype=q_dt, **post)
                else:
                    xr_raw, _ = k3.bn_epilogue(y3, c3.scale, c3.shift,
                                               **post)
                    xr_q = None
                if blockin == "producer":
                    _, xr_q = k3.bn_epilogue(
                        y3, c3.scale, c3.shift, emit_raw=False,
                        quant_recip=rc[qn], q_dtype=q_dt, **post)
                elif blockin == "packed":
                    codes = k1.slfp34_pack_bits(xr_raw.to(f32) * torch.tensor(
                        np.float32(rc[qn]), device=xr_raw.device))
                    # the codebook's values as bf16 (JAX ``_wv(codes)``)
                    xr_q = sfp.slfp34_decode_bits(codes).to(bf16).to(q_dt)

    # --- head: global average pool + quantized FC --------------------------
    xa = torch.mean(xr_raw.to(torch.float32), dim=(1, 2))
    xq = k2.quantize_act_pass(xa, rc[53], out_dtype=f32)
    y = _mm_f32(xq, fw.fc_w)
    y = (y + fw.fc_b_over_kaw) * fw.kaw53
    return y.to(torch.bfloat16)
