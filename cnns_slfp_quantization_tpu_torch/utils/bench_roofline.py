"""Per-op roofline of the fused SLFP8 ResNet-50 executor on the card
(counterpart of JAX's ``tools/bench_roofline.py``), and the port's one home
for the H100's peak rates and the bound formula.

    python3 -m cnns_slfp_quantization_tpu_torch.utils.bench_roofline \\
        [--batch 256 64] [--policy jax default] [--size 224] [--runs 3] \\
        [--device cuda|cpu]

For each batch and each placement it runs every op class of one forward,
row by row, on the port's own route for that op, and prints one JSON line
per row and a summary:

- ``jax``, ``policy={"chain": frozenset()}``: JAX's rows (``stem_row``,
  ``maxpool_row``, ``head_row``, the 27 conv + epilogue ``specs`` and the
  four ``blockin q`` rows, names, shapes and per-forward counts as JAX
  lists them, :func:`jax_specs`, :func:`jax_quantize_rows`), on the port's
  routes: K2 with its epilogue for conv1 and conv3; cuDNN on float32
  tensors holding bf16 values, then K3, for the 3x3 convs, the downsample
  convs (after a copy that widens their bf16 input) and the space-to-depth
  stem (after K1 and two layout copies); the head as a widening copy, a
  mean, K1, a TF32 matmul and the rescale; the block-input quantize runs in
  the prologue of the next block's K2 conv1 (no launch of its own, a row
  of zeros).  One row JAX's list lacks: stage 0's input quantize (K1).
- ``default`` (``resnet50_fused.DEFAULT_POLICY``): the same, but the
  stride-1 bottlenecks of stages 2 and 3 (JAX's s3 and s4, blocks 1 and
  on) run as K6 rows, each stage's block 1 reading its input from a K1 row.

Each row's bytes are counted from the tensors each launch reads and
writes (``nbytes`` of its inputs and outputs, each once), its operations
as 2*M*N*K for each product (K6: its three), ``K1_OPS`` / ``K3_OPS`` per
element for the elementwise kernels; its bound is the sum over its
launches of :func:`bound_ms`.  Its time is the device time of its calls
captured in one CUDA graph and replayed between CUDA events
(``profiling.graph_ms``), the calls rotating over as many copies of the
row's tensors as exceed the card's L2 twice, so that no call reads what
the one before left in L2; its time by kernel class and its hand
kernels' launches come from torch.profiler's records
(``profiling.kernel_profile``), whose durations a long-lived process can
misread (a row whose trace fails is listed as ``by_class_not_measured``).
A row above 100% of its bound is a fault in the count or the
timing.  The summary has JAX's keys (``total_ms``,
``total_roofline_ms``, ``roofline_frac``, ``implied_img_per_sec``), the
bound and time by kernel class, the executor's own launches counted over
one forward (which must equal the rows' per class) and the engine's
per-batch time (``InferenceEngine.throughput()``, its CUDA graph).
``--device cpu`` runs the plain versions for the counts and times
nothing.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import sys
from typing import Callable, Optional

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the full 700 W: an
# H100 set to a lower power.limit runs slower under load, so every share
# of these stands beside the card's name and limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12            # tensor cores: wgmma (K2, K4, K6)
TF32_FLOPS = 495e12            # tensor cores: cuDNN / cuBLAS under TF32
F32_OPS = 67e12                # float32 outside the tensor cores
L2_BYTES = 50e6
# integer/float operations per element of the elementwise kernels, counted
# from csrc/slfp.cuh (quantize ~25, epilogue affine+residual+ReLU+quantize
# ~35; K5's stencil 9 multiply-adds; K7's update, four fused multiply-adds
# and two weight quantizes, ~60); all far below their bytes bounds
K1_OPS, K3_OPS, DW_OPS, K7_OPS = 25, 35, 18, 60


def bound_ms(nbytes, ops, peak):
    """(the least milliseconds the card could take for ``nbytes`` moved
    and ``ops`` operations at ``peak`` per second, what bounds it:
    ``"bytes"`` or ``"operations"``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------------ rows

def jax_specs(size: int = 224) -> list:
    """JAX's 27 conv + epilogue rows, ``(name, hw_in, cin, cout, k, stride,
    residual, quant, count)``, at ``size`` (JAX's literal at 224)."""
    r = [size // 4, size // 8, size // 16, size // 32]
    return [
        (f"s1.b0.conv1 1x1 64->64 @{r[0]}", r[0], 64, 64, 1, 1, False, True,
         1),
        (f"s1.conv1 1x1 256->64 @{r[0]}", r[0], 256, 64, 1, 1, False, True,
         2),
        (f"s1.conv2 3x3 64->64 @{r[0]}", r[0], 64, 64, 3, 1, False, True, 3),
        (f"s1.conv3+res 1x1 64->256 @{r[0]}", r[0], 64, 256, 1, 1, True,
         False, 2),
        ("s1.conv3+res+q (stage bnd)", r[0], 64, 256, 1, 1, True, True, 1),
        (f"s1.down 1x1 64->256 @{r[0]}", r[0], 64, 256, 1, 1, False, False,
         1),
        (f"s2.b0.conv1 1x1 256->128 @{r[0]}", r[0], 256, 128, 1, 1, False,
         True, 1),
        (f"s2.b0.conv2 3x3/2 128 @{r[0]}->{r[1]}", r[0], 128, 128, 3, 2,
         False, True, 1),
        ("s2.b0.down 1x1/2 256->512", r[0], 256, 512, 1, 2, False, False, 1),
        (f"s2.conv1 1x1 512->128 @{r[1]}", r[1], 512, 128, 1, 1, False, True,
         3),
        (f"s2.conv2 3x3 128 @{r[1]}", r[1], 128, 128, 3, 1, False, True, 3),
        (f"s2.conv3+res 1x1 128->512 @{r[1]}", r[1], 128, 512, 1, 1, True,
         False, 3),
        ("s2.conv3+res+q (stage bnd)", r[1], 128, 512, 1, 1, True, True, 1),
        (f"s3.b0.conv1 1x1 512->256 @{r[1]}", r[1], 512, 256, 1, 1, False,
         True, 1),
        (f"s3.b0.conv2 3x3/2 256 @{r[1]}->{r[2]}", r[1], 256, 256, 3, 2,
         False, True, 1),
        ("s3.b0.down 1x1/2 512->1024", r[1], 512, 1024, 1, 2, False, False,
         1),
        (f"s3.conv1 1x1 1024->256 @{r[2]}", r[2], 1024, 256, 1, 1, False,
         True, 5),
        (f"s3.conv2 3x3 256 @{r[2]}", r[2], 256, 256, 3, 1, False, True, 5),
        (f"s3.conv3+res 1x1 256->1024 @{r[2]}", r[2], 256, 1024, 1, 1, True,
         False, 5),
        ("s3.conv3+res+q (stage bnd)", r[2], 256, 1024, 1, 1, True, True, 1),
        (f"s4.b0.conv1 1x1 1024->512 @{r[2]}", r[2], 1024, 512, 1, 1, False,
         True, 1),
        (f"s4.b0.conv2 3x3/2 512 @{r[2]}->{r[3]}", r[2], 512, 512, 3, 2,
         False, True, 1),
        ("s4.b0.down 1x1/2 1024->2048", r[2], 1024, 2048, 1, 2, False, False,
         1),
        (f"s4.conv1 1x1 2048->512 @{r[3]}", r[3], 2048, 512, 1, 1, False,
         True, 2),
        (f"s4.conv2 3x3 512 @{r[3]}", r[3], 512, 512, 3, 1, False, True, 2),
        (f"s4.conv3+res 1x1 512->2048 @{r[3]}", r[3], 512, 2048, 1, 1, True,
         False, 2),
        ("s4.conv3+res (last, no q)", r[3], 512, 2048, 1, 1, True, False, 1),
    ]


def jax_quantize_rows(size: int = 224) -> list:
    """JAX's standalone block-input quantize rows, ``(name, hw, c,
    count)``: one per block that is not the last of its stage."""
    r = [size // 4, size // 8, size // 16, size // 32]
    return [(f"blockin q @{r[0]}x256", r[0], 256, 2),
            (f"blockin q @{r[1]}x512", r[1], 512, 3),
            (f"blockin q @{r[2]}x1024", r[2], 1024, 5),
            (f"blockin q @{r[3]}x2048", r[3], 2048, 2)]


@dataclasses.dataclass
class Op:
    """One launch of a row, as counted on its first call."""
    cls: str             # K1-K6, "cuDNN conv", "cuBLAS" or "elementwise"
    nbytes: int          # its inputs read once and outputs written once
    ops: int
    peak: float          # operations per second of its unit

    @property
    def bound(self):
        return bound_ms(self.nbytes, self.ops, self.peak)


class Counter:
    """Runs a row's launches; with ``ops`` set (the first call) it records
    each launch's :class:`Op` from the tensors it reads and returns."""

    def __init__(self):
        self.ops: Optional[list] = None

    def __call__(self, cls: str, peak: float, ops: int, reads, fn):
        out = fn()
        if self.ops is not None:
            outs = out if isinstance(out, tuple) else (out,)
            nbytes = sum(t.nbytes for t in (*reads, *outs)
                         if hasattr(t, "nbytes"))
            self.ops.append(Op(cls, nbytes, ops, peak))
        return out


@dataclasses.dataclass
class Row:
    """One op class of the forward: ``count`` of its calls a forward;
    ``tensors()`` makes a fresh set of the tensors a call reads and
    ``body(counter, tensors)`` runs the call's launches.  ``jax``: the row
    is one of JAX's (same name, shape and count)."""
    name: str
    count: int
    route: str
    tensors: Callable[[], dict]
    body: Callable[[Counter, dict], object]
    jax: bool = True


def _nhwc(dev, gen, b, hw, c, dtype, scale=2.0, nonneg=True):
    import torch

    x = torch.randn(b, hw, hw, c, device=dev, generator=gen) * scale
    return (x.abs() if nonneg else x).to(dtype)


def rows(fw, rc, policy: str, batch: int, size: int, dev, gen) -> list:
    """The rows of one forward of the executor ``fw`` (``FusedWeights``,
    reciprocals ``rc``) at ``batch`` x ``size`` under ``policy``
    (``"jax"`` or ``"default"``), as ``resnet50_fused._fused_apply`` runs
    them; weights and affines are ``fw``'s, activations random from
    ``gen``."""
    import torch
    import torch.nn.functional as F

    from cnns_slfp_quantization_tpu_torch.kernels import chain as k6
    from cnns_slfp_quantization_tpu_torch.kernels import epilogue as k3
    from cnns_slfp_quantization_tpu_torch.kernels import qmm as k2
    from cnns_slfp_quantization_tpu_torch.models import resnet50_fused as rf
    from cnns_slfp_quantization_tpu_torch.models.resnet50 import STAGES

    f32, bf16 = torch.float32, torch.bfloat16
    B = batch
    chain = (frozenset() if policy == "jax"
             else rf.DEFAULT_POLICY["chain"])

    def clone(c):
        return dataclasses.replace(c, w=c.w.clone(), scale=c.scale.clone(),
                                   shift=c.shift.clone())

    def k2_op(acc, x, c, m, **kw):
        k, n = c.w.shape
        return acc("K2", BF16_FLOPS, 2 * m * k * n,
                   [x, c.w, c.scale, c.shift, kw.get("residual")],
                   lambda: k2.qmm_fused(x, c.w, c.scale, c.shift, **kw))

    def k3_op(acc, y, c, **kw):
        return acc("K3", F32_OPS, y.numel() * K3_OPS,
                   [y, c.scale, c.shift, kw.get("identity")],
                   lambda: k3.bn_epilogue(y, c.scale, c.shift, ftz=c.ftz,
                                          **kw))

    def k1_op(acc, x, recip, **kw):
        return acc("K1", F32_OPS, x.numel() * K1_OPS, [x],
                   lambda: k2.quantize_act_pass(x, recip, **kw))

    def conv_op(acc, x, c):
        """cuDNN on the f32 operand: 2 * outputs * (cin / groups) * kh * kw
        operations under TF32."""
        o, ci, kh, kw_ = c.w.shape
        n, h, w, _ = x.shape
        st, pd = (v if isinstance(v, int) else v[0]
                  for v in (c.stride, c.pad))
        outs = n * ((h + 2 * pd - kh) // st + 1) * \
            ((w + 2 * pd - kw_) // st + 1) * o
        return acc("cuDNN conv", TF32_FLOPS, 2 * outs * ci * kh * kw_,
                   [x, c.w], lambda: rf._conv_f32(x, c))

    def widen(acc, x):
        return acc("elementwise", F32_OPS, 0, [x], lambda: x.to(f32))

    def block(s, b):
        """(prefix, scale id base) of block ``b`` of stage ``s``."""
        _, _, _, base = STAGES[s]
        return f"layer{s + 1}_{b}", base + 3 * b

    out = []

    # --- stem, maxpool, stage 0's input, head ------------------------------
    def stem_t():
        return {"x": torch.randn(B, size, size, 3, device=dev,
                                 generator=gen),
                "c": clone(fw.stem)}

    def stem_body(acc, t):
        c = t["c"]
        xq = k1_op(acc, t["x"], rc[0], nonneg=False, out_dtype=f32)
        xp, oh, ow = acc("elementwise", F32_OPS, 0, [xq],
                         lambda: rf._s2d_pad(xq, fw.stem_k))
        s2d = acc("elementwise", F32_OPS, 0, [xp],
                  lambda: rf._s2d_layout(xp))
        y = conv_op(acc, s2d, c)
        return k3_op(acc, y, c, relu=True)[0]

    out.append(Row("stem(q+s2d conv7x7/2+bn)", 1,
                   "K1, pad + space-to-depth copies, cuDNN 4x4, K3",
                   stem_t, stem_body))

    r0 = (size + 1) // 2

    def pool_t():
        return {"y": _nhwc(dev, gen, B, r0, 64, bf16)}

    def pool_body(acc, t):
        y = t["y"]
        n_out = B * (r0 // 2) ** 2 * 64
        return acc("elementwise", F32_OPS, 9 * n_out, [y],
                   lambda: F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1)
                   .permute(0, 2, 3, 1).contiguous())

    out.append(Row("maxpool3x3/2", 1, "torch max_pool2d", pool_t, pool_body))

    res = [size // 4, size // 8, size // 16, size // 32]

    def head_t():
        return {"x": _nhwc(dev, gen, B, res[3], 2048, bf16),
                "w": fw.fc_w.clone(), "b": fw.fc_b_over_kaw.clone(),
                "k": fw.kaw53.clone()}

    def head_body(acc, t):
        xf = widen(acc, t["x"])
        n = xf.numel()
        xa = acc("elementwise", F32_OPS, n, [xf],
                 lambda: torch.mean(xf, dim=(1, 2)))
        xq = k1_op(acc, xa, rc[53], out_dtype=f32)
        w = t["w"]
        y = acc("cuBLAS", TF32_FLOPS, 2 * B * w.shape[0] * w.shape[1],
                [xq, w], lambda: rf._mm_f32(xq, w))
        y = acc("elementwise", F32_OPS, y.numel(), [y, t["b"]],
                lambda: y + t["b"])
        y = acc("elementwise", F32_OPS, y.numel(), [y, t["k"]],
                lambda: y * t["k"])
        return acc("elementwise", F32_OPS, 0, [y], lambda: y.to(bf16))

    out.append(Row("head(avgpool+q+fc)", 1,
                   "widening copy, mean, K1, TF32 matmul, rescale, cast",
                   head_t, head_body))

    def k1_row(name, hw, c, recip):
        def t():
            return {"x": _nhwc(dev, gen, B, hw, c, bf16)}

        def body(acc, tt):
            return k1_op(acc, tt["x"], recip)
        return Row(name, 1, "K1", t, body, jax=False)

    out.append(k1_row(f"s1 input q @{res[0]}x64", res[0], 64,
                      rc[block(0, 0)[1] + 1]))

    # --- the 27 conv + epilogue rows ---------------------------------------
    def stage_of(name):
        return int(name[1]) - 1

    for spec in jax_specs(size):
        name, hw, cin, cout, k, stride, residual, quant, count = spec
        s = stage_of(name)
        planes, blocks = STAGES[s][0], STAGES[s][1]
        b0 = ".b0." in name
        if s in chain and not b0:
            # blocks 1 and on of a K6 stage: K6 rows below; block 0's conv3
            # stays a K2 row (its output is the raw block output)
            if residual and not quant and "last" not in name:
                count = 1
            else:
                continue
        oh = hw // stride
        m_in, m = B * hw * hw, B * oh * oh
        if k == 3:                       # cuDNN 3x3 + K3 (q)
            pre, sid = block(s, 0 if b0 else 1)
            c = fw.blocks[pre]["conv2"]

            def t(c=c, hw=hw, cin=cin):
                return {"x": _nhwc(dev, gen, B, hw, cin, f32), "c": clone(c)}

            def body(acc, tt, sid=sid):     # conv3 on K2 reads bf16
                y = conv_op(acc, tt["x"], tt["c"])
                return k3_op(acc, y, tt["c"], relu=True, emit_raw=False,
                             quant_recip=rc[sid + 3], q_dtype=bf16)[1]
            route = "cuDNN 3x3 (TF32, f32 in and out), K3 q"
        elif residual:                   # conv3: K2 + residual (+ q)
            pre, sid = block(s, blocks - 1 if quant or "last" in name
                             else 0 if s in chain else 1)
            c = fw.blocks[pre]["conv3"]
            qn = STAGES[s + 1][3] + 1 if quant else None

            def t(c=c, oh=oh, cin=cin, cout=cout):
                return {"x": _nhwc(dev, gen, B, oh, cin, bf16)
                        .reshape(-1, cin),
                        "r": _nhwc(dev, gen, B, oh, cout, bf16)
                        .reshape(-1, cout), "c": clone(c)}

            def body(acc, tt, m=m, qn=qn):
                return k2_op(acc, tt["x"], tt["c"], m, relu=True,
                             residual=tt["r"],
                             quant_out_recip=None if qn is None else rc[qn])
            route = "K2 (BN, +identity, ReLU" + (", q)" if quant else ")")
        elif quant:                      # conv1: K2 (q out, f32)
            pre, sid = block(s, 0 if b0 else 1)
            c = fw.blocks[pre]["conv1"]
            prologue = not b0

            def t(c=c, hw=hw, cin=cin):
                return {"x": _nhwc(dev, gen, B, hw, cin, bf16)
                        .reshape(-1, cin), "c": clone(c)}

            def body(acc, tt, m=m_in, sid=sid, prologue=prologue):
                return k2_op(acc, tt["x"], tt["c"], m, relu=True,
                             quant_in_recip=rc[sid + 1] if prologue else None,
                             quant_out_recip=rc[sid + 2], out_dtype=f32)
            route = ("K2 (quantize prologue, " if prologue else "K2 (") + \
                "BN, ReLU, q, f32 out)"
        else:                            # downsample: copy, cuDNN, K3 raw
            pre, _ = block(s, 0)
            c = fw.blocks[pre]["down"]

            def t(c=c, hw=hw, cin=cin):
                return {"x": _nhwc(dev, gen, B, hw, cin, bf16), "c": clone(c)}

            def body(acc, tt):
                y = conv_op(acc, widen(acc, tt["x"]), tt["c"])
                return k3_op(acc, y, tt["c"], relu=False)[0]
            route = "widening copy, cuDNN 1x1 (TF32), K3 raw"
        row_name = name if count == spec[-1] else f"{name} (block 0)"
        out.append(Row(row_name, count, route, t, body,
                       jax=count == spec[-1]))

    # --- K6 stages -----------------------------------------------------------
    for s in sorted(chain):
        planes, blocks = STAGES[s][:2]
        hw, c_out = res[s], 4 * planes
        _, sid1 = block(s, 1)
        out.append(k1_row(f"s{s + 1}.b1 input q @{hw}x{c_out}", hw, c_out,
                          rc[sid1 + 1]))
        last = s + 1 == len(STAGES)
        kinds = [("raw+q", blocks - 2, True, True)]
        kinds.append(("raw, last" if last else "q, stage bnd", 1, last,
                      not last))
        for label, count, er, eq in kinds:
            b = 1 if label == "raw+q" else blocks - 1
            pre, sid = block(s, b)
            qn = (None if last and b == blocks - 1 else
                  STAGES[s + 1][3] + 1 if b == blocks - 1 else sid + 4)
            recips = (rc[sid + 2], rc[sid + 3],
                      rc[qn] if qn is not None else 1.0)
            cw = rf._chain_weights(fw, pre, recips)
            blk = fw.blocks[pre]

            def t(cw=cw, blk=blk, hw=hw, c_out=c_out):
                return {"x": _nhwc(dev, gen, B, hw, c_out, bf16),
                        "r": _nhwc(dev, gen, B, hw, c_out, bf16),
                        "w": [cw.w1.clone(), cw.w2.clone(), cw.w3.clone()],
                        "a": [getattr(blk[c], f).clone()
                              for c in ("conv1", "conv2", "conv3")
                              for f in ("scale", "shift")]}

            def body(acc, tt, recips=recips, er=er, eq=eq, ftz=cw.ftz,
                     hw=hw, c_out=c_out, mid=planes):
                npx = B * hw * hw
                return acc("K6", BF16_FLOPS,
                           2 * npx * (2 * c_out * mid + 9 * mid * mid),
                           [tt["x"], tt["r"], *tt["w"], *tt["a"]],
                           lambda: k6.bottleneck_chain(
                               tt["x"], tt["r"], *tt["w"], *tt["a"],
                               recip2=recips[0], recip3=recips[1],
                               recip_next=recips[2], emit_raw=er, emit_q=eq,
                               ftz=ftz))
            out.append(Row(f"s{s + 1}.chain {label} @{hw}x{c_out}", count,
                           f"K6 (emit {label.split(',')[0]})", t, body,
                           jax=False))

    # --- JAX's block-input quantize rows: K2 conv1's prologue ---------------
    for s, (name, hw, c, count) in enumerate(jax_quantize_rows(size)):
        if s in chain:
            continue     # K6 emits them, but block 1's (its K1 row)
        out.append(Row(name, count, "in K2 conv1's prologue (no launch)",
                       dict, lambda acc, tt: None))
    return out


# ------------------------------------------------------------------ timing

def tensor_bytes(tree, seen=None) -> dict:
    """{dtype name: bytes} of the tensors in ``tree`` (dataclasses, dicts
    and lists walked; a storage counted once): a row's set here, a fused
    executor's weights in ``bench_packed_fused``."""
    import torch

    seen = set() if seen is None else seen
    if isinstance(tree, torch.Tensor):
        key = (tree.untyped_storage().data_ptr(), tree.dtype)
        if key in seen:
            return {}
        seen.add(key)
        return {str(tree.dtype).replace("torch.", ""):
                tree.untyped_storage().nbytes()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    out = {}
    for t in tree if isinstance(tree, (list, tuple)) else ():
        for k, v in tensor_bytes(t, seen).items():
            out[k] = out.get(k, 0) + v
    return out


def _sets(tensors: dict) -> int:
    """How many copies of a row's tensors its timed calls rotate over: at
    least two, and enough that their bytes exceed the L2 twice, so that no
    call reads what an earlier one left there."""
    nbytes = sum(tensor_bytes(tensors).values())
    return max(2, min(64, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def measure_row(row: Row, dev, runs: int = 3) -> dict:
    """One row's JSON line: JAX's keys (op, count, ms, MB, GBps, gflops,
    tflops, roofline_ms, roofline_frac, bound, total_ms, total_roofline_ms)
    and the port's (route, launches by class a call, bound and time by
    class).  Times are None on the CPU."""
    import torch

    from cnns_slfp_quantization_tpu_torch.ops.backend import backend_flags
    from cnns_slfp_quantization_tpu_torch.utils import profiling

    with backend_flags():
        first = row.tensors()
        acc = Counter()
        acc.ops = []
        row.body(acc, first)
        ops = acc.ops
        acc.ops = None
        nbytes = sum(o.nbytes for o in ops)
        flops = sum(o.ops for o in ops)
        bound = sum(o.bound[0] for o in ops)
        by_class, launches = {}, {}
        for o in ops:
            by_class[o.cls] = by_class.get(o.cls, 0.0) + o.bound[0]
            launches[o.cls] = launches.get(o.cls, 0) + 1
        t_bytes = sum(1e3 * o.nbytes / HBM_BYTES_PER_S for o in ops)
        t_ops = sum(1e3 * o.ops / o.peak for o in ops)
        ms, classes, traced = None, None, None
        if ops and dev.type == "cuda":
            sets = [first] + [row.tensors()
                              for _ in range(_sets(first) - 1)]
            ring = [None] * len(sets)
            turn = itertools.cycle(range(len(sets)))

            def call():
                i = next(turn)
                ring[i] = row.body(acc, sets[i])
            ms = profiling.graph_ms(call, len(sets), device=dev)
            try:
                prof = profiling.kernel_profile(call, len(sets), runs=runs)
                classes = prof["classes"]
                traced = {k: v for k, v in prof["launches"].items() if v}
            except RuntimeError as e:   # a measurement: the row stays
                print(f"  {row.name}: by class not measured ({e})",
                      file=sys.stderr, flush=True)
            del sets, ring
            torch.cuda.empty_cache()
    frac = (bound / ms) if ms else None
    return {
        "op": row.name, "count": row.count, "route": row.route,
        "jax_row": row.jax,
        "ms": ms, "MB": nbytes / 1e6,
        "GBps": nbytes / ms / 1e6 if ms else None,
        "gflops": flops / 1e9,
        "tflops": flops / ms / 1e9 if ms else None,
        "roofline_ms": bound, "roofline_frac": frac,
        "bound": "bytes" if t_bytes >= t_ops else "operations",
        "total_ms": row.count * ms if ms is not None else None,
        "total_roofline_ms": row.count * bound,
        "launches": launches, "traced_launches": traced,
        "roofline_ms_by_class": by_class, "ms_by_class": classes,
    }


# ------------------------------------------------------------------ a case

POLICIES = {"jax": {"chain": frozenset()}, "default": None}


def executor_launches(fw, x, policy) -> dict:
    """{kernel class: launches} of one eager forward of the executor ``fw``
    under ``policy``, from the wrappers' counters (the card only)."""
    import torch

    from cnns_slfp_quantization_tpu_torch import kernels
    from cnns_slfp_quantization_tpu_torch.models import resnet50_fused as rf
    from cnns_slfp_quantization_tpu_torch.utils.profiling import HAND_CLASSES

    kernels.reset_launches()
    with torch.inference_mode():
        rf.fused_apply(fw, x, policy=policy)
    torch.cuda.synchronize()
    out = {}
    for name, n in kernels.launches().items():
        if n and name in HAND_CLASSES:
            out[HAND_CLASSES[name]] = out.get(HAND_CLASSES[name], 0) + n
    return out


def engine(batch: int, size: int, dev):
    """The engine whose executor the rows take their weights from: seed 0,
    shipped scales, the default policy."""
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    return InferenceEngine("resnet", qbit=8, batch_size=batch,
                           image_size=size, seed=0, device=dev.type)


def run_case(policy: str, eng, dev, card: str, runs: int = 3,
             engine_iters: int = 16) -> dict:
    """Every row of one forward of ``eng``'s executor at its batch under
    ``policy``, each printed as it comes, and the summary (printed, and
    returned with the rows under ``"rows"``).  The engine's per-batch time
    under ``policy``: ``throughput()`` where it is the engine's own policy,
    else its executor timed as ``throughput()`` times it
    (``profiling.scan_throughput`` on zeros, one CUDA graph)."""
    import torch

    from cnns_slfp_quantization_tpu_torch.models import resnet50_fused as rf
    from cnns_slfp_quantization_tpu_torch.utils.profiling import (
        scan_throughput)

    batch, size = eng.batch_size, eng.image_size
    fw = eng.executor
    rc = fw.recips
    gen = torch.Generator(device=dev).manual_seed(0)
    out_rows = []
    for row in rows(fw, rc, policy, batch, size, dev, gen):
        r = measure_row(row, dev, runs)
        r.update(policy=policy, batch=batch)
        print(json.dumps(r), flush=True)
        out_rows.append(r)
    want = {}
    for r in out_rows:
        for cls, n in r["launches"].items():
            if cls.startswith("K"):
                want[cls] = want.get(cls, 0) + r["count"] * n
    summary = {"summary": f"sum over ops (batch {batch})", "policy": policy,
               "batch": batch, "card": card, "row_launches": want}
    timed = all(r["ms"] is not None for r in out_rows if r["launches"])
    total_roof = sum(r["total_roofline_ms"] for r in out_rows)
    total = (sum(r["total_ms"] for r in out_rows if r["launches"])
             if timed else None)
    summary.update(
        total_ms=total, total_roofline_ms=total_roof,
        roofline_frac=total_roof / total if total else None,
        implied_img_per_sec=batch / (total / 1e3) if total else None)
    by_class, ms_class = {}, {}
    for r in out_rows:
        for cls, b in r["roofline_ms_by_class"].items():
            by_class[cls] = by_class.get(cls, 0.0) + r["count"] * b
        for cls, ms in (r["ms_by_class"] or {}).items():
            ms_class[cls] = ms_class.get(cls, 0.0) + r["count"] * ms
    summary.update(roofline_ms_by_class=by_class,
                   ms_by_class=ms_class if timed else None,
                   by_class_not_measured=[
                       r["op"] for r in out_rows
                       if r["launches"] and timed and not r["ms_by_class"]],
                   rows_above_bound=[r["op"] for r in out_rows
                                     if (r["roofline_frac"] or 0) > 1.0])
    if dev.type == "cuda":
        x = torch.randn(batch, size, size, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
        pol = POLICIES[policy]
        summary["executor_launches"] = executor_launches(fw, x, pol)
        if pol == eng.policy:
            ips = eng.throughput(engine_iters)
        else:
            ips = scan_throughput(
                lambda xx: rf.fused_apply(fw, xx, policy=pol),
                torch.zeros(eng.input_shape, device=dev),
                steps=engine_iters)
        summary.update(engine_img_per_sec=ips,
                       engine_ms_per_batch=batch / ips * 1e3)
        summary["launches_agree"] = summary["executor_launches"] == want
    print(json.dumps(summary), flush=True)
    summary["rows"] = out_rows
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[256])
    ap.add_argument("--policy", nargs="+", default=list(POLICIES),
                    choices=list(POLICIES))
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    cfg = ap.parse_args(argv)
    from cnns_slfp_quantization_tpu_torch.utils import turns

    dev, card = turns.device(cfg.device)
    print(f"card: {card}", flush=True)
    ok = True
    for batch in cfg.batch:
        eng = engine(batch, cfg.size, dev)
        for policy in cfg.policy:
            s = run_case(policy, eng, dev, card, cfg.runs)
            ok &= not s["rows_above_bound"] and s.get("launches_agree", True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
