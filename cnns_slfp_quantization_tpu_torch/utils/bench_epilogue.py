"""K1 (``csrc/quantize.cu``) and K3 (``csrc/epilogue.cu``) on the card:
their device time at every served site against another checkout of the
repository, the ResNet-50 stem's K1 output type, and the fused ResNet-50
and MobileNetV1 executors' images/s in turns.

    python3 -m cnns_slfp_quantization_tpu_torch.utils.bench_epilogue \\
        [--against ROOT] [--serve] [--stem PAIRS] [--profile]

:func:`k1_sites` and :func:`k3_sites` list the shapes and forms K1 and K3
serve at batch 64 on every path, with their launches per forward; each
site says whether its consumer reads a float32 operand (cuDNN, a plain
matmul), which the kernel then writes itself.  At each site the tool calls
the wrapper in that form on inputs from seed 0, checks the output against
the plain version bit for bit, and reports the device time of the kernels
alone from torch.profiler (median of 3 runs of 5 calls that recorded every
kernel, ``profiling.kernel_ms``).  A checkout whose wrapper has no float32
output form is timed in its bfloat16 form and, where the site reads
float32, also with the ``.to(torch.float32)`` copy its executors ran
after it (``+copy``).  With ``--against ROOT`` the times also come from
the wrappers of another checkout (for example the parent commit,
unpacked with ``git archive``), each version in its own process, in turns
(this, other, other, this); the totals per forward list each version's
runs in turn order, a ``+copy`` total with the copies at the sites that
read float32.

``--serve`` times the default fused ResNet-50 executor and the fused
MobileNetV1 one (``InferenceEngine("resnet" | "mobilenetv1", qbit=8)``,
random weights from seed 0) at batch 64 and 256 in each checkout's
process, in the same turns: images/s from CUDA events around 16
back-to-back forwards.  ``--stem PAIRS`` times this checkout's ResNet-50
stem (K1, the space-to-depth layout copy and cuDNN's 4x4 conv) with K1
writing bfloat16 against float32, device time in turns.  ``--profile``
prints this checkout's fused forwards at batch 64 by kernel
(``profiling.print_forward_profile``), the bf16 -> float32 copies counted
apart.
It prints the card's name and power limit first.  Needs a CUDA device
and nvcc; it is a measuring tool, not part of the serving path.
"""

from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import sys
from collections import Counter

if __package__:
    from cnns_slfp_quantization_tpu_torch.utils import profiling, turns
else:   # a worker, run as a file: this checkout's timing, another's wrappers
    import profiling
    import turns

B = 64
# ResNet-50 stages: (planes, blocks, stride of block 0, scale id base)
STAGES = [(64, 3, 1, 1), (128, 4, 2, 11), (256, 6, 2, 24), (512, 3, 2, 43)]
CHAIN = (2, 3)       # the stages the default ResNet-50 policy runs on K6
# MobileNetV1 depthwise-separable blocks: (in, out, stride)
DW_CONFIG = [
    (32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2), (256, 256, 1),
    (256, 512, 2), (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
    (512, 512, 1), (512, 1024, 2), (1024, 1024, 1),
]
# K3's forms: relu, emit_raw, a quantized output, an identity operand
FORMS = {
    "raw_relu": dict(relu=True),
    "raw_norelu": dict(relu=False),
    "q": dict(relu=True, emit_raw=False, quant=True),
    # ShuffleNetV2's signed quantize of a bare affine (bn2, shortcut bn1)
    "q_norelu": dict(relu=False, emit_raw=False, quant=True),
    "q_res": dict(relu=True, emit_raw=False, quant=True, identity=True),
    "dual": dict(relu=True, quant=True, identity=True),
    # ResNet-50's conv3 post with the quantize left to the consumer (the
    # last block under conv3="torch"; every block output under the
    # consumer placement, resnet50_fused._diag_blockin_fuse)
    "raw_res": dict(relu=True, identity=True),
}


def _recips(name):
    from cnns_slfp_quantization_tpu_torch import calib
    from cnns_slfp_quantization_tpu_torch.ops import sfp

    return [sfp.recip_of(a) for a in calib.load_scales(name).ka]


def k1_sites(batch: int = B):
    """(path, NHWC or [N, C] shape, input dtype "f32" | "bf16", recip,
    nonneg, launches per forward, f32 out) of K1 on every path at 224x224
    (32x32 for CIFAR ``mobilenet``)."""
    rc, sq, ax = (_recips(n) for n in ("resnet50_imgnet",
                                       "squeezenet_imgnet", "alexnet_imgnet"))
    img = (batch, 224, 224, 3)
    out = []
    for path, chain in (("resnet_fused", ()), ("resnet_chain", CHAIN)):
        out += [(path, img, "f32", rc[0], False, 1, True),
                # stage 0's input, shared by K2 conv1 and the downsample conv
                (path, (batch, 56, 56, 64), "bf16", rc[1], True, 1, False)]
        res = 56
        for s, (planes, _, stride, base) in enumerate(STAGES):
            res //= stride
            if s in chain:   # block 1's input, quantized for K6
                out.append((path, (batch, res, res, 4 * planes), "bf16",
                            rc[base + 4], True, 1, False))
        out.append((path, (batch, 2048), "f32", rc[53], True, 1, True))
    out += [("mobilenetv1_fused", img, "f32", rc[0], False, 1, True),
            ("mobilenet_fused", (batch, 32, 32, 3), "f32", rc[0], False, 1,
             True),
            ("mobilenet_fused", (batch, 1024), "f32", rc[53], True, 1, True)]
    # the module paths: the input of every layer K4 does not take, which
    # cuDNN reads; the stems' inputs are the signed float32 images
    module = {"squeezenet": Counter(), "alexnet": Counter(),
              "resnet_module": Counter(), "mobilenetv1_module": Counter()}
    from cnns_slfp_quantization_tpu_torch.models.alexnet import CONVS
    from cnns_slfp_quantization_tpu_torch.models.squeezenet import (
        FIRE_PLAN,
        POOL_BEFORE,
    )

    res = 54          # SqueezeNet 1.0: stem 109, ceil pools to 54, 27, 13
    for f, (sq1, _, _) in enumerate(FIRE_PLAN):
        if f in POOL_BEFORE and f:
            res = -(-(res - 3) // 2) + 1
        module["squeezenet"][((batch, res, res, sq1), sq[3 + 3 * f])] += 1
    res, cin = 55, 64  # AlexNet: convs 55, 27, 13, 13, 13
    for sid, (feat, _, _, _, _) in enumerate(CONVS[1:], start=1):
        if CONVS[sid - 1][4]:
            res = (res - 3) // 2 + 1
        module["alexnet"][((batch, res, res, cin), ax[sid])] += 1
        cin = feat
    res = 56          # ResNet-50, use_pallas=True: the 3x3 convs' inputs
    for planes, blocks, stride, base in STAGES:
        for b in range(blocks):
            module["resnet_module"][((batch, res, res, planes),
                                     rc[base + 3 * b + 2])] += 1
            res //= stride if b == 0 else 1
    res = 112         # MobileNetV1: the depthwise convs' inputs
    for inp, _, stride in DW_CONFIG:
        module["mobilenetv1_module"][((batch, res, res, inp), rc[2])] += 1
        res = (res - 1) // stride + 1
    stem = {"squeezenet": sq[0], "alexnet": ax[0], "resnet_module": rc[0],
            "mobilenetv1_module": rc[0]}
    for path, sites in module.items():
        out.append((path, img, "f32", stem[path], False, 1, True))
        out += [(path, shape, "bf16", r, True, n, True)
                for (shape, r), n in sites.items()]
    want = {"resnet_fused": 3, "resnet_chain": 5, "mobilenetv1_fused": 1,
            "mobilenet_fused": 2, "squeezenet": 9, "alexnet": 5,
            "resnet_module": 17, "mobilenetv1_module": 14}
    got = Counter()
    for path, *_, n, _ in out:
        got[path] += n
    assert got == want, (got, want)
    return out


def _mobilenet_k3(path, size, batch, dw_kernel=True):
    """K3's sites in a fused MobileNetV1: the stem, the depthwise convs
    cuDNN runs (stride 2, or every one without K5) and the pointwise
    convs.  A quantized output is float32 where cuDNN's depthwise conv or
    the pointwise matmul reads it, bfloat16 where K5 does."""
    def k5_reads(b):
        return dw_kernel and b < len(DW_CONFIG) and DW_CONFIG[b][2] == 1

    res = (size - 1) // 2 + 1             # stem 3x3/s2/p1
    out = [(path, (batch, res, res, 32), "q", not k5_reads(0), 1)]
    for b, (inp, oup, stride) in enumerate(DW_CONFIG):
        res = (res - 1) // stride + 1
        if not k5_reads(b):
            out.append((path, (batch, res, res, inp), "q", True, 1))
        if b == len(DW_CONFIG) - 1:
            out.append((path, (batch, res, res, oup), "raw_relu", False, 1))
        else:
            out.append((path, (batch, res, res, oup), "q",
                        not k5_reads(b + 1), 1))
    return out


def k3_sites(batch: int = B):
    """(path, NHWC shape, form (:data:`FORMS`), quantized output in
    float32, launches per forward) of K3 on the fused paths at 224x224
    (32x32 for CIFAR ``mobilenet``), duplicates merged: ResNet-50 with K6
    off and under the default ``chain={2,3}`` (stem, downsample convs,
    the 3x3 convs' epilogues; K2 conv3 takes the quantize for conv3), and
    the MobileNetV1s with K5."""
    out = Counter()
    for path, chain in (("resnet_fused", ()), ("resnet_chain", CHAIN)):
        out[(path, (batch, 112, 112, 64), "raw_relu", False)] += 1
        res = 56
        for s, (planes, blocks, stride, _) in enumerate(STAGES):
            res //= stride
            out[(path, (batch, res, res, 4 * planes), "raw_norelu",
                 False)] += 1
            out[(path, (batch, res, res, planes), "q", False)] += (
                1 if s in chain else blocks)
    for path, size in (("mobilenetv1_fused", 224), ("mobilenet_fused", 32)):
        for *key, n in _mobilenet_k3(path, size, batch):
            out[tuple(key)] += n
    sites = [(*key, n) for key, n in out.items()]
    want = {"resnet_fused": 21, "resnet_chain": 14, "mobilenetv1_fused": 18,
            "mobilenet_fused": 18}
    got = Counter()
    for path, *_, n in sites:
        got[path] += n
    assert got == want, (got, want)
    return sites


# ------------------------------------------------------------------- times

def k3_inputs(shape, form, gen, dev):
    """(y, scale, shift, identity or None) of a K3 site from ``gen``."""
    import torch

    c = shape[-1]
    y = torch.randn(*shape, device=dev, generator=gen) * 40
    s = torch.rand(c, device=dev, generator=gen) * 0.02 + 1e-3
    t = torch.randn(c, device=dev, generator=gen) * 0.5
    ident = ((torch.randn(*shape, device=dev, generator=gen) * 2).to(
        torch.bfloat16) if FORMS[form].get("identity") else None)
    return y, s, t, ident


def time_sites(dev, batch: int = B):
    """{"K1|K3 shape form": {kernel: device ms per call, copy: the same
    with a float32 copy after the bfloat16 form (a wrapper without the
    float32 form, at a float32 site), f32: whether the timed form writes
    float32, bit_equal}} at every site, through the wrappers of whichever
    checkout is on sys.path."""
    import torch

    from cnns_slfp_quantization_tpu_torch.kernels import epilogue as k3
    from cnns_slfp_quantization_tpu_torch.kernels import quantize as k1
    from cnns_slfp_quantization_tpu_torch.utils.bench_gemm import same_bits

    kernel_ms = profiling.kernel_ms
    # a checkout whose wrappers predate the f32 forms (and K3's routes)
    k1_f32 = "out_dtype" in inspect.signature(k1.act_quantize).parameters
    k3_f32 = "q_dtype" in inspect.signature(k3.bn_epilogue).parameters
    rc = _recips("resnet50_imgnet")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for _, shape, dt, r, nonneg, _, f32 in k1_sites(batch):
        label = site_label("K1", shape, f"{dt} nonneg={nonneg}", f32)
        if label in out:
            continue
        x = torch.randn(*shape, device=dev, generator=gen) * (1.5 / r)
        x = (x.abs() if nonneg else x).to(
            torch.float32 if dt == "f32" else torch.bfloat16)
        kw = dict(nonneg=nonneg)
        if f32 and k1_f32:
            kw["out_dtype"] = torch.float32
        got = k1.act_quantize(x, r, **kw)
        want = k1.act_quantize_plain(x, r, **kw)
        rec = dict(kernel=kernel_ms(lambda: k1.act_quantize(x, r, **kw)),
                   f32=got.dtype == torch.float32,
                   bit_equal=same_bits(got, want))
        if f32 and not k1_f32:
            rec["copy"] = kernel_ms(lambda: k1.act_quantize(x, r, **kw).to(
                torch.float32))
        out[label] = rec
    for _, shape, form, f32, _ in k3_sites(batch):
        label = site_label("K3", shape, form, f32)
        if label in out:
            continue
        y, s, t, ident = k3_inputs(shape, form, gen, dev)
        kw = {k: v for k, v in FORMS[form].items()
              if k not in ("quant", "identity")}
        if FORMS[form].get("quant"):
            kw["quant_recip"] = rc[3]
        if f32 and k3_f32:
            kw["q_dtype"] = torch.float32
        want = k3.bn_epilogue_plain(y, s, t, identity=ident, **kw)
        if k3_f32:    # the route, decided once as the executors decide it
            kw["ftz"] = k3.ftz_route(s, t, [rc[3]])
        got = k3.bn_epilogue(y, s, t, identity=ident, **kw)
        rec = dict(kernel=kernel_ms(lambda: k3.bn_epilogue(
            y, s, t, identity=ident, **kw)),
            f32=got[1] is not None and got[1].dtype == torch.float32,
            bit_equal=all(g is None or same_bits(g, w)
                          for g, w in zip(got, want)))
        if f32 and not k3_f32:
            rec["copy"] = kernel_ms(lambda: k3.bn_epilogue(
                y, s, t, identity=ident, **kw)[1].to(torch.float32))
        out[label] = rec
    return out


def site_label(kernel, shape, form, f32):
    return f"{kernel} {tuple(shape)} {form}{' ->f32' if f32 else ''}"


def stem_turns(dev, pairs: int):
    """{"bf16" | "f32": [device ms per call, ...]}: the fused ResNet-50
    stem at batch 64, K1 writing bfloat16 or float32 ahead of the
    space-to-depth layout copy and cuDNN's 4x4 conv, in turns."""
    import torch

    from cnns_slfp_quantization_tpu_torch.kernels import quantize as k1
    from cnns_slfp_quantization_tpu_torch.models import resnet50_fused as rf
    from cnns_slfp_quantization_tpu_torch.ops.backend import backend_flags

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, 224, 224, 3, device=dev, generator=gen)
    w = torch.randn(64, 12, 4, 4, device=dev, generator=gen).to(
        torch.bfloat16).float().contiguous(memory_format=torch.channels_last)
    stem = rf.ConvKxK(w=w, scale=torch.ones(64, device=dev),
                      shift=torch.zeros(64, device=dev), stride=1, pad=0)
    r = _recips("resnet50_imgnet")[0]

    def stem_ms(dt):
        def call():
            with backend_flags():
                return rf._s2d_stem(k1.act_quantize(x, r, nonneg=False,
                                                    out_dtype=dt), stem, 7)
        return lambda: profiling.kernel_ms(call)
    return turns.alternate({"bf16": stem_ms(torch.bfloat16),
                            "f32": stem_ms(torch.float32)}, pairs)


def serve_ips(dev):
    """{"net_bBATCH": images/s} of the default fused ResNet-50 and
    MobileNetV1 executors at batch 64 and 256."""
    import torch

    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    out = {}
    for net in ("resnet", "mobilenetv1"):
        eng = InferenceEngine(net, qbit=8, batch_size=B, image_size=224,
                              seed=0)
        for batch in (64, 256):
            x = torch.randn(batch, 224, 224, 3, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(
                                0))
            profiling.throughput(lambda: eng.forward(x), batch)
            out[f"{net}_b{batch}"] = profiling.throughput(
                lambda: eng.forward(x), batch)
        del eng
    return out


def print_profiles(dev) -> None:
    """This checkout's fused forwards at batch 64 by kernel."""
    import torch

    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    x = torch.randn(B, 224, 224, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    for net, policy in (("resnet", None), ("resnet", {"chain": frozenset()}),
                        ("mobilenetv1", None)):
        eng = InferenceEngine(net, qbit=8, batch_size=B, image_size=224,
                              seed=0, policy=policy)
        print(f"profile {net} {policy or 'default'}:", flush=True)
        profiling.print_forward_profile(lambda: eng.forward(x), B)


def _worker(root: str, mode: str) -> None:
    sys.path.insert(0, root)
    import torch

    dev = torch.device("cuda")
    print(json.dumps(serve_ips(dev) if mode == "serve" else time_sites(dev)))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=pathlib.Path,
                    help="root of another checkout to time in turns")
    ap.add_argument("--serve", action="store_true",
                    help="fused ResNet-50 and MobileNetV1 images/s in turns")
    ap.add_argument("--stem", type=int, default=0,
                    help="bf16, f32, f32, bf16 turns of the stem (0: none)")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--mode", default="sites", help=argparse.SUPPRESS)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        _worker(a.worker, a.mode)
        return 0
    card = turns.card()
    if card is None:
        return 2
    print(f"card: {card}", flush=True)
    runs = turns.across_checkouts(__file__, a.against, "--mode", "sites")
    sites = Counter()     # (kernel, path, label) -> launches per forward
    for path, shape, dt, _, nonneg, n, f32 in k1_sites():
        sites[("K1", path, site_label("K1", shape, f"{dt} nonneg={nonneg}",
                                      f32))] += n
    for path, shape, form, f32, n in k3_sites():
        sites[("K3", path, site_label("K3", shape, form, f32))] += n
    # per forward: each version's kernel alone, and, for a version without
    # the f32 forms, its kernel plus the copies its executors ran after it
    per_fwd = {}
    for (kernel, path, label), n in sites.items():
        if not n:
            continue
        parts = []
        for name, rs in runs.items():
            tags = [(name, "kernel")]
            if any("copy" in r for r in runs[name][0].values()):
                tags.append((f"{name} +copy", "copy"))
            for tag, key in tags:
                ms = [r[label].get(key, r[label]["kernel"]) for r in rs]
                tot = per_fwd.setdefault((kernel, path, tag), [0.0] * len(ms))
                for i, v in enumerate(ms):
                    tot[i] += n * v
                if key in rs[0][label]:
                    parts.append(f"{tag} {turns.joined(ms, '.4f')}")
        print(f"  {path} {label} x{n}: " + ", ".join(parts)
              + " ms; bit-equal " + "/".join(
                  str(r[label]["bit_equal"]) for rs in runs.values()
                  for r in rs), flush=True)
    for (kernel, path, tag), ms in sorted(per_fwd.items()):
        print(f"per forward {kernel} {path} {tag}: {turns.joined(ms, '.4f')}"
              f" ms", flush=True)
    if a.stem:
        sys.path.insert(0, str(turns.ROOT))
        st = stem_turns(torch.device("cuda"), a.stem)
        print("stem, K1 output type, device ms in turns: " + "; ".join(
            f"{k} {turns.joined(v, '.4f')}" for k, v in st.items())
            + f"; f32 / bf16 {sum(st['f32']) / sum(st['bf16']):.3f}",
            flush=True)
    if a.serve:
        served = turns.across_checkouts(__file__, a.against, "--mode",
                                        "serve")
        for key in served["this"][0]:
            vals = {name: [r[key] for r in rs] for name, rs in served.items()}
            print(f"fused {key} images/s in turns: " + (
                turns.compared(vals) if len(vals) > 1
                else turns.joined(vals["this"])), flush=True)
    if a.profile:
        print_profiles(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
