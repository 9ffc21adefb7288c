#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the hand
   kernels from ``cnns_slfp_quantization_tpu_torch/csrc`` (one nvcc each,
   all at once).
2. Kernel phases at the shapes each path gives each kernel at batch 64 and
   224x224: every kernel against its plain PyTorch version on the same
   inputs on the card.  K1 (act quantize) and K3 (epilogue) must be
   bit-equal at every served site in the form it serves (a bf16 output, or
   a float32 one holding the same values where cuDNN or a plain matmul
   reads it) and in every form on both routes (FTZ, and exact where a
   reciprocal or a scale element is subnormal), K3 also in the forms no
   executor serves and at a C that is not a multiple of 8 (its scalar
   kernel).  K2 (fused 1x1 GEMM) and K4 (fused quantize-decode GEMM) sum
   in another order: raw bf16 and f32 outputs within one ulp of their type
   plus the reordering bound K * 2**-22 * (sum of the terms' magnitudes),
   which is one ulp unless the sum cancels to near zero; quantized outputs
   within one step of the quantizer's output in at most 0.1% of elements.
   Both give the same bits in two launches at every shape checked (split-K
   included: its partials are added in a fixed order).  K2 is checked at
   the 16 shapes of the fused ResNet-50 executor (at the conv1 sites its
   float32 output, the operand cuDNN's conv2 reads, must be its bf16
   output widened, bit for bit) and K4 at SqueezeNet
   1.0's, AlexNet's, ResNet-50's and MobileNetV1's 1x1 / dense shapes, both
   over uint8 and bf16-value weights, and at ragged shapes and split-K at
   ragged K; K4 also over every flag (signed and nonneg prologue,
   quantize_x=False, bias, ReLU, f32 and bf16 output, f32 and bf16 x, both
   weight layouts).  Each K2/K4 time is printed beside the tile plan, its
   time between CUDA events and the wmma design's time taken so.  K5
   (depthwise 3x3) must be bit-equal at MobileNetV1's 9 stride-1 sites
   (ImageNet at batch 64 and 256, CIFAR at 64) in four forms (serving:
   ReLU, quantize, bf16 out, and the same with f32 out, the form the
   executor serves; f32 out without ReLU; nonneg_in without ReLU) on its
   FTZ route and in the serving form on its exact route (a subnormal tap),
   and at odd shapes (subnormal f32 x included), and is timed in the form
   it serves, on both routes (and with bf16 out), against cuDNN's grouped
   conv alone and against the grouped conv + K3 chain it replaces.  K6
   (the bottleneck chain) must be bit-equal on
   exact inputs (every sum exact in float32), on its FTZ route and on its
   exact route (a subnormal affine parameter), at narrow widths, odd
   shapes, each kind of band its plan makes (a ragged last band, a band
   split over a pair of blocks, whole 7x7 images at batch 256) and every
   site of the chain path (stages 2 and 3 at batch 64, and stage 1, which
   the kernel also takes), give the same bits in two launches, and on
   random inputs at those sites hold raw
   outputs to cosine > 0.99999 and quantized ones to one step in at most 1%
   of elements (more than one step in at most 0.1%): it sums in another
   order, so a y1 or y2 value at a bin edge may flip.  It is timed against
   the route it replaces (K2 conv1 writing float32, cuDNN's 3x3, K3, K2
   conv3), and stage 0 must be refused.  Times are device time from
   torch.profiler (``profiling.kernel_ms``, which counts only runs that
   recorded every kernel), with the medians of 20 runs of 5 back-to-back
   calls between CUDA events printed beside for K1-K5 (events around
   kernels of a few microseconds time the host), except K6's and its
   route's, which are event times.
3. Paths, each with the launch counts reset just before it and read just
   after it, over requests of 64, 64 and 17 images:
   - ResNet-50 fused executor with K6 off, ``InferenceEngine("resnet",
     qbit=8, policy={"chain": frozenset()})``, JAX's default placement (K1
     3, K2 32, K3 21 per forward); then the same weights on the CPU
     (cosine > 0.995, same top-1), packed uint8 weights (bit-equal logits),
     ``policy={"conv3": "torch"}`` (K3 dual 12 times per forward);
   - ResNet-50 fused executor under the default policy,
     ``InferenceEngine("resnet", qbit=8)``, which runs stages 2 and 3's
     stride-1 bottlenecks on K6 (K1 5, K2 18, K3 14, K6 7 per forward),
     held against chain off's logits and the CPU's (cosine > 0.995, same
     top-1), packed weights (bit-equal logits), images/s at batch 64 and 256
     in turns with chain off;
   - SqueezeNet 1.0 and AlexNet on the module path with packed weights,
     ``InferenceEngine(net, qbit=8, pack_weights=True, use_pallas=None)``
     (K4 17 and 3 per forward, K1 9 and 5); then the CPU (cosine > 0.995,
     same top-1), float-frozen bf16 weights with ``use_pallas=True``
     (bit-equal logits) and ``use_pallas=False`` (cosine > 0.995, same
     top-1);
   - ResNet-50 on the module path with ``use_pallas=True`` (K4 37, K1 17 per
     forward), held against the fused executor's logits by the same bar;
   - MobileNetV1 ImageNet through the fused executor,
     ``InferenceEngine("mobilenetv1", qbit=8)`` (K1 1, K3 18, K5 9 per
     forward); then the CPU (cosine > 0.995, same top-1), packed weights
     (bit-equal logits), ``policy={"dw": "torch"}`` (K3 27, K5 0; cosine >
     0.995, same top-1); CIFAR ``mobilenet`` at 32x32 (K1 2, K3 18, K5 9);
     the ImageNet module path with packed weights (K4 13, K1 14), held
     against the fused logits by JAX's bar between the two (cosine > 0.98,
     equal top-1 on decisive rows).  Their scales are derived here from one
     float32 forward of the same random weights (absmax / 15.5 of each
     layer's input and weight): the shipped constants belong to trained
     weights and saturate the quantizers of random ones;
   and images/s at batch 64 of each against the unquantized float32 module
   path (``qbit=32, compute_dtype=None``), plus the fused executors' at
   batch 256.
4. A torch.profiler breakdown per forward of the ResNet-50 fused executor
   (default ``chain={2,3}`` and chain off), the MobileNetV1 fused executor
   (both ``dw`` routes) and SqueezeNet 1.0's module path, with the bf16 ->
   float32 copies that remain counted apart.

The line before the last is one JSON object with, for each kernel, its
launches over the run of its first path (``launches``, three forwards) and
per forward, and, per forward at batch 64 on that path, its time, its plain
version's time, the matching PyTorch call's time where one exists, and its
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the card's peak for their type.  ``by_path`` gives the same
per path.  The last line is ``{"ok": true, "device": {...}}``.  Any failed
check exits non-zero first, and so does a run without a CUDA device or
outside the repository.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
PKG = "cnns_slfp_quantization_tpu_torch"
B = 64
NO_CHAIN = {"chain": frozenset()}   # ResNet-50 without K6 (JAX's default)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor cores
F32_OPS = 67e12                # float32 outside the tensor cores
# integer/float operations per element of the elementwise kernels, counted
# from csrc/slfp.cuh (quantize ~25, epilogue affine+residual+ReLU+quantize
# ~35); both are far below the bytes bound
K1_OPS, K3_OPS = 25, 35
DW_OPS = 18                    # K5's stencil: 9 multiply-adds per element
# ms per launch of the wmma design of K2 and K4 that the shared Hopper
# mainloop replaced, per shape at batch 64 (K2 with bf16 weights, K4 with
# uint8 codes), from this script's last run on that design (NVIDIA H100
# 80GB HBM3, 700.00 W): CUDA events around 5 back-to-back calls, which for
# kernels of a few microseconds time the host as much as the card.
# Printed beside the new design's time taken the same way.
OLD_K2_MS = {
    ('c1_b0', 200704, 64, 64): 0.0589,
    ('c1_mid', 200704, 256, 64): 0.1367,
    ('c3_mid', 200704, 64, 256): 0.2014,
    ('c3_end', 200704, 64, 256): 0.2478,
    ('c1_b0', 200704, 256, 128): 0.1832,
    ('c1_mid', 50176, 512, 128): 0.1205,
    ('c3_mid', 50176, 128, 512): 0.125,
    ('c3_end', 50176, 128, 512): 0.1462,
    ('c1_b0', 50176, 512, 256): 0.1497,
    ('c1_mid', 12544, 1024, 256): 0.1118,
    ('c3_mid', 12544, 256, 1024): 0.0887,
    ('c3_end', 12544, 256, 1024): 0.0986,
    ('c1_b0', 12544, 1024, 512): 0.1243,
    ('c1_mid', 3136, 2048, 512): 0.111,
    ('c3_mid', 3136, 512, 2048): 0.0706,
    ('c3_last', 3136, 512, 2048): 0.0701,
}
OLD_K4_MS = {
    ('squeezenet', (64, 54, 54, 96), 96, 16, 1): 0.0808,
    ('squeezenet', (64, 54, 54, 16), 16, 64, 1): 0.043,
    ('squeezenet', (64, 54, 54, 128), 128, 16, 1): 0.0774,
    ('squeezenet', (64, 54, 54, 128), 128, 32, 1): 0.0777,
    ('squeezenet', (64, 54, 54, 32), 32, 128, 1): 0.0805,
    ('squeezenet', (64, 27, 27, 256), 256, 32, 1): 0.048,
    ('squeezenet', (64, 27, 27, 32), 32, 128, 1): 0.0416,
    ('squeezenet', (64, 27, 27, 256), 256, 48, 1): 0.0647,
    ('squeezenet', (64, 27, 27, 48), 48, 192, 1): 0.0427,
    ('squeezenet', (64, 27, 27, 384), 384, 48, 1): 0.053,
    ('squeezenet', (64, 27, 27, 384), 384, 64, 1): 0.0612,
    ('squeezenet', (64, 27, 27, 64), 64, 256, 1): 0.0649,
    ('squeezenet', (64, 13, 13, 512), 512, 64, 1): 0.0673,
    ('squeezenet', (64, 13, 13, 64), 64, 256, 1): 0.0412,
    ('squeezenet', (64, 13, 13, 512), 512, 1000, 1): 0.2003,
    ('alexnet', (64, 9216), 9216, 4096, 1): 0.376,
    ('alexnet', (64, 4096), 4096, 4096, 1): 0.1352,
    ('alexnet', (64, 4096), 4096, 1000, 1): 0.1463,
    ('resnet_module', (64, 56, 56, 64), 64, 64, 1): 0.0583,
    ('resnet_module', (64, 56, 56, 64), 64, 256, 1): 0.2121,
    ('resnet_module', (64, 56, 56, 256), 256, 64, 1): 0.1287,
    ('resnet_module', (64, 56, 56, 256), 256, 128, 1): 0.254,
    ('resnet_module', (64, 28, 28, 128), 128, 512, 1): 0.1575,
    ('resnet_module', (64, 56, 56, 256), 256, 512, 2): 0.2492,
    ('resnet_module', (64, 28, 28, 512), 512, 128, 1): 0.1199,
    ('resnet_module', (64, 28, 28, 512), 512, 256, 1): 0.2271,
    ('resnet_module', (64, 14, 14, 256), 256, 1024, 1): 0.1279,
    ('resnet_module', (64, 28, 28, 512), 512, 1024, 2): 0.2285,
    ('resnet_module', (64, 14, 14, 1024), 1024, 256, 1): 0.1224,
    ('resnet_module', (64, 14, 14, 1024), 1024, 512, 1): 0.2218,
    ('resnet_module', (64, 7, 7, 512), 512, 2048, 1): 0.1188,
    ('resnet_module', (64, 14, 14, 1024), 1024, 2048, 2): 0.2184,
    ('resnet_module', (64, 7, 7, 2048), 2048, 512, 1): 0.1254,
    ('resnet_module', (64, 2048), 2048, 1000, 1): 0.0812,
    ('mobilenetv1_module', (64, 112, 112, 32), 32, 64, 1): 0.1637,
    ('mobilenetv1_module', (64, 56, 56, 64), 64, 128, 1): 0.112,
    ('mobilenetv1_module', (64, 56, 56, 128), 128, 128, 1): 0.16,
    ('mobilenetv1_module', (64, 28, 28, 128), 128, 256, 1): 0.0813,
    ('mobilenetv1_module', (64, 28, 28, 256), 256, 256, 1): 0.1293,
    ('mobilenetv1_module', (64, 14, 14, 256), 256, 512, 1): 0.0676,
    ('mobilenetv1_module', (64, 14, 14, 512), 512, 512, 1): 0.1179,
    ('mobilenetv1_module', (64, 7, 7, 512), 512, 1024, 1): 0.0646,
    ('mobilenetv1_module', (64, 7, 7, 1024), 1024, 1024, 1): 0.118,
}

failures: list = []


def phase(name):
    def wrap(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **k)
                print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s",
                      flush=True)
                return out
            except Exception:  # report every phase, then exit non-zero
                failures.append(name)
                print(f"[{name}] FAILED\n{traceback.format_exc()}",
                      flush=True)
                return None
        return run
    return wrap


def bound_ms(nbytes, ops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Row:
    """One kernel's JSON entry.  Per path, per-forward totals: the sum over
    the path's shapes of (value at that shape) x (launches of that shape per
    forward).  The top-level numbers are those of the kernel's first path,
    ``main``."""

    def __init__(self, name, source, replaces, main):
        self.head = dict(name=name, route="cuda", source=source,
                         replaces=replaces)
        self.main = main
        self.paths = {}
        self.max_abs_err = 0.0

    def _path(self, path):
        return self.paths.setdefault(path or self.main, dict(
            launches=0, launches_per_forward=0, ms=0.0, plain_ms=0.0,
            bound_ms=0.0, bound_by="bytes", library_ms=None,
            t_bytes=0.0, t_ops=0.0))

    def add(self, per_fwd, ms, plain_ms, nbytes, ops, peak, lib_ms=None,
            path=None):
        d = self._path(path)
        d["ms"] += per_fwd * ms
        d["plain_ms"] += per_fwd * plain_ms
        d["t_bytes"] += per_fwd * nbytes / HBM_BYTES_PER_S
        d["t_ops"] += per_fwd * ops / peak
        d["bound_ms"] += per_fwd * bound_ms(nbytes, ops, peak)[0]
        d["bound_by"] = ("bytes" if d["t_bytes"] >= d["t_ops"]
                         else "operations")
        if lib_ms is not None:
            d["library_ms"] = (d["library_ms"] or 0.0) + per_fwd * lib_ms

    def counted(self, path, launches, forwards):
        d = self._path(path)
        d["launches"] = launches
        d["launches_per_forward"] = launches // forwards

    def err(self, e):
        self.max_abs_err = max(self.max_abs_err, float(e))

    def out(self):
        keys = ("launches", "launches_per_forward", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        main = self._path(self.main)
        return dict(self.head, **{k: main[k] for k in keys},
                    max_abs_err=self.max_abs_err,
                    by_path={p: {k: d[k] for k in keys}
                             for p, d in self.paths.items()})


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    from cnns_slfp_quantization_tpu_torch import calib, kernels
    from cnns_slfp_quantization_tpu_torch.kernels import _build, _gemm_plan
    from cnns_slfp_quantization_tpu_torch.kernels import chain as k6
    from cnns_slfp_quantization_tpu_torch.kernels import depthwise as k5
    from cnns_slfp_quantization_tpu_torch.kernels import epilogue as k3
    from cnns_slfp_quantization_tpu_torch.kernels import fused_matmul as k4
    from cnns_slfp_quantization_tpu_torch.kernels import qmm as k2
    from cnns_slfp_quantization_tpu_torch.kernels import quantize as k1
    from cnns_slfp_quantization_tpu_torch.models.mobilenetv1 import DW_CONFIG
    from cnns_slfp_quantization_tpu_torch.models.resnet50_fused import (
        ConvKxK,
        _conv_f32,
    )
    from cnns_slfp_quantization_tpu_torch.ops import sfp
    from cnns_slfp_quantization_tpu_torch.ops.backend import backend_flags
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
    from cnns_slfp_quantization_tpu_torch.utils import (
        bench_epilogue,
        bench_gemm,
    )
    from cnns_slfp_quantization_tpu_torch.utils.profiling import (
        kernel_ms, median_ms, print_forward_profile, throughput)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    rc = [sfp.recip_of(a) for a in calib.load_scales("resnet50_imgnet").ka]
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    t0 = time.perf_counter()
    build_s = _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    print(f"build: {build_s:.1f} s nvcc ({time.perf_counter() - t0:.1f} s "
          f"with loading) for {', '.join(_build.SOURCES)}", flush=True)

    rows = {
        "k1": Row("act_quantize", f"{PKG}/csrc/quantize.cu",
                  "cnns_slfp_quantization_tpu/kernels/quantize.py:83",
                  "resnet_fused"),
        "k2": Row("qmm_fused", f"{PKG}/csrc/qmm.cu",
                  "cnns_slfp_quantization_tpu/kernels/qmm.py:93",
                  "resnet_fused"),
        "k3": Row("bn_epilogue", f"{PKG}/csrc/epilogue.cu",
                  "cnns_slfp_quantization_tpu/kernels/epilogue.py:45",
                  "resnet_fused"),
        "k4": Row("fused_quant_matmul", f"{PKG}/csrc/fused_matmul.cu",
                  "cnns_slfp_quantization_tpu/kernels/fused_matmul.py:76",
                  "squeezenet"),
        "k5": Row("dw3x3", f"{PKG}/csrc/depthwise.cu",
                  "cnns_slfp_quantization_tpu/kernels/depthwise.py:61",
                  "mobilenetv1_fused"),
        "k6": Row("bottleneck_chain", f"{PKG}/csrc/chain.cu",
                  "cnns_slfp_quantization_tpu/kernels/chain.py:87",
                  "resnet_chain"),
    }

    def same_bits(a, b):
        ai = a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32)
        bi = b.view(torch.int16) if b.dtype == torch.bfloat16 else b.view(torch.int32)
        return bool(torch.equal(ai, bi))

    def k5_sites(size):
        """MobileNetV1's K5 sites at batch B for size x size images:
        {NHWC shape: launches per forward}."""
        from collections import Counter

        k5s = Counter()
        res = (size - 1) // 2 + 1             # stem 3x3/s2/p1
        for inp, _, stride in DW_CONFIG:
            if stride == 1:
                k5s[(B, res, res, inp)] += 1
            res = (res - 1) // stride + 1
        assert sum(k5s.values()) == 9
        return k5s

    mn_k5_sites = {"mobilenetv1_fused": k5_sites(224),
                   "mobilenet_fused": k5_sites(32)}
    k4_module_sites = bench_gemm.k4_sites(B)

    # ------------------------------------------------------------------ K1
    def timed(call, plain):
        """(device ms from the profiler, ms between CUDA events, plain ms)
        of a kernel call and its plain version."""
        return (kernel_ms(call), median_ms(call),
                median_ms(plain, iters=5, inner=1))

    @phase("K1 act_quantize")
    def k1_phase():
        # every served site in the form its consumer reads (f32 for cuDNN
        # and the plain matmuls), on the FTZ route the executors' normal
        # reciprocals take
        seen = {}
        for path, shape, dt, r, nonneg, per_fwd, f32 in \
                bench_epilogue.k1_sites(B):
            od = torch.float32 if f32 else torch.bfloat16
            key = (shape, dt, nonneg, f32)
            if key not in seen:
                x = randn(*shape, scale=1.5 / r)
                x = (x.abs() if nonneg else x).to(
                    torch.float32 if dt == "f32" else torch.bfloat16)
                kw = dict(nonneg=nonneg, out_dtype=od)
                before = k1.act_quantize.ftz_launches
                got = k1.act_quantize(x, r, **kw)
                assert k1.act_quantize.ftz_launches - before == 1
                want = k1.act_quantize_plain(x, r, **kw)
                torch.cuda.synchronize()
                assert same_bits(got, want), f"K1 {shape} {od} not bit-equal"
                n = x.numel()
                nbytes = n * (x.element_size() + got.element_size())
                seen[key] = timed(lambda: k1.act_quantize(x, r, **kw),
                                  lambda: k1.act_quantize_plain(x, r, **kw)) \
                    + (nbytes, n)
            ms, ems, pms, nbytes, n = seen[key]
            rows["k1"].add(per_fwd, ms, pms, nbytes, n * K1_OPS, F32_OPS,
                           path=path)
            print(f"  K1 {path} {shape} {dt} -> {od} x{per_fwd}: {ms:.4f} "
                  f"ms (events {ems:.4f}), plain {pms:.4f} ms, bound "
                  f"{bound_ms(nbytes, n * K1_OPS, F32_OPS)[0]:.4f} ms",
                  flush=True)
        # every form on both routes: qbit 7 and 8, signed and nonneg, f32
        # and bf16 in and out; a subnormal reciprocal takes the exact route
        # (on huge inputs, so that products are not all flushed)
        for qbit in (7, 8):
            for nonneg in (True, False):
                for dt in (torch.float32, torch.bfloat16):
                    for od in (torch.bfloat16, torch.float32):
                        for r, scale in ((rc[3], 5.0), (2e-39, 2e37)):
                            x = randn(B, 14, 14, 256, scale=scale)
                            x = (x.abs() if nonneg else x).to(dt)
                            kw = dict(qbit=qbit, nonneg=nonneg, out_dtype=od)
                            before = k1.act_quantize.ftz_launches
                            got = k1.act_quantize(x, r, **kw)
                            ftz = k1.act_quantize.ftz_launches - before
                            assert ftz == int(r > 1e-30), (r, ftz)
                            assert same_bits(got, k1.act_quantize_plain(
                                x, r, **kw)), f"K1 form {kw} {dt} {r}"
        # the Pallas kernel's own form (f32 -> f32, bf16 -> bf16)
        for dt in (torch.float32, torch.bfloat16):
            x = randn(B, 28, 28, 128, scale=6.0).to(dt)
            assert same_bits(k1.slfp34_act_quantize(x),
                             k1.slfp34_act_quantize_plain(x)), dt
        # scalar tail and unaligned path
        x = randn(1000003, scale=5.0)[1:]
        for od in (torch.bfloat16, torch.float32):
            assert same_bits(
                k1.act_quantize(x, rc[3], nonneg=False, out_dtype=od),
                k1.act_quantize_plain(x, rc[3], nonneg=False, out_dtype=od))

    # ------------------------------------------------------------------ K2
    flag_sets = bench_gemm.k2_flags(rc)
    emitted = bench_gemm.emitted_values(dev)

    def k2_check(got, want, quantized, label, mag, k):
        """One ulp plus the reordering bound K * 2**-22 * sum|terms| (raw),
        one quantizer step in at most 0.1% of elements (quantized):
        ``bench_gemm.check_gemm``."""
        return bench_gemm.check_gemm(got, want, quantized, label, mag, k,
                                     emitted)

    def plan_str(m, k, n, residual=False):
        p = _gemm_plan.plan(m, k, n, residual)
        return (f"plan bm {p.bm} bn {p.bn} split {p.split} stages "
                f"{p.stages}")

    def k2_case(x, w, s, t, res, flags, label, mag, k):
        """K2 against its plain version, and the same bits in two
        launches."""
        got = k2.qmm_fused(x, w, s, t, residual=res, **flags)
        again = k2.qmm_fused(x, w, s, t, residual=res, **flags)
        want = k2.qmm_plain(x, w, s, t, residual=res, **flags)
        torch.cuda.synchronize()
        rows["k2"].err(k2_check(got, want, "quant_out_recip" in flags,
                                label, mag, k))
        assert same_bits(got, again), f"{label}: two launches differ"

    @phase("K2 qmm_fused")
    def k2_phase():
        for m, k, n, site, per_fwd in bench_gemm.k2_sites(B):
            flags = dict(flag_sets[site])
            res = randn(m, n, scale=2.0).to(torch.bfloat16) \
                if flags.pop("residual", False) else None
            # conv1 writes the f32 operand cuDNN's conv2 reads
            out_f32 = flags.pop("out_f32", False)
            raw_in = "quant_in_recip" in flags
            x = randn(m, k, scale=3.0).abs().to(torch.bfloat16)
            if not raw_in:  # a quantized input, as the producer emits it
                x = k1.act_quantize_plain(x, 1.0)
            # the executor's [N, K] storage, handed over as its transpose
            wq = sfp.quantize_weight(randn(n, k, scale=4.0), 8)
            s = torch.rand(n, device=dev, generator=gen) * 0.01 + 1e-3
            t = randn(n, scale=0.5)
            mag = bench_gemm.gemm_mag(
                k1.act_quantize_plain(x, flags["quant_in_recip"]) if raw_in
                else x, wq.to(torch.bfloat16).t(), s, t, res)
            for w in (sfp.pack_slfp34(wq).t(), wq.to(torch.bfloat16).t()):
                label = f"K2 {site} M={m} K={k} N={n} {w.dtype}"
                k2_case(x, w, s, t, res, flags, label, mag, k)
                if out_f32:
                    # the f32 form is the bf16 form widened, bit for bit
                    got = k2.qmm_fused(x, w, s, t, residual=res,
                                       out_dtype=torch.float32, **flags)
                    bf = k2.qmm_fused(x, w, s, t, residual=res, **flags)
                    torch.cuda.synchronize()
                    assert got.dtype == torch.float32
                    assert same_bits(got, bf.float()), \
                        f"{label}: f32 output is not the bf16 one widened"
            if out_f32:
                flags["out_dtype"] = torch.float32
            args = (x, w, s, t)   # bf16 weights: the path's default
            ms = kernel_ms(lambda: k2.qmm_fused(*args, residual=res,
                                                **flags))
            pms = median_ms(lambda: k2.qmm_plain(*args, residual=res,
                                                 **flags))
            wb = w
            lms = kernel_ms(lambda: torch.matmul(x, wb))
            ems = median_ms(lambda: k2.qmm_fused(*args, residual=res,
                                                 **flags))
            nbytes = (m * k * 2 + k * n * 2 + n * 8 + m * n * (4 if out_f32
                                                               else 2)
                      + (m * n * 2 if res is not None else 0))
            ops = 2 * m * k * n
            rows["k2"].add(per_fwd, ms, pms, nbytes, ops, BF16_FLOPS, lms)
            bms, by = bound_ms(nbytes, ops, BF16_FLOPS)
            print(f"  {label} x{per_fwd}: {ms:.4f} ms "
                  f"({ops / ms / 1e9:.1f} TFLOP/s; events {ems:.4f}, wmma "
                  f"design {OLD_K2_MS[(site, m, k, n)]:.4f}), plain {pms:.4f}, "
                  f"torch.matmul {lms:.4f}, bound {bms:.4f} ({by}); "
                  f"{plan_str(m, k, n, res is not None)}"
                  + ("; f32 out" if out_f32 else ""), flush=True)
        # f32 output and ragged M / K / N (multiples of 8: rows of 72 codes
        # go by cp.async) with [K, N] weights, and split-K at ragged K with
        # [N, K] storage
        for m, k, n, nk in ((1000, 136, 72, False), (B, 4104, 512, True)):
            x = randn(m, k, scale=3.0).abs().to(torch.bfloat16)
            wq = sfp.quantize_weight(randn(k, n, scale=4.0), 8)
            if nk:
                wq = wq.t().contiguous().t()
            s = torch.rand(n, device=dev, generator=gen) * 0.01
            t = randn(n)
            res = randn(m, n, scale=2.0).to(torch.bfloat16)
            mag = bench_gemm.gemm_mag(k1.act_quantize_plain(x, rc[4]),
                                      wq.to(torch.bfloat16), s, t, res)
            for od in (torch.float32, torch.bfloat16):
                for w in (wq.to(torch.bfloat16), sfp.pack_slfp34(wq)):
                    k2_case(x, w, s, t, res,
                            dict(quant_in_recip=rc[4], out_dtype=od),
                            f"K2 ragged M={m} K={k} N={n} {od} {w.dtype}",
                            mag, k)
            print(f"  K2 M={m} K={k} N={n}: ok; {plan_str(m, k, n, True)}",
                  flush=True)

    # ------------------------------------------------------------------ K3
    def k3_case(shape, form, q_f32, sub=False):
        """K3 in ``form`` (``bench_epilogue.FORMS``) on inputs of
        ``shape``, against its plain version, bit for bit; ``sub``: one
        subnormal scale element, which takes the exact route.  Returns
        (kernel call, plain call, bytes, elements)."""
        y, s, t, ident = bench_epilogue.k3_inputs(shape, form, gen, dev)
        if sub:
            s[0] = 1e-39
        y.view(-1)[::97] = 3e-39       # flushed on either route
        kw = {k: v for k, v in bench_epilogue.FORMS[form].items()
              if k not in ("quant", "identity")}
        if bench_epilogue.FORMS[form].get("quant"):
            kw.update(quant_recip=rc[3],
                      q_dtype=torch.float32 if q_f32 else torch.bfloat16)
        before = k3.bn_epilogue.ftz_launches
        got = k3.bn_epilogue(y, s, t, identity=ident, **kw)
        assert k3.bn_epilogue.ftz_launches - before == int(not sub)
        want = k3.bn_epilogue_plain(y, s, t, identity=ident, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert same_bits(g, w), \
                    f"K3 {form} {shape} q_f32={q_f32} sub={sub} not bit-equal"
        n = y.numel()
        nbytes = sum(v.numel() * v.element_size()
                     for v in (y, ident, s, t, *got) if v is not None)
        ftz = not sub
        return (lambda: k3.bn_epilogue(y, s, t, identity=ident, ftz=ftz,
                                       **kw),
                lambda: k3.bn_epilogue_plain(y, s, t, identity=ident, **kw),
                nbytes, n)

    @phase("K3 bn_epilogue")
    def k3_phase():
        # every served site in the form its consumer reads, timed on the
        # FTZ route as the executors pass it
        seen = {}
        for path, shape, form, q_f32, per_fwd in bench_epilogue.k3_sites(B):
            key = (shape, form, q_f32)
            if key not in seen:
                call, plain, nbytes, n = k3_case(shape, form, q_f32)
                seen[key] = timed(call, plain) + (nbytes, n)
            ms, ems, pms, nbytes, n = seen[key]
            rows["k3"].add(per_fwd, ms, pms, nbytes, n * K3_OPS, F32_OPS,
                           path=path)
            print(f"  K3 {path} {form}{' f32 q' if q_f32 else ''} {shape} "
                  f"x{per_fwd}: {ms:.4f} ms (events {ems:.4f}), plain "
                  f"{pms:.4f} ms, bound "
                  f"{bound_ms(nbytes, n * K3_OPS, F32_OPS)[0]:.4f} ms",
                  flush=True)
        # every form the executors serve, q in both types, on both routes
        # (ResNet-50's torch policies serve the dual and q_res forms); the
        # forms no executor serves, and a C that is not a multiple of 8,
        # take the scalar kernel
        for form in bench_epilogue.FORMS:
            for q_f32 in (False, True):
                for sub in (False, True):
                    k3_case((B, 14, 14, 256), form, q_f32, sub)
                    k3_case((3, 1000, 4096), form, q_f32, sub)
        for c in (20, 64):
            y = randn(7, 13, c)
            s, t = torch.rand(c, device=dev) + 0.1, randn(c)
            for kw in (dict(quant_recip=rc[2]), dict(relu=False),
                       dict(quant_recip=rc[2], q_dtype=torch.float32),
                       dict(relu=False, emit_raw=False, quant_recip=rc[2])):
                for g, w in zip(k3.bn_epilogue(y, s, t, **kw),
                                k3.bn_epilogue_plain(y, s, t, **kw)):
                    assert (g is None) == (w is None)
                    assert g is None or same_bits(g, w), \
                        f"K3 scalar kernel C={c} {kw}"

    # ------------------------------------------------------------------ K4
    ka4, kw4 = 0.37, 0.11  # x / ka spans the quantizer's range below

    def k4_case(x, w, bias, stride=1, label="", **flags):
        """Run K4 and its plain version on one input; check by K2's rule.
        Returns (kernel call, plain call, library call, bytes, ops)."""
        flags = dict(ka=ka4, kw=kw4, **flags)
        if x.dim() == 4:
            xs = x[:, ::stride, ::stride, :]
            x2 = xs.reshape(-1, xs.shape[-1])
            b_eff = k4._dense_bias(w, bias, flags.get("act"), dev)

            def call():
                return k4.quant_conv1x1(x, w, bias=bias, stride=stride,
                                        **flags).reshape(-1, w.shape[1])
        else:
            x2, b_eff = x, bias

            def call():
                return k4.fused_quant_matmul(x, w, bias=bias, **flags)

        def plain():
            return k4.fused_quant_matmul_plain(x2, w, bias=b_eff, **flags)

        got, again, want = call(), call(), plain()
        torch.cuda.synchronize()
        assert same_bits(got, again), f"{label}: two launches differ"
        if flags.get("quantize_x", True):
            xq = sfp.act_bf16_bits(x2, 1.0 / ka4, 8, flags.get("nonneg", False))
        else:
            xq = x2.to(torch.bfloat16)
        wv = k4._weight_values(w)
        mag = xq.float().abs() @ wv.float().abs()
        if b_eff is not None:
            mag = mag + b_eff.abs() / (ka4 * kw4)
        mag = mag * (ka4 * kw4)
        rows["k4"].err(k2_check(got, want, False, label, mag, w.shape[0]))
        wvc = wv.contiguous()
        m, k, n = x2.shape[0], w.shape[0], w.shape[1]
        nbytes = (m * k * x.element_size() + k * n * w.element_size()
                  + (4 * n if b_eff is not None else 0)
                  + m * n * got.element_size())
        return call, plain, (lambda: torch.matmul(xq, wvc)), nbytes, \
            2 * m * k * n

    @phase("K4 fused_quant_matmul")
    def k4_phase():
        for path, sites in k4_module_sites.items():
            for shape, k, n, stride, has_bias, per_fwd in sites:
                x = randn(*shape, scale=1.5).abs().to(torch.bfloat16)
                # the layers' [N, K] storage, handed over as its transpose
                wq = sfp.quantize_weight(randn(n, k, scale=4.0), 8)
                bias = randn(n, scale=0.1) if has_bias else None
                ms_bf16 = None
                for w in (wq.to(torch.bfloat16).t(), sfp.pack_slfp34(wq).t()):
                    label = (f"K4 {path} {shape} K={k} N={n} s{stride} "
                             f"{w.dtype}")
                    call, plain, lib, nbytes, ops = k4_case(
                        x, w, bias, stride, label, nonneg=True,
                        out_dtype=torch.bfloat16)
                    ms = kernel_ms(call)
                    if w.dtype != torch.uint8:  # the path serves codes
                        ms_bf16 = ms
                        continue
                    pms = median_ms(plain, iters=5, inner=1)
                    lms = kernel_ms(lib)
                    ems = median_ms(call)
                    rows["k4"].add(per_fwd, ms, pms, nbytes, ops, BF16_FLOPS,
                                   lms, path=path)
                    bms, by = bound_ms(nbytes, ops, BF16_FLOPS)
                    old = OLD_K4_MS[(path, shape, k, n, stride)]
                    print(f"  {label} x{per_fwd}: {ms:.4f} ms "
                          f"({nbytes / ms / 1e6:.0f} GB/s; bf16 weights "
                          f"{ms_bf16:.4f}; events {ems:.4f}, wmma design "
                          f"{old:.4f}), plain "
                          f"{pms:.4f}, torch.matmul {lms:.4f}, bound "
                          f"{bms:.4f} ({by}); "
                          f"{plan_str(*bench_gemm.gemm_shape(shape, k, n, stride))}",
                          flush=True)
        # every flag, at a large-M small-K shape, small-M split-K ones (at
        # whole and ragged K) and a ragged one, both weight layouts, f32 and
        # bf16 x
        variants = [
            dict(nonneg=False, x_f32=True, out_dtype=torch.float32,
                 bias=False, act=None, w="u8", layout="kn"),
            dict(quantize_x=False, x_f32=False, out_dtype=torch.bfloat16,
                 bias=True, act="relu", w="bf16", layout="nk"),
            dict(nonneg=False, x_f32=False, out_dtype=torch.float32,
                 bias=True, act="relu", w="bf16", layout="kn"),
            dict(nonneg=True, x_f32=True, out_dtype=torch.bfloat16,
                 bias=False, act=None, w="u8", layout="nk"),
        ]
        for m, k, n in ((B * 54 * 54, 16, 64), (B, 4096, 4096),
                        (B, 4104, 1000), (1000, 136, 72)):
            for v in variants:
                v = dict(v)
                x = randn(m, k, scale=1.5)
                if v.get("nonneg"):
                    x = x.abs()
                if not v.pop("x_f32"):
                    x = x.to(torch.bfloat16)
                if v.get("quantize_x") is False:
                    x = k1.act_quantize_plain(x, 1.0 / ka4, nonneg=False)
                wq = sfp.quantize_weight(randn(k, n, scale=4.0), 8)
                w = sfp.pack_slfp34(wq) if v.pop("w") == "u8" \
                    else wq.to(torch.bfloat16)
                if v.pop("layout") == "nk":
                    w = w.t().contiguous().t()
                bias = randn(n, scale=0.1) if v.pop("bias") else None
                k4_case(x, w, bias, 1, f"K4 flags M={m} K={k} N={n} {v} "
                        f"{x.dtype} {w.dtype}", **v)

    # ------------------------------------------------------------------ K5
    def k5_forms(x, w, s, t, r):
        """(label, x, w, kwargs) of the three forms checked at each shape:
        the serving form, f32 out without ReLU, and the quantize with
        nonneg_in and no ReLU (on non-negative inputs and taps)."""
        return [("serve", x, w, dict(relu=True, quant_out_recip=r)),
                ("serve f32", x, w, dict(relu=True, quant_out_recip=r,
                                         out_dtype=torch.float32)),
                ("f32", x, w, dict(relu=False, out_dtype=torch.float32)),
                ("nonneg_in", x.abs(), w.abs(),
                 dict(relu=False, nonneg_in=True, quant_out_recip=r))]

    def k5_inputs(shape):
        c = shape[-1]
        x = randn(*shape, scale=2.0).to(torch.bfloat16)
        w = randn(3, 3, c, scale=0.5)
        s = torch.rand(c, device=dev, generator=gen) + 0.5
        t = randn(c, scale=0.1)
        return x, w, s, t

    def k5_subnormal_tap(w):
        """w with one tap subnormal: the wrapper takes the exact route."""
        w = w.clone()
        w[0, 0, 0] = 1e-40
        return w

    def k5_check(shape, r):
        """The three forms on the FTZ route, and the serving form on the
        exact route (one subnormal tap), each bit-equal to the plain
        version."""
        x, w, s, t = k5_inputs(shape)
        forms = [(label, xx, ww, kw, True)
                 for label, xx, ww, kw in k5_forms(x, w, s, t, r)]
        forms.append(("serve, exact route", x, k5_subnormal_tap(w),
                      dict(relu=True, quant_out_recip=r), False))
        for label, xx, ww, kw, ftz in forms:
            before = k5.dw3x3.ftz_launches
            got = k5.dw3x3(xx, ww, scale=s, shift=t, **kw)
            assert k5.dw3x3.ftz_launches - before == int(ftz), label
            want = k5.dw3x3_plain(xx, ww, s, t, **kw)
            torch.cuda.synchronize()
            assert same_bits(got, want), f"K5 {label} {shape} not bit-equal"
            rows["k5"].err((got.float() - want.float()).abs().max())
        return x, w, s, t

    @phase("K5 dw3x3")
    def k5_phase():
        r = rc[2]
        cases = [("mobilenetv1_fused", shape, n) for shape, n in
                 mn_k5_sites["mobilenetv1_fused"].items()]
        cases += [("mobilenetv1_fused_b256", (256,) + shape[1:], n)
                  for _, shape, n in cases]
        cases += [("mobilenet_fused", shape, n) for shape, n in
                  mn_k5_sites["mobilenet_fused"].items()]
        for path, shape, per_fwd in cases:
            x, w, s, t = k5_check(shape, r)
            c = shape[-1]
            # device time (profiler): events around these few-us kernels
            # would time the wrapper's host work
            # each route as the executor passes it, decided once, in the
            # form it serves: f32 out, the pointwise matmul's operand
            assert k5.ftz_route(w, s, t, r)
            kw = dict(relu=True, quant_out_recip=r, out_dtype=torch.float32)
            ms = kernel_ms(lambda: k5.dw3x3(x, w, scale=s, shift=t, ftz=True,
                                            **kw))
            ems = median_ms(lambda: k5.dw3x3(x, w, scale=s, shift=t,
                                             ftz=True, **kw))
            bf16_ms = kernel_ms(lambda: k5.dw3x3(
                x, w, scale=s, shift=t, relu=True, quant_out_recip=r,
                ftz=True))
            w_sub = k5_subnormal_tap(w)
            exact_ms = kernel_ms(lambda: k5.dw3x3(
                x, w_sub, scale=s, shift=t, ftz=False, **kw))
            pms = median_ms(lambda: k5.dw3x3_plain(x, w, s, t, **kw),
                            iters=5, inner=1)
            # the library call: cuDNN's grouped conv alone, on the same
            # bf16 operands (NCHW views of channels-last memory)
            xn = x.permute(0, 3, 1, 2)
            wn = w.permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            lms = kernel_ms(lambda: F.conv2d(xn, wn, padding=1, groups=c))
            # the route it replaces (dw="torch"): f32 grouped conv of the
            # bf16 values, then K3 writing f32, under the executor's flags
            conv = ConvKxK(w=wn.float(), scale=s, shift=t, stride=1, pad=1,
                           groups=c)
            with backend_flags():
                chain = kernel_ms(lambda: k3.bn_epilogue(
                    _conv_f32(x, conv), s, t, relu=True, emit_raw=False,
                    quant_recip=r, q_dtype=torch.float32, ftz=True))
            n = x.numel()
            nbytes = n * (2 + 4) + 9 * c * 4 + 2 * c * 4
            ops = n * (DW_OPS + K3_OPS)
            bms, by = bound_ms(nbytes, ops, F32_OPS)
            if not path.endswith("_b256"):
                rows["k5"].add(per_fwd, ms, pms, nbytes, ops, F32_OPS, lms,
                               path=path)
            print(f"  K5 {path} {shape} x{per_fwd}: {ms:.4f} ms "
                  f"({nbytes / ms / 1e6:.0f} GB/s; events {ems:.4f}; bf16 "
                  f"out {bf16_ms:.4f}; exact route {exact_ms:.4f}, plan "
                  f"{tuple(k5.plan(*shape[1:]))}), "
                  f"plain {pms:.4f}, "
                  f"F.conv2d(groups=C) {lms:.4f}, grouped conv + K3 "
                  f"{chain:.4f} (A/B speedup {chain / ms:.3f}), bound "
                  f"{bms:.4f} ({by})", flush=True)
        # H and W that split into uneven tiles and bands; C not a multiple
        # of 8 and not of 4 (the scalar path); f32 input; one pixel
        for shape in ((3, 13, 11, 40), (2, 13, 11, 36), (2, 13, 11, 30),
                      (2, 37, 19, 64), (4, 1, 1, 64)):
            k5_check(shape, r)
        x, w, s, t = k5_inputs((2, 9, 10, 24))
        x = x.float()
        x[0, :, :, 1], x[1, :, :, 2] = 3e-39, -5e-40   # flushed by K5
        for ww in (w, k5_subnormal_tap(w)):
            assert same_bits(k5.dw3x3(x, ww, scale=s, shift=t, relu=True),
                             k5.dw3x3_plain(x, ww, s, t, relu=True)), \
                "K5 f32 x"

    # ------------------------------------------------------------------ K6
    def k6_sites():
        """(label, (N, H, W, C, M), recips, emit_raw, emit_q, launches per
        forward) of K6 on the chain path at batch B: stage 2's blocks 1-4
        (raw and q) and 5 (q only, the next stage's input), stage 3's block
        1 (raw and q) and 2 (raw only, the head's input); stage 1's shape,
        which the kernel takes and the path does not run."""
        out = []
        for s_idx, (hw_, c, m, blocks, base) in enumerate(
                [(28, 512, 128, 4, 11), (14, 1024, 256, 6, 24),
                 (7, 2048, 512, 3, 43)], start=1):
            for b in range(1, blocks):
                sid = base + 3 * b
                last = b == blocks - 1
                qn = (None if s_idx == 3 else [24, 43][s_idx - 1] + 1) \
                    if last else sid + 4
                key = (f"stage{s_idx}_" + ("end" if last and qn else
                                            "last" if last else "mid"))
                rec = dict(recip2=rc[sid + 2], recip3=rc[sid + 3],
                           recip_next=rc[qn] if qn is not None else 1.0)
                per_fwd = 0 if s_idx == 1 else 1
                if out and out[-1][0] == key:   # same site, one more block
                    out[-1] = out[-1][:5] + (out[-1][5] + per_fwd,)
                    continue
                out.append((key, (B, hw_, hw_, c, m), rec,
                            not (last and qn is not None), qn is not None,
                            per_fwd))
        assert sum(s[-1] for s in out) == 7, out
        return out

    def k6_exact(n, h, w, c, m, recips):
        """Exact inputs: every sum is exact in float32, so K6 and the plain
        version must give the same bits whatever their summation order.
        Inputs are quantizer values up to 4; weights are +-1 or +-0.5 on
        about 24 inputs of each output, 0 elsewhere, so partial sums stay
        small on a 2**-11 grid; each affine scales by a power of two chosen
        from the data so that the scaled quantizer inputs spread about 4 by
        sigma 0.4, and shifts by 4 / recip on a 2**-4 grid (or by -40, which
        zeroes a channel); the identity is below 1 / recip_next.  Asserts
        that no scaled quantizer input lies in the pseudo-zero band (0,
        0.0625), whose 1e-10 is off the grid."""
        vals = emitted[(emitted >= 0.125) & (emitted <= 4)]

        def u(*s):
            return torch.rand(*s, device=dev, generator=gen)

        def pick(v, *s):
            return v[torch.randint(len(v), s, device=dev, generator=gen)]

        def sign(*s):
            return torch.where(u(*s) < 0.5, -1.0, 1.0)

        def wv(k, *s):
            return (torch.where(u(*s) < 0.5, 0.5, 1.0) * sign(*s)
                    * (u(*s) < 24.0 / k)).double()

        def affine(y, r, k):
            """(scale, shift) of an affine for the sums y ahead of the
            quantize by 1/r."""
            a = torch.full((k,), 2.0 ** math.floor(math.log2(
                0.4 / (r * float(y.std()) + 1e-30))), device=dev)
            b = torch.where(u(k) < 0.2, -40.0, round(4 / r * 16) / 16)
            return a, b

        def check_q(v, r):
            s = v.float() * np.float32(r)
            assert bool(((s == 0) | (s >= 0.0625)).all()), "band not empty"
            return k6.chain_quantize(v.float(), r).double()
        r2, r3, rn = (recips["recip2"], recips["recip3"],
                      recips["recip_next"])
        xq = pick(vals, n, h, w, c).double()
        w1, w2, w3 = wv(c, c, m), wv(9 * m, 3, 3, m, m), wv(m, m, c)
        y1 = xq.reshape(-1, c) @ w1
        a1, b1 = affine(y1, r2, m)
        y1p = F.pad(check_q(torch.clamp(y1 * a1 + b1, min=0), r2).reshape(
            n, h, w, m), (0, 0, 1, 1, 1, 1))
        y2 = sum(y1p[:, i:i + h, j:j + w, :].reshape(-1, m) @ w2[i, j]
                 for i in range(3) for j in range(3))
        a2, b2 = affine(y2, r3, m)
        y3 = check_q(torch.clamp(y2 * a2 + b2, min=0), r3) @ w3
        a3, b3 = affine(y3, rn, c)
        idn = pick(vals[vals <= 2], n, h, w, c) * sign(n, h, w, c) \
            * 2.0 ** math.floor(math.log2(0.5 / rn))
        check_q(torch.clamp(y3 * a3 + b3 + idn.reshape(-1, c), min=0), rn)
        bf = [t.to(torch.bfloat16) for t in (xq, idn, w1, w2, w3)]
        return (*bf, a1, b1.float(), a2, b2.float(), a3, b3.float())

    def k6_random(n, h, w, c, m):
        xq = k6.chain_quantize(randn(n, h, w, c, scale=3.0).abs(), 1.0)
        idn = randn(n, h, w, c, scale=2.0).to(torch.bfloat16)

        def wq(*s):
            return sfp.quantize_weight(randn(*s, scale=4.0), 8).to(
                torch.bfloat16)

        def aff(k):
            return (torch.rand(k, device=dev, generator=gen) * 0.02 + 1e-3,
                    randn(k, scale=0.5))
        return (xq, idn, wq(c, m), wq(3, 3, m, m), wq(m, c), *aff(m),
                *aff(m), *aff(c))

    def steps_apart(g, w):
        gi = torch.searchsorted(emitted, g.float().abs().contiguous()) \
            * torch.sign(g.float())
        wi = torch.searchsorted(emitted, w.float().abs().contiguous()) \
            * torch.sign(w.float())
        return (gi - wi).abs()

    @phase("K6 bottleneck_chain")
    def k6_phase():
        # exact inputs at narrow widths and odd shapes, bands of each kind
        # the plan makes (two 64-row tiles a GEMM with a ragged last band:
        # 13 rows in 7 + 6; 3-row bands split over pairs of blocks; whole
        # 7x7 images on a two-stage ring, stage 3 at batch 256), then at
        # every site of the path (and stage 1): bit-equal, both outputs
        rec0 = dict(recip2=rc[26], recip3=rc[27], recip_next=rc[28])
        narrow = [((1, 7, 7, 64, 16), True), ((2, 5, 6, 64, 16), False),
                  ((3, 7, 7, 64, 16), True), ((2, 14, 14, 64, 32), True),
                  ((2, 9, 11, 48, 48), True), ((64, 13, 13, 256, 64), True),
                  ((16, 10, 10, 512, 128), False),
                  ((256, 7, 7, 2048, 512), True)]
        narrow = [(shape, er, rec0) for shape, er in narrow]
        narrow += [(shape, er, rec) for _, shape, rec, er, _, _ in k6_sites()]
        # the exact route (one subnormal a3 element) at three of them
        narrow = [(shape, er, rec, False) for shape, er, rec in narrow] + [
            (shape, er, rec, True) for shape, er, rec in
            (narrow[4], narrow[5], narrow[-3])]
        for (n, h, w, c, m), er, rec, sub in narrow:
            args = list(k6_exact(n, h, w, c, m, rec))
            if sub:
                args[9] = args[9].clone()
                args[9][0] = 1e-40
            before = k6.bottleneck_chain.ftz_launches
            got = k6.bottleneck_chain(*args, **rec, emit_raw=er)
            assert k6.bottleneck_chain.ftz_launches - before == int(not sub)
            want = k6.bottleneck_chain_plain(*args, **rec, emit_raw=er)
            torch.cuda.synchronize()
            for g, w_ in zip(got, want):
                assert (g is None) == (w_ is None)
                if g is not None:
                    assert same_bits(g, w_), \
                        f"K6 exact {(n, h, w, c, m)} (subnormal a3: " \
                        f"{sub}) not bit-equal"
            assert len(got[1].unique()) > 8     # many quantizer bins
        print(f"  K6 exact inputs: bit-equal at {len(narrow)} shapes and "
              f"routes",
              flush=True)
        # random inputs at every site: the sums run in another order than
        # the plain version's, so a y1 or y2 value near a bin edge may flip
        # and move its pixel's conv3 sums by a step; held to raw cosine >
        # 0.99999 and q off by one step in <= 1% of elements, by more than
        # one in <= 0.1%
        for key, (n, h, w, c, m), rec, er, eq, per_fwd in k6_sites():
            args = k6_random(n, h, w, c, m)
            kw = dict(rec, emit_raw=er, emit_q=eq)
            got = k6.bottleneck_chain(*args, **kw)
            again = k6.bottleneck_chain(*args, **kw)
            want = k6.bottleneck_chain_plain(*args, **kw)
            torch.cuda.synchronize()
            msg = []
            for name, g, a, w_ in zip(("raw", "q"), got, again, want):
                if g is None:
                    continue
                assert same_bits(g, a), f"K6 {key} {name}: not deterministic"
                gf, wf = g.float(), w_.float()
                err = float((gf - wf).abs().max())
                rows["k6"].err(err)
                if name == "raw":
                    cs = float((gf * wf).sum() / gf.norm() / wf.norm())
                    msg.append(f"raw cos {cs:.7f} max err {err}")
                    assert cs > 0.99999, (key, cs)
                else:
                    st = steps_apart(g, w_)
                    one = float((st == 1).float().mean())
                    more = float((st > 1).float().mean())
                    msg.append(f"q off by 1 step {one:.2e}, by more "
                               f"{more:.2e}")
                    assert one <= 1e-2 and more <= 1e-3, (key, one, more)
            # the route as the executor passes it, decided once
            ftz = k6.ftz_route(args[5:], tuple(rec.values()))
            assert ftz
            call = (lambda: k6.bottleneck_chain(*args, **kw, ftz=ftz))
            ms = median_ms(call)
            pms = median_ms(lambda: k6.bottleneck_chain_plain(*args, **kw),
                            iters=5, inner=1)
            npx = n * h * w
            nbytes = (npx * c * 2 * (2 + int(er) + int(eq))
                      + 2 * (2 * c * m + 9 * m * m) + 8 * (2 * m + c))
            ops = 2 * npx * (2 * c * m + 9 * m * m)
            # the route K6 replaces at this site, as the chain-off
            # executor runs it: K2 conv1 (quantized input, writing the f32
            # operand), cuDNN 3x3, K3, K2 conv3
            xq, idn, w1, w2, w3, a1, b1, a2, b2, a3, b3 = args
            conv2 = ConvKxK(w=w2.permute(3, 2, 0, 1).float().contiguous(
                memory_format=torch.channels_last), scale=a2, shift=b2,
                stride=1, pad=1)

            def route():
                y1q = k2.qmm_fused(xq.reshape(-1, c), w1, a1, b1, relu=True,
                                   quant_out_recip=rec["recip2"],
                                   out_dtype=torch.float32)
                _, y2q = k3.bn_epilogue(
                    _conv_f32(y1q.reshape(n, h, w, m), conv2), a2, b2,
                    relu=True, emit_raw=False, quant_recip=rec["recip3"])
                return k2.qmm_fused(
                    y2q.reshape(-1, m), w3, a3, b3, relu=True,
                    residual=idn.reshape(-1, c),
                    quant_out_recip=None if er else rec["recip_next"])
            with backend_flags():
                rms = median_ms(route)
            bms, by = bound_ms(nbytes, ops, BF16_FLOPS)
            if per_fwd:
                rows["k6"].add(per_fwd, ms, pms, nbytes, ops, BF16_FLOPS,
                               path="resnet_chain")
            print(f"  K6 {key} {(n, h, w, c, m)} x{per_fwd} (plan "
                  f"{tuple(k6._plan(n, h, w, c, m))}): {ms:.4f} ms "
                  f"({ops / ms / 1e9:.1f} TFLOP/s), plain {pms:.4f}, route "
                  f"it replaces (K2 + cuDNN + K3 + K2) {rms:.4f} (A/B "
                  f"speedup {rms / ms:.3f}), bound {bms:.4f} ({by}); "
                  + "; ".join(msg), flush=True)
        # stage 0 does not fit the kernel: the wrapper says so
        try:
            k6.bottleneck_chain(*k6_random(2, 56, 56, 256, 64), **rec0)
        except ValueError as e:
            print(f"  K6 stage 0: {e}", flush=True)
        else:
            raise AssertionError("K6 took stage 0's shape")

    # ---------------------------------------------------------------- paths
    def cos(a, b):
        a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

    def same_top1(a, b):
        return bool((np.argmax(a, -1) == np.argmax(b, -1)).all())

    rng = np.random.default_rng(0)
    requests = [rng.standard_normal((n, 224, 224, 3)).astype(np.float32)
                for n in (64, 64, 17)]
    fwd = len(requests)                       # one forward per request

    def serve(eng, path, want, reqs=requests, classes=1000):
        """The path's run: counts reset just before the three requests and
        read just after; ``want`` maps wrapper -> launches per forward, every
        other wrapper must stay at 0."""
        eng.predict(reqs[0][:1])              # warm-up: cuDNN plans
        torch.cuda.synchronize()
        kernels.reset_launches()
        logits = [eng.predict(r) for r in reqs]
        torch.cuda.synchronize()
        counts = kernels.launches()
        print(f"  {path}: launches over {fwd} requests: {counts}", flush=True)
        for name, n in counts.items():
            assert n == fwd * want.get(name, 0), (name, counts, want)
        for key, name in (("k1", "act_quantize"), ("k2", "qmm_fused"),
                          ("k3", "bn_epilogue"), ("k4", "fused_quant_matmul"),
                          ("k5", "dw3x3"), ("k6", "bottleneck_chain")):
            # a kernel's row keeps the paths it was timed on (and its main
            # one); the counts of every path are asserted above
            if want.get(name) and (path in rows[key].paths
                                   or path == rows[key].main):
                rows[key].counted(path, counts[name], fwd)
        for r, lg in zip(reqs, logits):
            assert lg.shape == (r.shape[0], classes) and np.isfinite(lg).all()
        print(f"  logits[0, :4] = {logits[0][0, :4]}, top-1 of request 3: "
              f"{np.argmax(logits[2], -1)[:8]}", flush=True)
        return logits

    @phase("path: InferenceEngine resnet SLFP8 fused executor, chain off")
    def slice_phase():
        # K6 off: JAX's default placement, every bottleneck through K2,
        # cuDNN and K3 (the port's default runs K6: chain_phase)
        t0 = time.perf_counter()
        eng = InferenceEngine("resnet", qbit=8, batch_size=B, image_size=224,
                              seed=0, policy=NO_CHAIN)
        print(f"  engine built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        assert eng.fused
        logits = serve(eng, "resnet_fused", {
            "act_quantize": 3, "qmm_fused": 32, "bn_epilogue": 21})

        t0 = time.perf_counter()
        cpu = InferenceEngine("resnet", qbit=8, batch_size=2, image_size=224,
                              seed=0, device="cpu", policy=NO_CHAIN)
        got = cpu.predict(requests[0][:2])
        c = cos(got, logits[0][:2])
        print(f"  CPU plain path on 2 images: cos {c:.6f}, top-1 "
              f"{np.argmax(got, -1)} vs {np.argmax(logits[0][:2], -1)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        assert c > 0.995
        assert same_top1(got, logits[0][:2])

        packed = InferenceEngine("resnet", qbit=8, batch_size=B,
                                 image_size=224, seed=0, pack_weights=True,
                                 policy=NO_CHAIN)
        lp = packed.predict(requests[0])
        assert np.array_equal(lp.view(np.int32), logits[0].view(np.int32)), \
            "packed logits differ from float-frozen"
        print("  packed uint8 weights: logits bit-equal", flush=True)

        eng3 = InferenceEngine("resnet", qbit=8, batch_size=B,
                               image_size=224, seed=0,
                               policy={"conv3": "torch", **NO_CHAIN})
        eng3.predict(requests[0][:1])
        kernels.reset_launches()
        l3 = eng3.predict(requests[0])
        counts3 = kernels.launches()
        assert counts3["bn_epilogue_dual"] == 12, counts3
        assert counts3["qmm_fused"] == 16, counts3
        c3 = cos(l3, logits[0])
        print(f"  policy conv3=torch: {counts3}, cos {c3:.6f}", flush=True)
        assert c3 > 0.995
        assert same_top1(l3, logits[0])

        fp32 = InferenceEngine("resnet", qbit=32, batch_size=B,
                               image_size=224, seed=0, compute_dtype=None)
        lf = fp32.predict(requests[0][:8])
        assert np.isfinite(lf).all()
        tp = {}
        for bs in (64, 256):
            x = torch.from_numpy(rng.standard_normal(
                (bs, 224, 224, 3)).astype(np.float32)).to(dev)
            tp[f"slfp8_b{bs}"] = throughput(lambda: eng.forward(x), bs)
            tp[f"fp32_b{bs}"] = throughput(lambda: fp32.forward(x), bs)
        for key, val in tp.items():
            print(f"  throughput {key}: {val:.1f} images/s", flush=True)
        print(f"  SLFP8 / fp32: b64 {tp['slfp8_b64'] / tp['fp32_b64']:.3f}, "
              f"b256 {tp['slfp8_b256'] / tp['fp32_b256']:.3f}", flush=True)
        return eng, logits[0]

    @phase("path: InferenceEngine resnet SLFP8 fused executor, default "
           "policy: chain={2,3} (K6)")
    def chain_phase(fused_eng, fused_logits):
        eng = InferenceEngine("resnet", qbit=8, batch_size=B, image_size=224,
                              seed=0)
        logits = serve(eng, "resnet_chain", {
            "act_quantize": 5, "qmm_fused": 18, "bn_epilogue": 14,
            "bottleneck_chain": 7})
        c = cos(logits[0], fused_logits)
        print(f"  against chain off: cos {c:.6f}", flush=True)
        assert c > 0.995
        assert same_top1(logits[0], fused_logits)

        t0 = time.perf_counter()
        cpu = InferenceEngine("resnet", qbit=8, batch_size=2, image_size=224,
                              seed=0, device="cpu")
        got = cpu.predict(requests[0][:2])
        c = cos(got, logits[0][:2])
        print(f"  CPU plain path on 2 images: cos {c:.6f}, top-1 "
              f"{np.argmax(got, -1)} vs {np.argmax(logits[0][:2], -1)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        assert c > 0.995
        assert same_top1(got, logits[0][:2])

        packed = InferenceEngine("resnet", qbit=8, batch_size=B,
                                 image_size=224, seed=0, pack_weights=True)
        lp = packed.predict(requests[0])
        assert np.array_equal(lp.view(np.int32), logits[0].view(np.int32)), \
            "packed logits differ from float-frozen under chain={2,3}"
        print("  packed uint8 weights: logits bit-equal", flush=True)
        del packed
        tp = {}
        for bs in (64, 256):
            x = torch.from_numpy(rng.standard_normal(
                (bs, 224, 224, 3)).astype(np.float32)).to(dev)
            # in turns: chain off, chain, chain, chain off
            d1 = throughput(lambda: fused_eng.forward(x), bs)
            c1 = throughput(lambda: eng.forward(x), bs)
            c2 = throughput(lambda: eng.forward(x), bs)
            d2 = throughput(lambda: fused_eng.forward(x), bs)
            tp[bs] = (c1, c2, d1, d2)
            print(f"  throughput b{bs}: chain={{2,3}} (default) {c1:.1f}, "
                  f"{c2:.1f}; chain off {d1:.1f}, {d2:.1f} images/s; chain "
                  f"/ off {(c1 + c2) / (d1 + d2):.3f}", flush=True)
        return eng

    def images_per_s(eng, label, batch=B):
        x = torch.from_numpy(rng.standard_normal(
            (batch, eng.image_size, eng.image_size, 3)).astype(
                np.float32)).to(dev)
        ips = throughput(lambda: eng.forward(x), batch)
        print(f"  throughput {label}_b{batch}: {ips:.1f} images/s",
              flush=True)
        return ips

    def module_path_phase(net, k4_per_fwd, k1_per_fwd):
        """SLFP8 on the module path with packed weights, K4 by the auto
        rule: the slice's main path for SqueezeNet 1.0 and AlexNet."""
        t0 = time.perf_counter()
        eng = InferenceEngine(net, qbit=8, batch_size=B, pack_weights=True,
                              use_pallas=None, seed=0)
        print(f"  engine built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        assert not eng.fused
        logits = serve(eng, net, {"fused_quant_matmul": k4_per_fwd,
                                  "act_quantize": k1_per_fwd})

        t0 = time.perf_counter()
        cpu = InferenceEngine(net, qbit=8, batch_size=2, pack_weights=True,
                              use_pallas=None, seed=0, device="cpu")
        got = cpu.predict(requests[0][:2])
        c = cos(got, logits[0][:2])
        print(f"  CPU plain path on 2 images: cos {c:.6f}, top-1 "
              f"{np.argmax(got, -1)} vs {np.argmax(logits[0][:2], -1)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        assert c > 0.995
        assert same_top1(got, logits[0][:2])

        frozen = InferenceEngine(net, qbit=8, batch_size=B, use_pallas=True,
                                 seed=0)
        lf = frozen.predict(requests[0])
        assert np.array_equal(lf.view(np.int32), logits[0].view(np.int32)), \
            "float-frozen logits (use_pallas=True) differ from packed"
        print("  float-frozen bf16 weights, use_pallas=True: logits "
              "bit-equal to packed", flush=True)
        del frozen

        plain = InferenceEngine(net, qbit=8, batch_size=B, pack_weights=True,
                                use_pallas=False, seed=0)
        kernels.reset_launches()
        lx = plain.predict(requests[0])
        assert kernels.launches()["fused_quant_matmul"] == 0
        cx = cos(lx, logits[0])
        print(f"  use_pallas=False against None: cos {cx:.6f}", flush=True)
        assert cx > 0.995
        assert same_top1(lx, logits[0])
        del plain

        fp32 = InferenceEngine(net, qbit=32, batch_size=B, seed=0,
                               compute_dtype=None)
        assert np.isfinite(fp32.predict(requests[0][:8])).all()
        tp8 = images_per_s(eng, f"{net}_slfp8_packed_k4")
        tp32 = images_per_s(fp32, f"{net}_fp32")
        print(f"  SLFP8 / fp32 b{B}: {tp8 / tp32:.3f}", flush=True)
        return eng

    @phase("path: InferenceEngine squeezenet SLFP8 module path (K4)")
    def squeezenet_phase():
        return module_path_phase("squeezenet", 17, 9)

    @phase("path: InferenceEngine alexnet SLFP8 module path (K4)")
    def alexnet_phase():
        module_path_phase("alexnet", 3, 5)

    @phase("path: InferenceEngine resnet SLFP8 module path, use_pallas=True")
    def resnet_module_phase(fused_logits):
        eng = InferenceEngine("resnet", qbit=8, batch_size=B,
                              pack_weights=True, use_pallas=True, seed=0)
        assert not eng.fused
        logits = serve(eng, "resnet_module", {"fused_quant_matmul": 37,
                                              "act_quantize": 17})
        c = cos(logits[0], fused_logits)
        print(f"  against the fused executor: cos {c:.6f}", flush=True)
        assert c > 0.995
        assert same_top1(logits[0], fused_logits)
        images_per_s(eng, "resnet_module_slfp8_packed_k4")

    # ------------------------------------------------------ MobileNetV1 paths
    cifar_requests = [rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
                      for n in (64, 64, 17)]

    def derived_scales(fp32, images):
        """Scales for random weights, the reference's recipe: absmax of each
        quantized layer's input and weight over one float32 forward of the
        same weights, divided by 15.5.  Forward hooks read them; the
        package's calibration is ROADMAP work."""
        from cnns_slfp_quantization_tpu_torch.ops.freeze import quant_layers

        ka, kw, hooks = {}, {}, []
        for _, layer in quant_layers(fp32.model):
            def hook(m, inp, out):
                i = m.layer_id
                ka[i] = max(ka.get(i, 0.0), float(inp[0].abs().max()))
                kw[i] = float(m.weight.abs().max())
            hooks.append(layer.register_forward_hook(hook))
        fp32.predict(images)
        for h in hooks:
            h.remove()
        n = max(ka) + 1
        assert sorted(ka) == list(range(n)), sorted(ka)
        return calib.ScaleSet(ka=np.array([ka[i] for i in range(n)]) / 15.5,
                              kw=np.array([kw[i] for i in range(n)]) / 15.5,
                              divisor=15.5, source="chip_smoke.py absmax")

    def mobilenet_fused_phase(net, path, want, reqs, classes):
        """The fused executor of ``net`` with derived scales: the path's
        run, the CPU, packed weights; returns (engine, scales, logits of
        request 0, the float32 engine)."""
        fp32 = InferenceEngine(net, qbit=32, batch_size=B, seed=0,
                               compute_dtype=None)
        assert np.isfinite(fp32.predict(reqs[0][:8])).all()
        sc = derived_scales(fp32, reqs[0])
        print(f"  derived scales: ka {np.round(sc.ka[:4], 4)}..., kw "
              f"{np.round(sc.kw[:4], 4)}...", flush=True)
        eng = InferenceEngine(net, qbit=8, batch_size=B, seed=0, scales=sc)
        assert eng.fused
        logits = serve(eng, path, want, reqs, classes)

        t0 = time.perf_counter()
        cpu = InferenceEngine(net, qbit=8, batch_size=2, seed=0, scales=sc,
                              device="cpu")
        got = cpu.predict(reqs[0][:2])
        c = cos(got, logits[0][:2])
        print(f"  CPU plain path on 2 images: cos {c:.6f}, top-1 "
              f"{np.argmax(got, -1)} vs {np.argmax(logits[0][:2], -1)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        assert c > 0.995
        assert same_top1(got, logits[0][:2])

        packed = InferenceEngine(net, qbit=8, batch_size=B, seed=0,
                                 scales=sc, pack_weights=True)
        lp = packed.predict(reqs[0])
        assert np.array_equal(lp.view(np.int32), logits[0].view(np.int32)), \
            "packed logits differ from float-frozen"
        print("  packed uint8 weights: logits bit-equal", flush=True)
        del packed
        return eng, sc, logits[0], fp32

    def throughputs(eng, fp32, label, batches):
        tp = {}
        for bs in batches:
            tp[f"slfp8_b{bs}"] = images_per_s(eng, f"{label}_slfp8", bs)
            tp[f"fp32_b{bs}"] = images_per_s(fp32, f"{label}_fp32", bs)
        print(f"  {label} SLFP8 / fp32: " + ", ".join(
            f"b{bs} {tp[f'slfp8_b{bs}'] / tp[f'fp32_b{bs}']:.3f}"
            for bs in batches), flush=True)

    @phase("path: InferenceEngine mobilenetv1 SLFP8 fused executor (K5)")
    def mobilenetv1_phase():
        eng, sc, logits, fp32 = mobilenet_fused_phase(
            "mobilenetv1", "mobilenetv1_fused",
            {"act_quantize": 1, "bn_epilogue": 18, "dw3x3": 9}, requests,
            1000)
        torch_route = InferenceEngine("mobilenetv1", qbit=8, batch_size=B,
                                      seed=0, scales=sc,
                                      policy={"dw": "torch"})
        torch_route.predict(requests[0][:1])
        kernels.reset_launches()
        lt = torch_route.predict(requests[0])
        counts = kernels.launches()
        assert (counts["bn_epilogue"], counts["dw3x3"]) == (27, 0), counts
        ct = cos(lt, logits)
        print(f"  policy dw=torch: {counts}, cos {ct:.6f}", flush=True)
        assert ct > 0.995
        assert same_top1(lt, logits)
        throughputs(eng, fp32, "mobilenetv1_fused", (64, 256))
        images_per_s(torch_route, "mobilenetv1_fused_dw_torch_slfp8")
        return eng, sc, logits, fp32, torch_route

    @phase("path: InferenceEngine mobilenet (CIFAR) SLFP8 fused executor")
    def mobilenet_cifar_phase():
        eng, _, _, fp32 = mobilenet_fused_phase(
            "mobilenet", "mobilenet_fused",
            {"act_quantize": 2, "bn_epilogue": 18, "dw3x3": 9},
            cifar_requests, 100)
        throughputs(eng, fp32, "mobilenet_fused", (64, 256))

    @phase("path: InferenceEngine mobilenetv1 SLFP8 module path (K4)")
    def mobilenetv1_module_phase(sc, fused_logits, fp32):
        eng = InferenceEngine("mobilenetv1", qbit=8, batch_size=B, seed=0,
                              scales=sc, pack_weights=True, use_pallas=None,
                              fused=False)
        assert not eng.fused
        logits = serve(eng, "mobilenetv1_module",
                       {"fused_quant_matmul": 13, "act_quantize": 14})
        got, want = logits[0], fused_logits
        c = cos(got, want)
        diff = np.abs(got - want).max()
        top2 = np.sort(want, axis=-1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > 3 * diff
        print(f"  against the fused executor: cos {c:.6f}, "
              f"{int(decisive.sum())} decisive rows", flush=True)
        assert c > 0.98
        assert (np.argmax(got, -1) == np.argmax(want, -1))[decisive].all()
        throughputs(eng, fp32, "mobilenetv1_module_packed_k4", (B,))

    def where_the_time_goes(eng, label):
        """Device time per forward at batch 64 by kernel, the idle share
        and the bf16 -> f32 copies, from torch.profiler
        (``profiling.print_forward_profile``)."""
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (B, 224, 224, 3)).astype(np.float32)).to(dev)
        print(f"  profile {label}:", flush=True)
        print_forward_profile(lambda: eng.forward(x), B)

    k1_phase()
    k2_phase()
    k3_phase()
    k4_phase()
    k5_phase()
    k6_phase()
    fused = slice_phase()
    ch = chain_phase(*fused) if fused is not None else None
    if fused is None:
        failures.append("chain path: no default logits to compare")
    sq = squeezenet_phase()
    alexnet_phase()
    if fused is not None:
        resnet_module_phase(fused[1])
    else:
        failures.append("resnet module path: no fused logits to compare")
    mn = mobilenetv1_phase()
    mobilenet_cifar_phase()
    if mn is not None:
        mobilenetv1_module_phase(*mn[1:4])
    else:
        failures.append("mobilenetv1 module path: no fused logits to compare")
    for eng, label in ((fused and fused[0], "resnet fused, chain off"),
                       (ch, "resnet fused, default: chain={2,3}"),
                       (sq, "squeezenet module path"),
                       (mn and mn[0], "mobilenetv1 fused"),
                       (mn and mn[4], "mobilenetv1 fused, dw=torch")):
        if eng is None:
            continue
        try:
            where_the_time_goes(eng, label)
        except Exception:  # a measurement; the checks above decide success
            print(f"  profiler failed (not measured):\n"
                  f"{traceback.format_exc()}", flush=True)
    for r in rows.values():
        for path, d in r.paths.items():
            if d["launches"] == 0:
                failures.append(f"{r.head['name']} never launched on the "
                                f"{path} path")
    if failures:
        print(f"chip_smoke: FAILED: {failures}", file=sys.stderr, flush=True)
        return 1
    print(card)  # name, power limit: as nvidia-smi prints them
    print(json.dumps({"kernels": [r.out() for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
