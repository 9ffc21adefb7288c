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
   route's, which are event times.  K7 (QSGD's update) must be bit-equal
   to its plain version on ResNet-50's 161 parameter tensors (bin-edge
   weights, subnormal and -0.0 gradients) under DSGD at qbit 8, 7 and 32,
   with nesterov and dampening, without momentum or weight decay, SSGD and
   SGD, in two launches, its counts equal; it is timed as a CUDA graph of
   its calls beside its bytes bound.  Every QAT step below launches K7
   once (83 or 52 parameter tensors).
3. Paths, each with the launch counts reset just before it and read just
   after it, over requests of 64, 64 and 17 images (one of 64 in the zoo).
   The engine serves through one CUDA graph: the path's first request
   captures it, so the wrappers count the capture's eager lead-in and its
   recording (twice a forward's launches) and the replays launch without
   Python.  On every served path the engine's graph is then held against
   its eager forward (its private ``_eager``): ``predict`` on a request and
   on one longer than the batch (its last chunk padded) bit-equal through
   both, ``forward(x1)`` then ``forward(x2)`` leaving the first result as
   it was, the hand kernels of a replay (counted by name in the trace,
   ``profiling.busy_ms``) those an eager forward's wrappers count, and
   ``throughput()`` against the eager forward timed the same way, in turns
   (graph, eager, eager, graph), each with its idle share and its kernel
   time by class; a summary line per path is printed at the end.
   - ResNet-50 fused executor with K6 off, ``InferenceEngine("resnet",
     qbit=8, policy={"chain": frozenset()})``, JAX's default placement (K1
     3, K2 32, K3 21 per forward); then the same weights on the CPU
     (cosine > 0.995, same top-1), packed uint8 weights (bit-equal logits),
     ``policy={"conv3": "torch"}`` (K3 dual 12 times per forward, counted
     on the eager forward; its graph checked as above);
   - ResNet-50 fused executor under the default policy,
     ``InferenceEngine("resnet", qbit=8)``, which runs stages 2 and 3's
     stride-1 bottlenecks on K6 (K1 5, K2 18, K3 14, K6 7 per forward),
     held against chain off's logits and the CPU's (cosine > 0.995, same
     top-1), packed weights (bit-equal logits), images/s at batch 64 in
     turns with chain off;
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
   - ShuffleNetV2 (ratio 1, CIFAR 32x32) through the fused executor,
     ``InferenceEngine("shufflenetv2", qbit=8)`` (K1 35, K3 20 per
     forward), scales derived as for MobileNetV1; then the CPU, packed
     weights (bit-equal logits), images/s at batch 64 and 256, and the
     launches and device ms of its affine -> SFP<4,4> -> ReLU posts, which
     run as plain PyTorch ops; its packed module path (K4 37, K1 20; K4's
     operands padded to multiples of 8 at the 58- and 116-channel
     layers), held against the fused logits by JAX's bar; a
     reference-layout ``.pth`` of a ShuffleNetV2, served (K1 35, K3 20)
     with logits bit-equal to an engine whose model was loaded with the
     same weights directly;
   - ResNet-50 at qbit 7 on the module path (K1 54 per forward, its qbit-7
     forms), against the CPU;
   - every other path the engine serves, through its graph against its
     eager forward as above: ResNet-50 under ``policy={"conv1":
     "torch"}``, CIFAR MobileNetV1 under ``policy={"dw": "torch"}``, the
     float-frozen module path of every net of the registry, and the packed
     one of CIFAR MobileNet, ``mobilenet_swish`` and
     ``shufflenetv2_swish``, shipped scales;
   - ShuffleNet V2 1.0x in its published ImageNet form (224x224, 1000
     classes), ``InferenceEngine("imgnet/shufflenetv2", qbit=8)``, shipped
     scales, through its graph against its eager forward as above (K1 35,
     K3 20 a forward; its stem K3 with ReLU and ``max_pool2d``), and its
     five device phases (``shufflenet.stem``, ``.stage2``-``.stage4``,
     ``.head``) read from recorded replays: each once a request, their sum
     within the replay's device time;
   - the zoo, one request of 64 each: VGG16 and VGG16-GELU at 32x32
     (K4 3, K1 13), the ResNet-50 STL / Swish variants at 224x224 (K4 37,
     K1 17), packed with derived scales, and InceptionV3 (float32 only);
     each float32 and SLFP8 path against the CPU, and the STL / Swish
     variants' blocks on the card against the CPU, each fed the same
     input (their random-init quantized logits spread any summation-order
     difference, so a block shows a fault the logits could hide);
   K1, K3 and K4 at every site of the new paths (recorded from one forward
   of the path, the calls adding up to the launches the path counts, then
   held against their plain versions and timed; K4's copies of x into
   padded channels timed apart), and
   images/s at batch 64 of each (``throughput()``, the engine's graph)
   against the unquantized float32 module path (``qbit=32,
   compute_dtype=None``).
   Then SLFP8 quantization-aware training of CIFAR ``mobilenet`` (full
   width, batch 256, bf16, DSGD), scales from one training-mode float32
   forward (absmax / 15.5):
   - route B, ``use_pallas=True``: K4 at the 13 pointwise convs and the
     FC with its STE backward, K1 at the other 14 inputs and in K4's
     backward (K4 14, K1 28 a step); every K1 / K4 call of a step held
     against its plain version and timed; K4's backward (dx, dw, db) at
     each site on the card against the same Function on the CPU, by K2's
     reordering rule and cosine > 0.9999; one DSGD step at batch 64 on
     the card against the CPU from the same weights and batch (loss within
     1e-3, each kernel's gradient cosine > 0.999, BatchNorm's > 0.95, BN
     running statistics within 1e-4 but for at most 1%);
   - 20 DSGD steps on 10 synthetic classes at unit scales: the last 5
     steps' mean loss below the first 5's;
   - the CIFAR driver, ``cifar100_train_eval.main``, route A (K1 only, 28
     a step or eval batch): train 8 steps, evaluate, save the best and the
     full state, reload the best (the same Precision@1), resume to epoch 2;
   - training images/s at batch 256 of routes A and B against the float32
     step in turns, route A's K1 sites held and timed, and each step's
     device time by phase (CUDA events) and kernel class (profiler);
   - the CUDA graphs (``train.loop.GraphedTrainStep``,
     ``utils/profiling.py::GraphedForward``): for routes A, B and float32
     at batch 256, 8 replays of the captured DSGD step on inputs perturbed
     per step give the losses, weights, momentum and BN running statistics
     of 8 eager steps from the same state bit for bit, with the launches a
     step counted at the capture (route A K1 28, route B K1 28 and K4 14);
     ``scan_train_throughput`` graph against eager in turns, two rounds,
     and each mode's idle share (``profiling.busy_ms``), the hand kernels
     in the trace of 3 replays 3x those of the capture (a graph path's
     launches); SqueezeNet 1.0's dropout step at 224, batch 32, captured
     with its generator registered: 4 replays give the eager steps'
     dropout outputs, losses, weights and momentum bit for bit, about
     half the nonzero inputs dropped, another mask each step; the fused
     CIFAR MobileNetV1 engine's graph at batch 256 (K1 2, K3 18, K5 9 a
     replay), checked as every served path is.
   Then the PTQ workflow:
   - calibrate -> serve: the float32 ResNet-50 (the engine's seed-0
     weights, ``capture="absmax"``, exact float32) over 256 images at
     224 on the card and on the CPU (weights and the image's maximum
     bit-equal, every other maximum within CAL_RTOL), the JSON written and
     the executor's ``ka[base] == ka[base+1]`` guard checked on it, then
     ``InferenceEngine("resnet", qbit=8, scales=...)`` on the fused
     executor (K1 5, K2 18, K3 14, K6 7 per forward) and on the module
     path (K1 54), cosine > 0.995 and the same top-1 between the two;
   - ``ptq_sweep`` on AlexNet at 224, qbits 32 8 7, bf16, 8 synthetic
     batches of 32: its JSON line, accuracies in [0, 100], K1 8 per
     quantized forward;
   - ``imgnet_train_eval --net resnet --Qbits 8 --compute_dtype bfloat16
     --synthetic``: two 100-image smoke evals, K1 54 per forward;
   - ``cifar100_train_eval`` from a CIFAR-100 written here in the
     published pickle layout (2,560 train, 1,000 test images, seed 0):
     ``--pre_reference`` writes its three files, then one ``--retrain``
     epoch at bf16 with ``--train_subset 0.06`` (K1 28 per step and eval
     batch) on the native augmenter, which must build on the card's host;
   - ``recovery.run`` (mobilenet, qbit 8, 2,560 train images, batch 128,
     2 + 2 epochs, 512 eval images): its row, the subset's size, finite
     accuracies (float32 compute, as JAX's: no kernel);
   - the block-input levers of the ResNet-50 executor at batch 8, 224
     (``conv3="torch"``, K6 off, conv1 on K2 and as a plain matmul):
     ``pallas_dual`` bit-equal to ``consumer``, ``packed`` within 1e-2
     with the same top-1, ``producer`` cosine > 0.995; the consumer's 12
     extra K1 passes a forward against K3's 12 dual launches;
   - ``utils/bench_quant_sites.py``'s batch-64 cases (the default policy
     and JAX's placement): fused ResNet-50 with every quantize site, each
     site removed (``_diag_quant_sites``) and none, every configuration's
     logits finite, the production one bit-equal to the engine's forward,
     its launches and graph images/s printed; K2 at the 18 calls of the
     ceiling (raw f32 and bf16 outputs) against its plain version;
   - the measuring tools, in-process at a small size, the phase's seconds
     printed: ``utils/bench_roofline.py`` at batch 64 under the default
     policy (every row of the forward, K1 / K2 / K3 / K6 each launched by
     its wrapper: no row above its bound, the rows' launches per class
     those of one eager forward of the executor, counted with the counts
     reset just before it, which are the launches recorded; the aggregate
     beside the engine's per-batch time), ``bench_train_sites.py`` on
     CIFAR mobilenet at batch 256 (each variant's graph replay bit-equal
     to an eager step; the launches recorded are the prod variant's one
     eager step's), ``bench_packed_fused.py`` (the packed executor holds
     fewer weight bytes and gives the float one's logits bit for bit),
     ``bench_blockin.py`` (``pallas_dual`` bit-identical to
     ``consumer``), ``bench_shufflenet_fused.py``'s gate on the scales
     derived for its random weights, ``calibrate_act_variants.py`` on the
     STL variant for 2 steps into a temporary directory (the shipped
     JSON's keys and lengths) and one ``tune_task_signal.py`` probe.
   K1 and K3 at every site of these paths are held against their plain
   versions and timed as above.
4. A torch.profiler breakdown per eager forward of the ResNet-50 fused
   executor
   (default ``chain={2,3}``, chain off, and on the freshly calibrated
   constants), the MobileNetV1 fused executor
   (both ``dw`` routes), the ShuffleNetV2 fused executor and SqueezeNet
   1.0's module path, with the bf16 -> float32 copies that remain counted
   apart.

5. Determinism and the mesh (``parallel/``), after the paths:
   - two train steps of CIFAR mobilenet at batch 256 from one state, float32
     and route B, give the same bits (``ops/backend.py::exact_f32``: cuDNN's
     deterministic algorithms), and each step's time in 6 turns against the
     setting before the repair;
   - NCCL at world size 1, mesh 1x1: ``InferenceEngine("resnet", qbit=8,
     mesh=)`` gives, through its graph, logits bit-equal to the engine
     without it, and one route-B DSGD step through ``parallel.steps`` the
     plain step's bits, each at the unsharded launches;
   - gloo with 2 ranks sharing the card (NCCL refuses two ranks on one
     GPU), spawned after the kernels are built: fused ResNet-50 at batch
     64 on a 2x1 mesh (each rank's 32 rows, through its graph, bit-equal
     to an unsharded engine at batch 32) and a 1x2 mesh (cosine > 0.999
     and the same top-1, the hand kernels on gathered weights; eager, the
     engine's model-axis rule, as ``graphed`` says), K1 5, K2 18, K3 14,
     K6 7 a forward on each rank (a graphed engine's run counts its
     capture: twice that); fused CIFAR MobileNetV1 on 2x1 (K1 2, K3 18, K5
     9; rows bit-equal); SqueezeNet's packed module path on 1x2 (K4 17 on
     column shards, K1 9; cosine > 0.999 and the same top-1); one DSGD step of CIFAR mobilenet at batch 256 on
     2x1 and on 1x2 (K4 on column shards) against the single-rank step:
     float32 and route B, the first BN's statistics on 2x1 within 1e-5 of
     the single step's (a rank's own statistics are not); float32, the
     loss within 1e-5 (a rank's own BN statistics break it) and the
     weights outside rtol 2e-4 / atol 1e-6 no more than 4x those of a
     single step on reordered rows (a missing gradient reduction breaks
     it); route B, K4 14 and K1 28 a rank, the loss within 1e-2 (one
     quantized step is chaotic: bins flip under a sum in another order),
     with the readings that show why printed; DSGD's counters in
     (0, 3 x params]; a 3x3
     ``spatial_conv2d`` against ``F.conv2d``; ``cifar100_train_eval
     --mesh_data 2``; ``scaling_bench`` rows at 1 and 2 ranks; the fused
     MobileNetV1 (ImageNet, 224) and ShuffleNetV2 (CIFAR) engines at batch
     64 on a 1x2 mesh (out-channel shards; K1 1, K3 18, K5 9 and K1 35, K3
     20 a forward on each rank) against an unsharded engine, cosine >
     0.999 and the same top-1 (where the unsharded logits tie at their
     maximum, any of the tied classes).  Every rate of this
     phase is of ranks sharing one card.
   The K2 row also gets the calibrated engine's 18 calls a forward: device
   time, plain version, ``torch.matmul`` unfused and the bound.

The line before the last is one JSON object with, for each kernel, its
launches over the run of its first path (``launches``: the wrappers'
count; a served path's run captures the engine's graph, two forwards'
launches, and its replays run no wrapper) and per forward (a replay's, by
kernel name in the trace, equal to an eager forward's), and, per forward
at batch 64 on that path, its time, its plain
version's time, the matching PyTorch call's time where one exists, and its
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the card's peak for their type.  ``by_path`` gives the same
per path; a CUDA graph's path (``*_graph*``) counts its launches in the
profiler's trace of 3 replays, where the wrappers count none.  The last line is ``{"ok": true, "device": {...}}``.  Any failed
check exits non-zero first, and so does a run without a CUDA device or
outside the repository.
"""

from __future__ import annotations

import contextlib
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


class Row:
    """One kernel's JSON entry.  Per path, per-forward totals: the sum over
    the path's shapes of (value at that shape) x (launches of that shape per
    forward).  The top-level numbers are those of the kernel's first path,
    ``main``.  A path whose launches are only counted, never timed, keeps
    null times and bound."""

    def __init__(self, name, source, replaces, main):
        self.head = dict(name=name, route="cuda", source=source,
                         replaces=replaces)
        self.main = main
        self.paths = {}
        self.max_abs_err = 0.0

    def _path(self, path):
        return self.paths.setdefault(path or self.main, dict(
            launches=0, launches_per_forward=0, ms=None, plain_ms=None,
            bound_ms=None, bound_by=None, library_ms=None,
            t_bytes=0.0, t_ops=0.0))

    def add(self, per_fwd, ms, plain_ms, nbytes, ops, peak, lib_ms=None,
            path=None):
        from cnns_slfp_quantization_tpu_torch.utils.bench_roofline import (
            HBM_BYTES_PER_S, bound_ms)

        d = self._path(path)
        d["ms"] = (d["ms"] or 0.0) + per_fwd * ms
        d["plain_ms"] = (d["plain_ms"] or 0.0) + per_fwd * plain_ms
        d["t_bytes"] += per_fwd * nbytes / HBM_BYTES_PER_S
        d["t_ops"] += per_fwd * ops / peak
        d["bound_ms"] = ((d["bound_ms"] or 0.0)
                         + per_fwd * bound_ms(nbytes, ops, peak)[0])
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


# --------------------------------------------------------- mesh ranks
# The data- and tensor-parallel phases run in ranks spawned from main():
# gloo with two ranks sharing the one card (NCCL refuses two ranks on one
# GPU), each rank's results pickled for main() to check and report.  The
# functions sit at module level so that ``spawn`` can import them.

def _mesh_rank(rank, world, port, out, ka, kw, scales):
    sys.path.insert(0, str(REPO))
    import pickle

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    res = {}
    try:
        for task in (_mesh_resnet, _mesh_module, _mesh_mobilenet,
                     _mesh_fused_tp, _mesh_qat, _mesh_spatial, _mesh_cli,
                     _mesh_scaling):
            t0 = time.perf_counter()
            try:
                res[task.__name__] = task(ka=ka, kw=kw, scales=scales)
            except Exception:
                res[task.__name__] = {"error": traceback.format_exc()}
            res.setdefault("seconds", {})[task.__name__] = \
                time.perf_counter() - t0
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _counted_run(fn):
    """fn() with the launch counts reset just before and read just after.
    A graphed engine's first call inside it captures its graph: the
    wrappers count the capture's eager lead-in and its recording."""
    import torch

    from cnns_slfp_quantization_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launches()


def _mesh_resnet(**_):
    """Fused ResNet-50 at 224, batch 64 (default policy: K1, K2, K3, K6)
    on a 2x1 mesh (32 rows a rank) and a 1x2 mesh, against one unsharded
    engine at batch 32 on the same images."""
    from cnns_slfp_quantization_tpu_torch.parallel import make_mesh
    from cnns_slfp_quantization_tpu_torch.parallel import mesh as ml
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    x = np.random.default_rng(2).standard_normal((64, 224, 224, 3)).astype(
        np.float32)
    kw = dict(qbit=8, image_size=224, seed=0)
    one = InferenceEngine("resnet", batch_size=32, **kw)
    want = one.predict(x)
    res = {}
    for shape in ((2, 1), (1, 2)):
        mesh = make_mesh(*shape)
        eng = InferenceEngine("resnet", batch_size=64, mesh=mesh, **kw)
        got, counts = _counted_run(lambda: eng.predict(x))
        i = ml.axis_rank(mesh, "data")
        res[shape] = {"got": got, "counts": counts, "i": i,
                      "graphed": eng.graphed,
                      "ips": eng.throughput(iters=8)}
    res["want"] = want
    return res


def _mesh_module(**_):
    """SqueezeNet 1.0 on the module path (packed weights, K4 on the 1x1
    convs' column shards, K1) on a 1x2 mesh at 224, batch 64, against an
    unsharded engine on the same images."""
    from cnns_slfp_quantization_tpu_torch.parallel import make_mesh
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    x = np.random.default_rng(4).standard_normal((64, 224, 224, 3)).astype(
        np.float32)
    kw = dict(qbit=8, batch_size=64, pack_weights=True, use_pallas=None,
              seed=0)
    want = InferenceEngine("squeezenet", **kw).predict(x)
    eng = InferenceEngine("squeezenet", mesh=make_mesh(1, 2), **kw)
    got, counts = _counted_run(lambda: eng.predict(x))
    return {"got": got, "want": want, "counts": counts,
            "graphed": eng.graphed}


def _mesh_mobilenet(**_):
    """Fused CIFAR MobileNetV1 (K1, K3, K5) at batch 64 on a 2x1 mesh
    against an unsharded engine at batch 32."""
    from cnns_slfp_quantization_tpu_torch.parallel import make_mesh
    from cnns_slfp_quantization_tpu_torch.parallel import mesh as ml
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    x = np.random.default_rng(3).standard_normal((64, 32, 32, 3)).astype(
        np.float32)
    want = InferenceEngine("mobilenet", qbit=8, batch_size=32,
                           seed=0).predict(x)
    mesh = make_mesh(2, 1)
    eng = InferenceEngine("mobilenet", qbit=8, batch_size=64, seed=0,
                          mesh=mesh)
    got, counts = _counted_run(lambda: eng.predict(x))
    return {"got": got, "want": want, "counts": counts,
            "i": ml.axis_rank(mesh, "data"), "graphed": eng.graphed}


def _mesh_fused_tp(scales, **_):
    """The fused MobileNetV1 (ImageNet, 224) and CIFAR ShuffleNetV2 (32)
    engines at batch 64 on a 1x2 mesh (out-channel shards, gathered per
    forward) against one unsharded engine on the same images, with the
    scales ``main`` derived for them."""
    import torch

    from cnns_slfp_quantization_tpu_torch import calib
    from cnns_slfp_quantization_tpu_torch.parallel import make_mesh
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    res = {}
    for net, size, seed in (("mobilenetv1", 224, 6), ("shufflenetv2", 32, 7)):
        x = np.random.default_rng(seed).standard_normal(
            (64, size, size, 3)).astype(np.float32)
        kw = dict(qbit=8, batch_size=64, seed=0,
                  scales=calib.ScaleSet(*scales[net], 15.5))
        want = InferenceEngine(net, **kw).predict(x)
        eng = InferenceEngine(net, mesh=make_mesh(1, 2), **kw)
        assert eng.fused and eng.executor.mesh is not None
        eng.predict(x[:1])
        t0 = time.perf_counter()
        got, counts = _counted_run(lambda: eng.predict(x))
        torch.cuda.synchronize()
        res[net] = {"got": got, "want": want, "counts": counts,
                    "s": time.perf_counter() - t0, "graphed": eng.graphed}
    return res


def _qat_setup(ka, kw, mesh=None, qbit=8, perm=None):
    """CIFAR mobilenet from seed 0, a DSGD state that counts its updates,
    the step, and the rank's rows of one batch of 256 (``perm``: the
    batch's rows in that order)."""
    import torch

    from cnns_slfp_quantization_tpu_torch import calib, models
    from cnns_slfp_quantization_tpu_torch.data.synthetic import (
        SyntheticIterator)
    from cnns_slfp_quantization_tpu_torch.parallel import steps
    from cnns_slfp_quantization_tpu_torch.train import loop, optimizers

    x, y = next(iter(SyntheticIterator(num_classes=100, batch_size=256,
                                       num_batches=1, seed=7)))
    x = torch.from_numpy(x).cuda()
    y = torch.from_numpy(y.astype(np.int64)).cuda()
    if perm is not None:
        x, y = x[perm], y[perm]
    quantized = dict(scales=calib.ScaleSet(ka, kw, 15.5),
                     compute_dtype=torch.bfloat16, use_pallas=True)
    model = models.create_model(
        "mobilenet", qbit, **(quantized if qbit == 8 else {}),
        generator=torch.Generator().manual_seed(0)).cuda()
    opt = optimizers.dsgd(model.parameters(), 1e-3, 8, track_stats=True)
    state = loop.TrainState(model, opt)
    step = loop.make_train_step(model, opt)
    if mesh is not None:
        steps.shard_state(state, mesh)
        x, y = steps.place_batch(mesh, x, y)
        step = steps.jit_train_step(step)
    return state, step, x, y


def _rowwise(model, x, rows):
    """Eval mode, ``x[rows]`` alone against all of ``x``: whether the
    logits' rows are equal, and each op whose output rows differ where its
    input rows are equal (name, type, elements that differ, of how many,
    the largest difference)."""
    import torch

    from cnns_slfp_quantization_tpu_torch.ops.backend import exact_f32

    def run(xx):
        outs, hooks = {}, []
        for name, mod in model.named_modules():
            if not list(mod.children()):
                hooks.append(mod.register_forward_hook(
                    lambda m, i, o, name=name: outs.__setitem__(
                        name, (type(m).__name__, i[0].clone(), o.clone()))))
        model.eval()
        try:
            with torch.no_grad(), exact_f32():
                out = model(xx)
        finally:
            for h in hooks:
                h.remove()
            model.train()
        return out, outs

    full, fo = run(x)
    part, po = run(x[rows])
    ops = []
    for name, (kind, fi, f) in fo.items():
        _, pi, pt = po[name]
        if torch.equal(fi[rows], pi) and not torch.equal(f[rows], pt):
            d = (f[rows].float() - pt.float()).abs()
            ops.append((name, kind, int((d > 0).sum()), d.numel(),
                        float(d.max())))
    return {"logits_equal": torch.equal(full[rows], part), "ops": ops}


def _full_params(state, mesh=None):
    """The model's parameters by name, gathered whole under a mesh."""
    from cnns_slfp_quantization_tpu_torch.parallel import steps

    named = {k: v.detach() for k, v in state.model.named_parameters()}
    if mesh is not None:
        named = steps.gathered({"model": named}, state.model, mesh)["model"]
    return {k: v.clone() for k, v in named.items()}


def _param_misses(got, want, rtol=2e-4, atol=1e-6):
    """Elements outside ``|got - want| <= atol + rtol |want|`` (the CPU
    test's bar), of how many, and the largest |got - want|."""
    bad = n = 0
    worst = 0.0
    for k, w in want.items():
        d = (got[k] - w).abs()
        bad += int((d > atol + rtol * w.abs()).sum())
        n += w.numel()
        worst = max(worst, float(d.max()))
    return {"misses": bad, "of": n, "max_abs": worst}


@contextlib.contextmanager
def _bn_statistics(model, record=None, replay=None):
    """Record the batch statistics the BN layers use (``[E[x], E[x^2]]`` a
    layer, in call order, on one rank or under a data group), or replay
    recorded ones in their place.  ``comm.all_reduce_mean`` is BN's only
    caller; a layer without a data group is routed through it as the
    identity (the same values: a concatenation and its halves)."""
    from cnns_slfp_quantization_tpu_torch.ops.layers import BatchNorm2d
    from cnns_slfp_quantization_tpu_torch.parallel import comm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    groups = [m.data_group for m in bns]
    for m in bns:
        if m.data_group is None:
            m.data_group = "one rank"
    orig = comm.all_reduce_mean
    calls = iter(range(len(bns) * 4))

    def stats(t, group):
        k = next(calls)
        out = (replay[k] if replay is not None
               else t if group == "one rank" else orig(t, group))
        if record is not None:
            record.append(out.detach().clone())
        return out

    comm.all_reduce_mean = stats
    try:
        yield
    finally:
        comm.all_reduce_mean = orig
        for m, g in zip(bns, groups):
            m.data_group = g


def _mesh_qat(ka, kw, **_):
    """CIFAR mobilenet, batch 256, one DSGD step on a 2x1 and a 1x2 mesh
    against the single-rank step: float32, and SLFP8 route B (K4 with its
    STE backward, K1; under 1x2 K4 on the column shards).  Beside them,
    what sets the bars: single steps on the batch's rows in other orders
    (sound runs: every sum in another order, as the ranks sum), faulty 2x1
    steps (each rank's BN statistics its own; no gradient reduction), the
    BN statistics each step used, and for route B the ops that give a row
    other bits at 128 rows than at 256 (eval mode) and the 2x1 step with
    the single step's BN statistics replayed."""
    import torch
    import torch.distributed as dist

    from cnns_slfp_quantization_tpu_torch.ops.layers import BatchNorm2d
    from cnns_slfp_quantization_tpu_torch.parallel import make_mesh
    from cnns_slfp_quantization_tpu_torch.train import loop

    res = {}
    for qbit in (32, 8):
        state, step, x, y = _qat_setup(ka, kw, qbit=qbit)
        if qbit == 8:
            h = dist.get_rank()         # the rank's rows on the 2x1 mesh
            rowwise = _rowwise(state.model, x, slice(h * 128, h * 128 + 128))
        recorded = []
        with _bn_statistics(state.model, record=recorded):
            single = float(step(state, x, y)["loss"])
        want = _full_params(state)
        r = {"single": single, "n_params": sum(v.numel()
                                               for v in want.values()),
             "single_stats": {k: int(v) for k, v in
                              state.optimizer.stats.items()},
             "bn0": recorded[0]}
        for shape in ((2, 1), (1, 2)):
            mesh = make_mesh(*shape)
            state, step, xs, ys = _qat_setup(ka, kw, mesh, qbit=qbit)
            used = []
            with _bn_statistics(state.model, record=used):
                m, counts = _counted_run(lambda: step(state, xs, ys))
            r[shape] = {"loss": float(m["loss"]), "counts": counts,
                        "rows": xs.shape[0], "bn0": used[0],
                        "params": _param_misses(_full_params(state, mesh),
                                                want),
                        "stats": {k: int(v) for k, v in
                                  state.optimizer.stats.items()}}
        r["reordered"] = []
        for seed in range(3 if qbit == 8 else 2):
            perm = torch.from_numpy(np.random.default_rng(seed)
                                    .permutation(256)).cuda()
            state, step, xp, yp = _qat_setup(ka, kw, qbit=qbit, perm=perm)
            r["reordered"].append({
                "loss": float(step(state, xp, yp)["loss"]),
                "params": _param_misses(_full_params(state), want)})
        state, step, xs, ys = _qat_setup(ka, kw, make_mesh(2, 1), qbit=qbit)
        for mod in state.model.modules():
            if isinstance(mod, BatchNorm2d):
                mod.data_group = None
        used = []
        with _bn_statistics(state.model, record=used):
            r["local_bn"] = float(step(state, xs, ys)["loss"])
        r["local_bn0"] = used[0]
        if qbit == 32:
            state, _, xs, ys = _qat_setup(ka, kw, make_mesh(2, 1), qbit=qbit)
            loop.make_train_step(state.model, state.optimizer)(state, xs, ys)
            r["no_grad_reduce"] = _param_misses(_full_params(state), want)
        else:
            r["rowwise"] = rowwise
            state, step, xs, ys = _qat_setup(ka, kw, make_mesh(2, 1),
                                             qbit=qbit)
            with _bn_statistics(state.model, replay=recorded):
                r["replayed_bn"] = float(step(state, xs, ys)["loss"])
        for k in ("bn0", "local_bn0"):
            r[k] = r[k].cpu()
        for shape in ((2, 1), (1, 2)):
            r[shape]["bn0"] = r[shape]["bn0"].cpu()
        res[qbit] = r
    return res


def _mesh_spatial(**_):
    """spatial_conv2d 3x3 over an H-sharded input (2x1 mesh) against
    F.conv2d of the whole input, both in full float32."""
    import torch
    import torch.nn.functional as F

    from cnns_slfp_quantization_tpu_torch.parallel import (
        comm,
        make_mesh,
        spatial,
    )
    from cnns_slfp_quantization_tpu_torch.parallel import mesh as ml

    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(8, 64, 56, 64, device="cuda", generator=g)
    w = torch.randn(3, 3, 64, 64, device="cuda", generator=g) * 0.1
    mesh = make_mesh(2, 1)
    i, h = ml.axis_rank(mesh, "data"), 32
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = spatial.spatial_conv2d(x[:, i * h:(i + 1) * h].contiguous(), w,
                                   mesh)
        y = comm.all_gather_cat(y, 1, mesh.get_group("data"))
        want = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1)
    return {"err": float((y - want).abs().max()),
            "scale": float(want.abs().max())}


def _mesh_cli(**_):
    """cifar100_train_eval --mesh_data 2 on synthetic data, SLFP8 bf16
    (route A: K1), two steps and an eval on each rank, in this rank's gloo
    group (the driver keeps a group it finds)."""
    import io
    import tempfile
    from contextlib import redirect_stdout

    from cnns_slfp_quantization_tpu_torch.cli import cifar100_train_eval

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, redirect_stdout(buf):
        (state, accs), counts = _counted_run(lambda: cifar100_train_eval.main(
            ["--synthetic", "--retrain", "--net", "mobilenet", "--Qbits",
             "8", "--compute_dtype", "bfloat16", "--optimizer", "DSGD",
             "--train_batch_size", "128", "--eval_batch_size", "128",
             "--synthetic_batches", "2", "--mesh_data", "2",
             "--root_dir", tmp]))
    return {"step": state.step, "accs": accs, "counts": counts,
            "mesh_line": [ln for ln in buf.getvalue().splitlines()
                          if "device mesh" in ln]}


def _mesh_scaling(**_):
    from cnns_slfp_quantization_tpu_torch.parallel import scaling_bench

    return scaling_bench.run("mobilenet", [1, 2], per_device_batch=128,
                             image_size=32, qbit=8, mode="both",
                             fused=True, device="cuda")


@contextlib.contextmanager
def _parent_exact_f32():
    """The training step's numerics flags before the determinism repair:
    ``cudnn.flags`` without ``deterministic=True`` sets it False for its
    scope."""
    import torch

    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


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

    from collections import Counter

    from cnns_slfp_quantization_tpu_torch import calib, kernels, models
    from cnns_slfp_quantization_tpu_torch.kernels import _build, _gemm_plan
    from cnns_slfp_quantization_tpu_torch.kernels import chain as k6
    from cnns_slfp_quantization_tpu_torch.kernels import depthwise as k5
    from cnns_slfp_quantization_tpu_torch.kernels import epilogue as k3
    from cnns_slfp_quantization_tpu_torch.kernels import fused_matmul as k4
    from cnns_slfp_quantization_tpu_torch.kernels import optim as k7
    from cnns_slfp_quantization_tpu_torch.kernels import qmm as k2
    from cnns_slfp_quantization_tpu_torch.kernels import quantize as k1
    from cnns_slfp_quantization_tpu_torch.models import (
        shufflenetv2_fused as sfused)
    from cnns_slfp_quantization_tpu_torch.models.mobilenetv1 import DW_CONFIG
    from cnns_slfp_quantization_tpu_torch.models.resnet50 import (
        block_names as rn_blocks)
    from cnns_slfp_quantization_tpu_torch.models.resnet50_fused import (
        ConvKxK,
        _conv_f32,
    )
    from cnns_slfp_quantization_tpu_torch.ops import sfp
    from cnns_slfp_quantization_tpu_torch.ops.backend import (
        backend_flags,
        exact_f32,
    )
    from cnns_slfp_quantization_tpu_torch.serve import FUSABLE, InferenceEngine
    from cnns_slfp_quantization_tpu_torch.utils import (
        bench_epilogue,
        bench_gemm,
    )
    # the H100's peak rates, the elementwise kernels' operations per element
    # and the bound formula: one home, the roofline tool
    from cnns_slfp_quantization_tpu_torch.utils.bench_roofline import (
        BF16_FLOPS,
        DW_OPS,
        F32_OPS,
        K1_OPS,
        K3_OPS,
        K7_OPS,
        bound_ms,
    )
    from cnns_slfp_quantization_tpu_torch.utils.profiling import (
        graph_ms, kernel_ms, median_ms, print_forward_profile, throughput)

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
        "k7": Row("qsgd_update", f"{PKG}/csrc/optim.cu",
                  "none: the JAX package leaves the update to XLA's fusion "
                  "(cnns_slfp_quantization_tpu/train/optimizers.py)",
                  "resnet_qat"),
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

    # ------------------------------------------------------------------ K7
    @phase("K7 qsgd_update")
    def k7_phase():
        """QSGD's update over ResNet-50's 161 parameter tensors (the QAT
        cell's step): bit-equal to the plain version under every rule, the
        counts equal, then timed under DSGD at qbit 8 (momentum 0.9, weight
        decay 5e-4, as the QAT step runs it): the kernel as a CUDA graph of
        10 calls between events, the plain version between events, the
        bound (20 bytes an element: p, g and buf read, p and buf
        written)."""
        shapes = [tuple(p.shape) for p in models.create_model(
            "resnet", 8, compute_dtype=torch.bfloat16,
            image_size=224).parameters()]
        n = sum(int(np.prod(s_)) for s_ in shapes)
        rng = np.random.default_rng(7)
        host = [[(rng.standard_normal(s_) * sd).astype(np.float32)
                 for s_ in shapes] for sd in (0.05, 0.02, 0.02)]
        for arr in host[0][::7]:             # some weights on a bin edge
            arr.flat[::3] = sfp._LOG_BIN_BOUNDS[
                np.arange(arr.flat[::3].size) % 16] * 0.25
        for arr in host[1][::11]:            # subnormal and -0.0 gradients
            arr.flat[::5] = np.float32(1e-40)
            arr.flat[1::5] = np.float32(-0.0)
        neg_lr = torch.tensor(np.float32(-0.01), device=dev)

        def fresh(with_buf=True):
            ps_, gs_, bs_ = ([torch.from_numpy(a).to(dev) for a in h]
                             for h in host)
            return ps_, gs_, (bs_ if with_buf else None)
        cases = [("dsgd", 8, 0.9, 0.0, False, 5e-4, True),
                 ("dsgd", 7, 0.9, 0.0, False, 5e-4, True),
                 ("dsgd", 32, 0.9, 0.0, False, 5e-4, True),
                 ("dsgd", 8, 0.9, 0.1, True, 5e-4, True),
                 ("dsgd", 8, 0.0, 0.0, False, 0.0, False),
                 ("ssgd", 8, 0.9, 0.0, False, 5e-4, False),
                 ("sgd", 32, 0.9, 0.1, True, 5e-4, False)]
        for rule, qbit, m, damp, nest, wd, stats in cases:
            kw = dict(rule=rule, qbit=qbit, weight_decay=wd, momentum=m,
                      dampening=damp, nesterov=nest, tol=1e-4, stats=stats)
            out = []
            for fn in (k7.qsgd_update, k7.qsgd_update_plain):
                ps_, gs_, bs_ = fresh(bool(m))
                before = k7.qsgd_update.launches
                counts = fn(ps_, gs_, bs_, neg_lr, **kw)
                torch.cuda.synchronize()
                out.append((ps_ + (bs_ or []), counts,
                            k7.qsgd_update.launches - before))
            (got, cg, ng), (want, cw, _) = out
            assert ng == 2, ng
            for a, b in zip(got, want):
                assert same_bits(a, b), (rule, qbit, m, damp, nest, wd)
            assert (cg is None and cw is None) or torch.equal(cg, cw)
            print(f"  K7 {rule} qbit {qbit} momentum {m} dampening {damp} "
                  f"nesterov {nest} wd {wd}: bit-equal to the plain version "
                  f"on {len(shapes)} tensors ({n} elements), 2 launches"
                  + (f", counts updated / stuck {cg.sum(0).tolist()}"
                     if stats else ""), flush=True)
        ps_, gs_, bs_ = fresh()
        kw = dict(rule="dsgd", qbit=8, weight_decay=5e-4, momentum=0.9,
                  dampening=0.0, nesterov=False, tol=1e-4)

        def call():
            k7.qsgd_update(ps_, gs_, bs_, neg_lr, **kw)
        call()
        ms = graph_ms(call, 10)
        kms = kernel_ms(call)
        pms = median_ms(lambda: k7.qsgd_update_plain(ps_, gs_, bs_, neg_lr,
                                                     **kw), iters=5, inner=1)
        nbytes = 20 * n
        rows["k7"].add(1, ms, pms, nbytes, K7_OPS * n, F32_OPS)
        rows["k7"].counted("resnet_qat", 2, 1)
        bms, by = bound_ms(nbytes, K7_OPS * n, F32_OPS)
        print(f"  K7 DSGD qbit 8 at ResNet-50's {len(shapes)} tensors: "
              f"{ms:.4f} ms a step as a graph (profiler {kms:.4f}), "
              f"{nbytes / ms / 1e6:.1f} GB/s; plain {pms:.3f}; bound "
              f"{bms:.4f} ({by}); {bms / ms:.1%} of it ({card})",
              flush=True)

    # ---------------------------------------------------------------- paths
    def cos(a, b):
        a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

    def same_top1(a, b):
        return bool((np.argmax(a, -1) == np.argmax(b, -1)).all())

    def top1_rows(got, want):
        """The rows whose top-1 differs, each with the top-2 margin of
        ``want`` and whether ``got``'s top-1 is one of ``want``'s tied
        classes (an exact tie at the maximum has no single top-1: argmax
        takes the first), and the largest elementwise |got - want|."""
        got, want = (np.asarray(v, np.float32) for v in (got, want))
        diff = float(np.abs(got - want).max())
        top2 = np.sort(want, -1)[:, -2:]
        g1 = np.argmax(got, -1)
        rows_ = np.nonzero(g1 != np.argmax(want, -1))[0]
        return [(int(i), float(top2[i, 1] - top2[i, 0]),
                 bool(want[i, g1[i]] == want[i].max())) for i in rows_], diff

    rng = np.random.default_rng(0)
    requests = [rng.standard_normal((n, 224, 224, 3)).astype(np.float32)
                for n in (64, 64, 17)]

    # ----------------------------------------- graphs: traces and helpers
    from cnns_slfp_quantization_tpu_torch.utils.profiling import (
        HAND_KERNELS,
        _perturbed,
        busy_ms,
        scan_throughput,
        scan_train_throughput,
    )

    def bits(ts):
        """The bytes of each tensor, for bit-for-bit comparisons."""
        return [t.detach().reshape(-1).contiguous().view(torch.uint8)
                for t in ts]

    def same_bytes(a, b):
        return len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))

    BUSY_CALLS = 3

    def traced(label, fn):
        """Wall, kernel time by class and idle share per call of ``fn``
        over BUSY_CALLS calls (``profiling.busy_ms``), printed: {"wall",
        "busy", "idle" (None where the profiler recorded no kernel),
        "classes", "launched": the hand kernels' launches the trace holds
        over the calls}."""
        wall, busy, classes, launched = busy_ms(fn, calls=BUSY_CALLS)
        launched = {k: n for k, n in launched.items() if n}
        out = dict(wall=wall, busy=busy, idle=None, classes=classes,
                   launched=launched)
        if busy is None:
            print(f"  {label}: wall {wall:.3f} ms; the profiler recorded no "
                  f"kernel (idle share not measured)", flush=True)
            return out
        out["idle"] = 1 - busy / wall
        print(f"  {label}: wall {wall:.3f} ms, kernels {busy:.3f} ms, idle "
              f"share {out['idle']:.3f}; by class: " + ", ".join(
                  f"{c} {ms:.3f}" for c, ms in sorted(classes.items()))
              + f" ms; hand kernels in the trace over {BUSY_CALLS} calls "
              f"{launched}", flush=True)
        return out

    def busy_line(label, fn):
        """(the idle share or None, the hand kernels' launches) of
        :func:`traced`."""
        t = traced(label, fn)
        return t["idle"], t["launched"]

    def replayed(path, label, graphed, per_call):
        """The idle share of ``graphed``'s replays; the hand kernels their
        trace holds must be ``per_call`` (counted at the capture) times the
        replays, and that count is the path's launches."""
        want = {k: n * BUSY_CALLS for k, n in per_call.items()
                if n and k in HAND_KERNELS}
        idle, launched = busy_line(label, graphed)
        assert launched == want, (label, launched, want)
        for key, name in (("k1", "act_quantize"), ("k2", "qmm_fused"),
                          ("k3", "bn_epilogue"), ("k4", "fused_quant_matmul"),
                          ("k5", "dw3x3"), ("k6", "bottleneck_chain"),
                          ("k7", "qsgd_update")):
            if name in launched:
                rows[key].counted(path, launched[name], BUSY_CALLS)
        return idle

    # The engine serves through one CUDA graph on the card: its first
    # call captures the forward (the wrappers count the capture's eager
    # lead-in and its recording, each a forward's launches), and a replay
    # launches the hand kernels without Python, so the replays' launches
    # are counted by kernel name in their trace.  The eager forward, the
    # engine's private ``_eager``, is the A/B.
    def eager_forward(eng, x):
        with torch.inference_mode():
            return eng._eager(x)

    def eager_predict(eng, images):
        """``eng.predict`` through the eager forward: the same chunks, each
        padded to the engine's batch."""
        out = []
        for s in range(0, images.shape[0], eng.batch_size):
            chunk = images[s:s + eng.batch_size]
            pad = eng.batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)])
            y = eager_forward(eng, torch.from_numpy(chunk).to(dev))
            out.append(y[:eng.batch_size - pad].float().cpu().numpy())
        return np.concatenate(out)

    def eager_throughput(eng, iters):
        """``eng.throughput(iters)`` timed the same way on the eager
        forward."""
        x = torch.zeros(eng.input_shape, dtype=torch.float32, device=dev)
        return scan_throughput(eng._eager, x, steps=iters, graph=False)

    def same_logits(a, b):
        return a.shape == b.shape and np.array_equal(
            np.ascontiguousarray(a).view(np.uint32),
            np.ascontiguousarray(b).view(np.uint32))

    # forwards of each throughput() in the graph turns: 8, or fewer where
    # an eager forward is long (at least 2; a timed run of about 100 ms)
    TURN_ITERS, TURN_MS = 8, 100.0
    engine_graphs = {}  # path -> the graph / eager readings, for the summary

    def graph_checks(eng, path, reqs, classes):
        """The engine's graph against its eager forward on one served path
        (the graph captured already, or at its first call here):
        ``predict`` on the first request and on one longer than the batch
        (its last chunk padded) bit-equal through both; ``forward(x1)``
        then ``forward(x2)`` leaves the first result as it was; the hand
        kernels a replay launches, counted by name in the trace, those the
        wrappers count in an eager forward; ``throughput()`` in turns
        against the eager forward timed the same way (graph, eager, eager,
        graph), with each mode's idle share and kernel time by class.
        Returns the eager forward's launches per forward."""
        assert eng.graphed, path
        b = eng.batch_size
        long = np.concatenate([reqs[0][:b], reqs[-1][:9]])
        assert long.shape[0] > b and long.shape[0] % b, long.shape
        torch.cuda.synchronize()
        kernels.reset_launches()
        eager_logits = [eager_predict(eng, r) for r in (reqs[0], long)]
        torch.cuda.synchronize()
        counts = kernels.launches()
        fwds = -(-reqs[0].shape[0] // b) - (-long.shape[0] // b)
        assert all(n % fwds == 0 for n in counts.values()), (path, counts)
        per_fwd = {k: n // fwds for k, n in counts.items() if n}
        graph_logits = [eng.predict(r) for r in (reqs[0], long)]
        for g, e in zip(graph_logits, eager_logits):
            assert g.shape[-1] == classes and np.isfinite(g).all(), path
            assert same_logits(g, e), f"{path}: graph logits differ"
        x1 = torch.from_numpy(reqs[0][:b]).to(dev)
        x2 = torch.from_numpy(long[-b:]).to(dev)
        y1 = eng.forward(x1)
        kept = y1.clone()
        y2 = eng.forward(x2)
        assert y1.data_ptr() != y2.data_ptr() and same_bits(y1, kept), \
            f"{path}: a forward's result was overwritten"
        ran = {"graph": traced(f"{path} graph replay",
                               lambda: eng._dispatch(x1)),
               "eager": traced(f"{path} eager forward",
                               lambda: eager_forward(eng, x1))}
        want = {k: n * BUSY_CALLS for k, n in per_fwd.items()
                if k in HAND_KERNELS}
        for mode, t in ran.items():
            assert t["launched"] == want, (path, mode, t["launched"], want)
        iters = max(2, min(TURN_ITERS,
                           round(TURN_MS / ran["eager"]["wall"])))
        ips = {"graph": [], "eager": []}
        for mode in ("graph", "eager", "eager", "graph"):
            ips[mode].append(eng.throughput(iters=iters) if mode == "graph"
                             else eager_throughput(eng, iters))
        mean = {k: sum(v) / len(v) for k, v in ips.items()}
        engine_graphs[path] = {
            "batch": b, "iters": iters, "graph_ips": ips["graph"],
            "eager_ips": ips["eager"],
            "ratio": mean["graph"] / mean["eager"],
            "idle": {m: t["idle"] for m, t in ran.items()},
            "wall_ms": {m: t["wall"] for m, t in ran.items()},
            "kernel_ms": {m: t["busy"] for m, t in ran.items()},
            "classes": {m: t["classes"] for m, t in ran.items()},
            "per_replay": {k: n // BUSY_CALLS for k, n in want.items()}}
        print(f"  {path} engine graph: predict bit-equal to eager (a padded "
              f"chunk included), forward results kept, launches a replay "
              f"{engine_graphs[path]['per_replay']} = eager's; throughput"
              f"(iters={iters}) images/s at batch {b} in turns: graph "
              f"{[round(v, 1) for v in ips['graph']]}, eager "
              f"{[round(v, 1) for v in ips['eager']]}; graph / eager "
              f"{engine_graphs[path]['ratio']:.3f} ({card})", flush=True)
        return per_fwd

    def serve(eng, path, want, reqs=requests, classes=1000):
        """The path's run through the engine's graph: counts reset just
        before the requests, whose first ``predict`` captures the graph,
        and read just after.  ``want`` maps wrapper -> launches per
        forward: the capture counts twice that (its eager lead-in and the
        recording; the replays run no wrapper), every other wrapper must
        stay at 0.  Then :func:`graph_checks`, whose eager forward must
        launch ``want``; the path's row keeps the capture's count and, per
        forward, a replay's launches from the trace."""
        fwd = len(reqs)
        assert eng.graphed and eng._graph is None, path
        torch.cuda.synchronize()
        kernels.reset_launches()
        logits = [eng.predict(r) for r in reqs]
        torch.cuda.synchronize()
        counts = kernels.launches()
        print(f"  {path}: launches over {fwd} requests (the first call "
              f"captures the graph): {counts}", flush=True)
        for name, n in counts.items():
            assert n == 2 * want.get(name, 0), (name, counts, want)
        per_fwd = graph_checks(eng, path, reqs, classes)
        assert per_fwd == {k: v for k, v in want.items() if v}, \
            (path, per_fwd, want)
        for key, name in (("k1", "act_quantize"), ("k2", "qmm_fused"),
                          ("k3", "bn_epilogue"), ("k4", "fused_quant_matmul"),
                          ("k5", "dw3x3"), ("k6", "bottleneck_chain"),
                          ("k7", "qsgd_update")):
            # a kernel's row keeps the paths it was timed on (and its main
            # one); the counts of every path are asserted above
            if want.get(name) and (path in rows[key].paths
                                   or path == rows[key].main):
                rows[key].counted(path, counts[name], 2)
        for r, lg in zip(reqs, logits):
            assert lg.shape == (r.shape[0], classes) and np.isfinite(lg).all()
        print(f"  logits[0, :4] = {logits[0][0, :4]}, top-1 of the last "
              f"request: {np.argmax(logits[-1], -1)[:8]}", flush=True)
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
        kernels.reset_launches()
        l3 = eager_predict(eng3, requests[0])
        counts3 = kernels.launches()
        assert counts3["bn_epilogue_dual"] == 12, counts3
        assert counts3["qmm_fused"] == 16, counts3
        c3 = cos(l3, logits[0])
        print(f"  policy conv3=torch (eager): {counts3}, cos {c3:.6f}",
              flush=True)
        assert c3 > 0.995
        assert same_top1(l3, logits[0])
        graph_checks(eng3, "resnet_fused_conv3_torch", requests, 1000)
        del eng3

        fp32 = InferenceEngine("resnet", qbit=32, batch_size=B,
                               image_size=224, seed=0, compute_dtype=None)
        lf = fp32.predict(requests[0][:8])
        assert np.isfinite(lf).all()
        tp8 = images_per_s(eng, "resnet_fused_slfp8")
        tp32 = images_per_s(fp32, "resnet_fp32")
        print(f"  SLFP8 / fp32 b{B}: {tp8 / tp32:.3f}", flush=True)
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
        # in turns: chain off, chain, chain, chain off (graph throughput)
        d1, c1, c2, d2 = (images_per_s(e, label) for e, label in (
            (fused_eng, "resnet_chain_off"), (eng, "resnet_chain"),
            (eng, "resnet_chain"), (fused_eng, "resnet_chain_off")))
        print(f"  b{B}: chain={{2,3}} (default) / off "
              f"{(c1 + c2) / (d1 + d2):.3f}", flush=True)
        return eng

    def images_per_s(eng, label):
        """``eng.throughput()``: its graph at its batch, JAX's rule."""
        ips = eng.throughput()
        print(f"  throughput {label}_b{eng.batch_size}: {ips:.1f} images/s",
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
        lx = eager_predict(plain, requests[0])
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
        eager_predict(fp32, images)   # a replay runs no hook
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

    def throughputs(eng, fp32, label):
        tp8 = images_per_s(eng, f"{label}_slfp8")
        tp32 = images_per_s(fp32, f"{label}_fp32")
        print(f"  {label} SLFP8 / fp32 b{eng.batch_size}: {tp8 / tp32:.3f}",
              flush=True)

    @phase("path: InferenceEngine mobilenetv1 SLFP8 fused executor (K5)")
    def mobilenetv1_phase():
        eng, sc, logits, fp32 = mobilenet_fused_phase(
            "mobilenetv1", "mobilenetv1_fused",
            {"act_quantize": 1, "bn_epilogue": 18, "dw3x3": 9}, requests,
            1000)
        torch_route = InferenceEngine("mobilenetv1", qbit=8, batch_size=B,
                                      seed=0, scales=sc,
                                      policy={"dw": "torch"})
        kernels.reset_launches()
        lt = eager_predict(torch_route, requests[0])
        counts = kernels.launches()
        assert (counts["bn_epilogue"], counts["dw3x3"]) == (27, 0), counts
        ct = cos(lt, logits)
        print(f"  policy dw=torch (eager): {counts}, cos {ct:.6f}",
              flush=True)
        assert ct > 0.995
        assert same_top1(lt, logits)
        graph_checks(torch_route, "mobilenetv1_fused_dw_torch", requests,
                     1000)
        throughputs(eng, fp32, "mobilenetv1_fused")
        return eng, sc, logits, fp32, torch_route

    @phase("path: InferenceEngine mobilenet (CIFAR) SLFP8 fused executor")
    def mobilenet_cifar_phase():
        eng, _, _, fp32 = mobilenet_fused_phase(
            "mobilenet", "mobilenet_fused",
            {"act_quantize": 2, "bn_epilogue": 18, "dw3x3": 9},
            cifar_requests, 100)
        throughputs(eng, fp32, "mobilenet_fused")

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
        throughputs(eng, fp32, "mobilenetv1_module_packed_k4")

    # ------------------------------------- the zoo and the serving surface
    def record_sites(call):
        """K1's, K3's and K4's calls in one run of ``call`` (a forward), by
        their shapes and forms: {("k1" | "k3" | "k4", ...): calls}, K1's
        first reciprocal at each under ``("recip", key)``.  The wrappers
        are wrapped where the paths look them up (the layers of the module
        path, the ShuffleNetV2 executor, the quantize pass ResNet-50's
        executor calls, K3's and K4's modules) for that one run; the
        counted runs come after, through the wrappers as they are."""
        seen = Counter()

        def k1_rec(orig):
            def rec(x, recip, **kw):
                key = ("k1", tuple(x.shape), x.dtype, kw.get("qbit", 8),
                       kw.get("nonneg", True),
                       kw.get("out_dtype", torch.bfloat16))
                seen[key] += 1
                seen.setdefault(("recip", key), float(recip))
                return orig(x, recip, **kw)
            rec.__dict__ = orig.__dict__   # its launch counts
            return rec

        def k3_rec(orig):
            def rec(y, scale, shift, **kw):
                seen[("k3", tuple(y.shape), kw.get("relu", True),
                      kw.get("emit_raw", True),
                      kw.get("quant_recip") is not None,
                      kw.get("q_dtype", torch.bfloat16),
                      kw.get("identity") is not None)] += 1
                return orig(y, scale, shift, **kw)
            # K3's body counts through its module's name, now this one
            rec.__dict__ = orig.__dict__
            return rec

        def k4_rec(orig):
            def rec(x, w, **kw):
                seen[("k4", tuple(x.shape), x.stride(), x.dtype,
                      tuple(w.shape), w.dtype, kw.get("bias") is not None,
                      kw.get("stride", 1), kw.get("nonneg", False),
                      kw.get("out_dtype", torch.float32), kw.get("act"),
                      kw.get("n_out"))] += 1
                return orig(x, w, **kw)
            rec.__dict__ = orig.__dict__
            return rec

        patches = [(k1, "act_quantize", k1_rec),
                   (sfused, "act_quantize", k1_rec),
                   (k2, "act_quantize", k1_rec),  # ResNet-50's K1 passes
                   (k3, "bn_epilogue", k3_rec),
                   (k4, "quant_conv1x1", k4_rec), (k4, "quant_dense", k4_rec)]
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
        try:
            for mod, name, wrap in patches:
                setattr(mod, name, wrap(getattr(mod, name)))
            call()
            torch.cuda.synchronize()
        finally:
            for mod, name, orig in saved:
                setattr(mod, name, orig)
        return seen

    K3_FORM = {  # (relu, raw, q, identity) -> bench_epilogue.FORMS
        (True, True, False, False): "raw_relu",
        (False, True, False, False): "raw_norelu",
        (True, False, True, False): "q",
        (False, False, True, False): "q_norelu",
        (True, False, True, True): "q_res", (True, True, True, True): "dual",
        (True, True, False, True): "raw_res"}

    copies = {}   # path -> ms per forward of K4's x copies (pad_x)

    def time_sites(path, seen):
        """Each recorded site of ``path`` in its form and at its shape on
        inputs from the seed, against its plain version (K1, K3 bit for
        bit; K4 by K2's rule), timed; per forward into the rows."""
        for key, n in sorted(seen.items(), key=str):
            if key[0] == "recip":
                continue
            if key[0] == "k1":
                _, shape, dt, qbit, nonneg, od = key
                r = seen[("recip", key)]
                x = randn(*shape, scale=1.5 / r)
                x = (x.abs() if nonneg else x).to(dt)
                kw = dict(qbit=qbit, nonneg=nonneg, out_dtype=od)
                got = k1.act_quantize(x, r, **kw)
                want = k1.act_quantize_plain(x, r, **kw)
                torch.cuda.synchronize()
                assert same_bits(got, want), f"K1 {path} {key} not bit-equal"
                ms, ems, pms = timed(lambda: k1.act_quantize(x, r, **kw),
                                     lambda: k1.act_quantize_plain(x, r, **kw))
                nbytes = x.numel() * (x.element_size() + got.element_size())
                ops = x.numel() * K1_OPS
                rows["k1"].add(n, ms, pms, nbytes, ops, F32_OPS, path=path)
                label = f"K1 {path} {shape} {dt} -> {od} qbit {qbit}"
            elif key[0] == "k3":
                _, shape, relu, raw, quant, qd, ident = key
                form = K3_FORM[(relu, raw, quant, ident)]
                call, plain, nbytes, nel = k3_case(shape, form,
                                                   qd == torch.float32)
                ms, ems, pms = timed(call, plain)
                ops = nel * K3_OPS
                rows["k3"].add(n, ms, pms, nbytes, ops, F32_OPS, path=path)
                label = f"K3 {path} {form} {shape} q {qd}"
            else:
                _, shape, xstride, xdt, (k, nn_), wdt, has_bias, stride, \
                    nonneg, od, act, n_out = key
                # x at the path's strides (a channel half of ShuffleNetV2
                # is a slice), the weights as the layer hands them over
                x = randn(*shape, scale=1.5)
                x = torch.empty_strided(shape, xstride, dtype=xdt,
                                        device=dev).copy_(
                    x.abs() if nonneg else x)
                kx, nx = shape[-1], n_out or nn_
                wq = sfp.quantize_weight(randn(nx, kx, scale=4.0), 8)
                w = (sfp.pack_slfp34(wq) if wdt == torch.uint8
                     else wq.to(torch.bfloat16)).t()
                bias = randn(nx, scale=0.1) if has_bias else None
                if n_out is not None:   # padded once, as the layers do
                    w, bias = k4.pad_weight(w, bias)
                    assert tuple(w.shape) == (k, nn_), key
                label = f"K4 {path} {shape} K={k} N={nn_} s{stride} {wdt}"
                # the per-call copy of x into padded channels, timed apart
                # from the kernel, which is timed on the padded operand
                x4 = x if x.dim() == 4 else x[:, None, None, :]
                xk = k4.pad_x(x4, k)
                if xk is not x4:
                    assert stride == 1, key
                    cms = kernel_ms(lambda: k4.pad_x(x4, k))
                    copies[path] = copies.get(path, 0.0) + n * cms
                    label += f" (x copied to K={k}: {cms:.4f} ms apart)"
                    x = xk if x.dim() == 4 else xk.reshape(-1, k)
                flags = dict(nonneg=nonneg, out_dtype=od)
                if act is not None:
                    flags["act"] = act
                call, plain, lib, nbytes, ops = k4_case(
                    x, w, bias, stride, label, **flags)
                ms, ems, pms = kernel_ms(call), median_ms(call), \
                    median_ms(plain, iters=5, inner=1)
                try:
                    lms = kernel_ms(lib)
                    label += f", torch.matmul {lms:.4f}"
                except RuntimeError as e:
                    # cuBLAS launches a varying number of kernels at some
                    # small shapes, so the profiler's runs do not agree:
                    # the library's time between CUDA events instead
                    lms = median_ms(lib)
                    label += (f", torch.matmul {lms:.4f} (events; profiler: "
                              f"{str(e)[:60]})")
                rows["k4"].add(n, ms, pms, nbytes, ops, BF16_FLOPS, lms,
                               path=path)
                print(f"  {label} x{n}: {ms:.4f} ms (events {ems:.4f}), "
                      f"plain {pms:.4f}, bound "
                      f"{bound_ms(nbytes, ops, BF16_FLOPS)[0]:.4f}",
                      flush=True)
                continue
            print(f"  {label} x{n}: {ms:.4f} ms (events {ems:.4f}), plain "
                  f"{pms:.4f} ms, bound "
                  f"{bound_ms(nbytes, ops, F32_OPS)[0]:.4f} ms", flush=True)

    def sites(path, call, want):
        """record_sites over one forward, its calls per kernel held to
        ``want`` (the launches per forward that serve() then asserts: a
        site the recording misses fails here), then time_sites."""
        seen = record_sites(call)
        got = Counter()
        for key, n in seen.items():
            if key[0] != "recip":
                got[{"k1": "act_quantize", "k3": "bn_epilogue",
                     "k4": "fused_quant_matmul"}[key[0]]] += n
        # the recorded kernels' (K7, the optimizer's, is counted apart)
        assert got == Counter({k: v for k, v in want.items() if v and k in (
            "act_quantize", "bn_epilogue", "fused_quant_matmul")}), \
            (path, dict(got), want)
        time_sites(path, seen)
        if path in copies:
            print(f"  {path}: K4's x copies {copies[path]:.4f} ms per "
                  f"forward", flush=True)

    def batch_of(size):
        """A batch of B images of ``size`` on the card, from seed 2."""
        return torch.from_numpy(np.random.default_rng(2).standard_normal(
            (B, size, size, 3)).astype(np.float32)).to(dev)

    def against_cpu(net, logits, x, **kw):
        """The same weights (seed 0) and options on the CPU, 2 images: the
        plain versions of the kernels; cosine > 0.995 and the same top-1.
        Returns (cosine, the CPU engine)."""
        t0 = time.perf_counter()
        cpu = InferenceEngine(net, batch_size=2, seed=0, device="cpu", **kw)
        got = cpu.predict(x[:2])
        c = cos(got, logits[:2])
        print(f"  CPU plain path on 2 images: cos {c:.6f}, top-1 "
              f"{np.argmax(got, -1)} vs {np.argmax(logits[:2], -1)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        assert c > 0.995
        assert same_top1(got, logits[:2])
        return c, cpu

    def blocks_against_cpu(eng, cpu, x):
        """The ResNet-50 module path on the card block by block: the stem
        and each bottleneck fed the card's own input to it, against the
        same block on the CPU (plain versions) fed the same input; cosine
        > 0.999 each, the bar tests/test_torch_port_zoo.py holds the port's
        bf16 blocks to against JAX."""
        g, c = eng.model, cpu.model
        xg = torch.from_numpy(x[:2]).to(dev).permute(0, 3, 1, 2)
        worst = (1.0, "")
        with torch.inference_mode(), backend_flags():   # as the engine
            h = g.stem(xg)
            worst = min(worst, (cos(h.float().cpu().numpy(), c.stem(
                xg.cpu()).float().numpy()), "stem"))
            for _, _, pre, *_ in rn_blocks():
                out = g.block(h, pre)
                ref = c.block(h.cpu(), pre)
                worst = min(worst, (cos(out.float().cpu().numpy(),
                                        ref.float().numpy()), pre))
                h = out
        print(f"  blocks on the card against the CPU, each fed the card's "
              f"input: worst cos {worst[0]:.6f} ({worst[1]})", flush=True)
        assert worst[0] > 0.999, worst

    def post_chain(eng, x):
        """The executor's affine -> SFP<4,4> -> ReLU chain (``_post_loq``,
        plain PyTorch ops) at each of its sites in one forward: its kernel
        launches and device ms per forward."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        sites = Counter()
        orig = sfused._post_loq
        sfused._post_loq = lambda y, c: sites.update(
            [tuple(y.shape)]) or orig(y, c)
        try:
            eager_forward(eng, x)
        finally:
            sfused._post_loq = orig
        launches = ms = 0.0
        for shape, n in sites.items():
            c = ConvKxK(w=None, scale=torch.rand(shape[-1], device=dev) * 0.02
                        + 1e-3, shift=randn(shape[-1], scale=0.5), stride=1,
                        pad=0)
            y = randn(*shape, scale=40.0)
            for _ in range(2):           # warm: the constant tables' copies
                sfused._post_loq(y, c)
            torch.cuda.synchronize()
            calls = 3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    sfused._post_loq(y, c)
                torch.cuda.synchronize()
            evs = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            launches += n * len(evs) / calls
            ms += n * sum(getattr(e, "self_device_time_total", 0)
                          for e in evs) / 1e3 / calls
        print(f"  post chain (plain ops): {sum(sites.values())} sites a "
              f"forward, {launches:.0f} kernel launches, {ms:.4f} ms device "
              f"time per forward at batch {x.shape[0]} (profiler)",
              flush=True)

    @phase("path: InferenceEngine shufflenetv2 SLFP8 fused executor")
    def shufflenet_fused_phase():
        fp32 = InferenceEngine("shufflenetv2", qbit=32, batch_size=B, seed=0,
                               compute_dtype=None)
        sc = derived_scales(fp32, cifar_requests[0])
        eng = InferenceEngine("shufflenetv2", qbit=8, batch_size=B, seed=0,
                              scales=sc)
        assert eng.fused and eng.image_size == 32
        x = batch_of(32)
        want = {"act_quantize": 35, "bn_epilogue": 20}
        sites("shufflenetv2_fused", lambda: eager_forward(eng, x), want)
        logits = serve(eng, "shufflenetv2_fused", want, cifar_requests, 100)
        against_cpu("shufflenetv2", logits[0], cifar_requests[0], qbit=8,
                    scales=sc)
        packed = InferenceEngine("shufflenetv2", qbit=8, batch_size=B,
                                 seed=0, scales=sc, pack_weights=True)
        lp = packed.predict(cifar_requests[0])
        assert np.array_equal(lp.view(np.int32), logits[0].view(np.int32)), \
            "packed logits differ from float-frozen"
        print("  packed uint8 weights: logits bit-equal", flush=True)
        del packed
        throughputs(eng, fp32, "shufflenetv2_fused")
        post_chain(eng, x)
        return eng, sc, logits[0]

    @phase("path: InferenceEngine shufflenetv2 SLFP8 module path, packed "
           "(K4)")
    def shufflenet_module_phase(fused_eng, sc, fused_logits):
        eng = InferenceEngine("shufflenetv2", qbit=8, batch_size=B, seed=0,
                              scales=sc, pack_weights=True, use_pallas=None,
                              fused=False)
        x = batch_of(32)
        want = {"fused_quant_matmul": 37, "act_quantize": 20}
        sites("shufflenetv2_module", lambda: eager_forward(eng, x), want)
        logits = serve(eng, "shufflenetv2_module", want, cifar_requests, 100)
        got, want = logits[0], fused_logits
        c = cos(got, want)
        diff = np.abs(got - want).max()
        top2 = np.sort(want, axis=-1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > 3 * diff
        print(f"  against the fused executor: cos {c:.6f}, "
              f"{int(decisive.sum())} decisive rows", flush=True)
        assert c > 0.98
        assert (np.argmax(got, -1) == np.argmax(want, -1))[decisive].all()
        # the engine's default route (fused) against this one, in turns
        f1, m1, m2, f2 = (images_per_s(e, label) for e, label in (
            (fused_eng, "shufflenetv2_fused_slfp8"),
            (eng, "shufflenetv2_module_slfp8_packed_k4"),
            (eng, "shufflenetv2_module_slfp8_packed_k4"),
            (fused_eng, "shufflenetv2_fused_slfp8")))
        print(f"  b{B}: fused / module path {(f1 + f2) / (m1 + m2):.3f}",
              flush=True)

    @phase("path: InferenceEngine resnet qbit 7 module path")
    def resnet_q7_phase():
        eng = InferenceEngine("resnet", qbit=7, batch_size=B, seed=0)
        assert not eng.fused
        x = batch_of(224)
        sites("resnet_q7_module", lambda: eager_forward(eng, x),
              {"act_quantize": 54})
        logits = serve(eng, "resnet_q7_module", {"act_quantize": 54})
        against_cpu("resnet", logits[0], requests[0], qbit=7)

    def reference_state_dict(model):
        """``model``'s weights as the reference's PyTorch model saves them:
        per module in flax's order, weight / bias, and for BatchNorm also
        the running statistics and the batch counter."""
        mods = dict(model.named_modules())
        sd = {}
        for name in model.flax_order():
            m = mods[name]
            sd[f"{name}.weight"] = m.weight.detach().clone()
            if m.bias is not None:
                sd[f"{name}.bias"] = m.bias.detach().clone()
            if isinstance(m, torch.nn.BatchNorm2d):
                sd[f"{name}.running_mean"] = m.running_mean.clone()
                sd[f"{name}.running_var"] = m.running_var.clone()
                sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
        return sd

    @phase("path: .pth checkpoint")
    def pth_phase(sc):
        import tempfile

        model = models.create_model(
            "shufflenetv2", 32, generator=torch.Generator().manual_seed(3))
        with torch.no_grad():   # BN statistics away from the init's
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.uniform_(-0.1, 0.1)
                    m.running_var.uniform_(0.5, 1.5)
        with tempfile.TemporaryDirectory() as tmp:
            pth = pathlib.Path(tmp) / "shufflenetv2.pth"
            own = pathlib.Path(tmp) / "shufflenetv2_state.pt"
            torch.save(reference_state_dict(model), pth)
            torch.save(model.state_dict(), own)
            eng = InferenceEngine("shufflenetv2", qbit=8, batch_size=B,
                                  scales=sc, checkpoint=str(pth))
            logits = serve(eng, "shufflenetv2_pth",
                           {"act_quantize": 35, "bn_epilogue": 20},
                           cifar_requests, 100)
            direct = InferenceEngine("shufflenetv2", qbit=8, batch_size=B,
                                     scales=sc, checkpoint=str(own))
            ld = direct.predict(cifar_requests[0])
        assert np.array_equal(ld.view(np.int32), logits[0].view(np.int32)), \
            ".pth logits differ from the directly loaded model's"
        print("  the reference-layout .pth serves the directly loaded "
              "model's logits, bit for bit", flush=True)

    @phase("path: module path zoo")
    def zoo_phase():
        # net, image size, launches per forward (None: float32 only)
        for net, size, want in (
                ("vgg16", 32, {"fused_quant_matmul": 3, "act_quantize": 13}),
                ("vgg16_gelu", 32, {"fused_quant_matmul": 3,
                                    "act_quantize": 13}),
                ("resnet_stl", 224, {"fused_quant_matmul": 37,
                                     "act_quantize": 17}),
                ("resnet_swish", 224, {"fused_quant_matmul": 37,
                                       "act_quantize": 17}),
                ("inceptionv3", 224, None)):
            t0 = time.perf_counter()
            reqs = [cifar_requests[0]] if size == 32 else [requests[0]]
            classes = 100 if size == 32 else 1000
            fp32 = InferenceEngine(net, qbit=32, batch_size=B, seed=0,
                                   compute_dtype=None)
            lf = serve(fp32, f"{net}_fp32", {}, reqs, classes)[0]
            c32, _ = against_cpu(net, lf, reqs[0], qbit=32,
                                 compute_dtype=None)
            print(f"  {net} fp32 module path: GPU vs CPU cos {c32:.6f}",
                  flush=True)
            ips32 = sum(engine_graphs[f"{net}_fp32"]["graph_ips"]) / 2
            if want is None:
                continue
            sc = derived_scales(fp32, reqs[0])
            eng = InferenceEngine(net, qbit=8, batch_size=B, seed=0,
                                  scales=sc, pack_weights=True,
                                  use_pallas=None)
            x = batch_of(size)
            sites(f"{net}_module", lambda: eager_forward(eng, x), want)
            logits = serve(eng, f"{net}_module", want, reqs, classes)
            c, cpu = against_cpu(net, logits[0], reqs[0], qbit=8, scales=sc,
                                 pack_weights=True, use_pallas=None)
            print(f"  {net} SLFP8 GPU vs CPU cos {c:.6f}", flush=True)
            if net.startswith("resnet_"):
                blocks_against_cpu(eng, cpu, reqs[0])
            del cpu
            ips8 = sum(engine_graphs[f"{net}_module"]["graph_ips"]) / 2
            print(f"  {net}: SLFP8 / fp32 b{B} {ips8 / ips32:.3f}; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)

    # every other path the engine serves, through its graph against its
    # eager forward (graph_checks): the ResNet-50 conv1 key, the CIFAR
    # MobileNetV1's dw=torch route, the float-frozen module path of every
    # net (cuDNN, K1 at the quantized layers' inputs) and the packed one
    # (K4) of the nets no phase above serves packed; shipped scales
    ZOO_NETS = ("squeezenet", "alexnet", "resnet", "resnet_stl",
                "resnet_swish", "mobilenetv1", "mobilenet", "mobilenet_swish",
                "shufflenetv2", "shufflenetv2_swish", "vgg16", "vgg16_gelu")

    @phase("engine graphs: the other served paths through the engine's "
           "graph against its eager forward")
    def engine_graph_phase():
        cases = [("resnet_fused_conv1_torch", "resnet",
                  dict(policy={"conv1": "torch"})),
                 ("mobilenet_fused_dw_torch", "mobilenet",
                  dict(policy={"dw": "torch"}))]
        cases += [(f"{net}_module_frozen", net,
                   dict(fused=False) if net in FUSABLE else {})
                  for net in ZOO_NETS]
        cases += [(f"{net}_module", net, dict(
            pack_weights=True, use_pallas=None,
            **(dict(fused=False) if net in FUSABLE else {})))
            for net in ("mobilenet", "mobilenet_swish",
                        "shufflenetv2_swish")]
        for path, net, kw in cases:
            t0 = time.perf_counter()
            eng = InferenceEngine(net, qbit=8, batch_size=B, seed=0, **kw)
            assert eng.fused == ("policy" in kw), path
            size = eng.image_size
            graph_checks(eng, path, requests if size == 224
                         else cifar_requests, 1000 if size == 224 else 100)
            del eng
            torch.cuda.empty_cache()
            print(f"  {path}: {time.perf_counter() - t0:.1f} s", flush=True)

    @phase("engine graph: imgnet/shufflenetv2 (ShuffleNet V2 1.0x, "
           "224x224) SLFP8 fused executor")
    def shufflenet_imgnet_phase():
        from cnns_slfp_quantization_tpu_torch.utils import profiling

        t0 = time.perf_counter()
        eng = InferenceEngine("imgnet/shufflenetv2", qbit=8, batch_size=B,
                              seed=0)
        assert eng.fused and eng.graphed and eng.image_size == 224
        want = {"act_quantize": 35, "bn_epilogue": 20}
        # every K1 / K3 site at this form's shapes (the stem's K3 with
        # ReLU and raw output at 112x112, K1 at the units' 56 to 7) against
        # its plain version, bit for bit
        x = torch.from_numpy(requests[0][:B]).to(dev)
        sites("shufflenetv2_imgnet_fused", lambda: eager_forward(eng, x),
              want)
        logits = serve(eng, "shufflenetv2_imgnet_fused", want)
        against_cpu("imgnet/shufflenetv2", logits[0], requests[0], qbit=8)
        # the phases a recorded replay registers, against its device time
        profiling.reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profiling.recording():
            for _ in range(3):
                eng.forward(x).cpu()
            start.record()
            eng.forward(x)
            end.record()
            torch.cuda.synchronize()
        got = {n: profiling.spans(n) for n in sfused.PHASES}
        assert all(g.count == 4 for g in got.values()), \
            {n: g.count for n, g in got.items()}
        last = {n: g.samples[-1].ns / 1e6 for n, g in got.items()}
        total, wall = sum(last.values()), start.elapsed_time(end)
        assert 0 < total <= wall * 1.01, (last, wall)
        print(f"  phases of one replay at batch {B} (ms): "
              + ", ".join(f"{n.split('.')[1]} {v:.4f}"
                          for n, v in last.items())
              + f"; sum {total:.4f} of the request's {wall:.4f} ms on the "
              f"device ({card}); {time.perf_counter() - t0:.1f} s",
              flush=True)
        profiling.reset()
        del eng
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- training
    from cnns_slfp_quantization_tpu_torch.cli import cifar100_train_eval
    from cnns_slfp_quantization_tpu_torch.data.synthetic import (
        SyntheticIterator)
    from cnns_slfp_quantization_tpu_torch.ops.backend import exact_f32
    from cnns_slfp_quantization_tpu_torch.train import loop as tloop
    from cnns_slfp_quantization_tpu_torch.train import optimizers as topt
    from cnns_slfp_quantization_tpu_torch.utils import profiling

    TB = 256                       # the CIFAR driver's default batch
    # K1 at every quantized layer's input (conv0, 13 depthwise, 13
    # pointwise, the FC); route B: K4 at the 13 pointwise convs and the FC,
    # K1 at the other 14 inputs and again in K4's backward
    # and K7, one launch a step (83 parameter tensors)
    WANT_F32 = {"qsgd_update": 1}
    WANT_A = {"act_quantize": 28, **WANT_F32}
    WANT_B = {"fused_quant_matmul": 14, "act_quantize": 28, **WANT_F32}

    def train_data(n, seed=7, classes=100):
        x, y = next(iter(SyntheticIterator(num_classes=classes, batch_size=n,
                                           num_batches=1, seed=seed)))
        return (torch.from_numpy(x).to(dev),
                torch.from_numpy(y.astype(np.int64)).to(dev))

    def train_model(qbit, sc, cdt=torch.bfloat16, use_pallas=None,
                    device=dev):
        return models.create_model(
            "mobilenet", qbit, scales=sc, compute_dtype=cdt,
            use_pallas=use_pallas,
            generator=torch.Generator().manual_seed(0)).to(device)

    def train_scales(x):
        """absmax / 15.5 of each quantized layer's input and weight over one
        training-mode float32 forward of the seed's weights: eval-mode
        maxima (BatchNorm still the identity) flush most training-mode
        activations to the pseudo-zero."""
        from cnns_slfp_quantization_tpu_torch.ops.freeze import quant_layers

        fp = train_model(32, None, cdt=None).train()
        ka, kw, hooks = {}, {}, []
        for _, layer in quant_layers(fp):
            def hook(m, inp, out):
                ka[m.layer_id] = float(inp[0].abs().max())
                kw[m.layer_id] = float(m.weight.abs().max())
            hooks.append(layer.register_forward_hook(hook))
        with torch.no_grad():
            fp(x)
        for h in hooks:
            h.remove()
        n = max(ka) + 1
        return calib.ScaleSet(ka=np.array([ka[i] for i in range(n)]) / 15.5,
                              kw=np.array([kw[i] for i in range(n)]) / 15.5,
                              divisor=15.5, source="chip_smoke.py train absmax")

    def new_step(model, lr=1e-3):
        opt = topt.dsgd(model.parameters(), lr, model.qbit)
        state = tloop.TrainState(model, opt)
        step = tloop.make_train_step(model, opt)
        return state, opt, lambda x, y: step(state, x, y)

    def counted_step(label, step, x, y, want):
        """One step with the counts reset just before it and read just
        after; every wrapper at its predicted launches."""
        step(x, y)                               # warm-up: cuDNN plans
        torch.cuda.synchronize()
        kernels.reset_launches()
        m = step(x, y)
        torch.cuda.synchronize()
        counts = kernels.launches()
        print(f"  {label}: launches in one step at batch {x.shape[0]}: "
              f"{counts} (predicted {want}); loss {float(m['loss']):.5f}",
              flush=True)
        for name, n in counts.items():
            assert n == want.get(name, 0), (name, counts, want)
        return counts

    def backward_check(key):
        """K4's STE backward at one training site on the card against the
        same Function on the CPU from the same inputs: dx, dw, db by K2's
        reordering rule, and cosine > 0.9999."""
        _, shape, xstride, xdt, (k, n), wdt, has_bias, stride, nonneg, od, \
            act, n_out = key
        x = randn(*shape, scale=1.5)
        x = (x.abs() if nonneg else x).to(xdt)
        wq = sfp.quantize_weight(randn(n, k, scale=4.0), 8)
        bias = randn(n, scale=0.1) if has_bias else None
        ka_, kw_ = 0.37, 0.11
        out = {}
        for where in ("cuda", "cpu"):
            xt = x.detach().to(where).requires_grad_(True)
            wt = wq.detach().to(where).requires_grad_(True)
            bt = (None if bias is None
                  else bias.detach().to(where).requires_grad_(True))
            fn = k4.quant_conv1x1 if x.dim() == 4 else k4.quant_dense
            kwargs = dict(stride=stride) if x.dim() == 4 else {}
            y = fn(xt, wt.t(), ka=ka_, kw=kw_, bias=bt, nonneg=nonneg,
                   out_dtype=od, **kwargs)
            g = torch.from_numpy(np.random.default_rng(k + n).standard_normal(
                tuple(y.shape)).astype(np.float32)).to(od).to(where)
            y.backward(g)
            out[where] = (xt.grad, wt.grad, None if bt is None else bt.grad,
                          g)
        gx, gw, gb, g = out["cuda"]
        cx, cw, cb, _ = [None if t is None else t.to(dev)
                         for t in out["cpu"]]
        assert stride == 1, key
        gf = g.float().reshape(-1, n).abs()
        xq = sfp.act_bf16_bits(x.reshape(-1, k), 1.0 / ka_, 8, nonneg).float()
        m = gf.shape[0]
        worst = 1.0
        # each gradient, its reference, the sum of its terms' magnitudes and
        # their count
        for what, got, want, mag, nterms in (
                ("dx", gx, cx, ((gf @ wq.abs()) * kw_).reshape(x.shape), n),
                ("dw", gw, cw, (xq.abs().t() @ gf).t() * (ka_ * kw_), m),
                ("db", gb, cb, gf.sum(0), m)):
            if got is None:
                continue
            rows["k4"].err(k2_check(got, want, False, f"K4 backward {what} "
                                    f"{shape}", mag, nterms))
            c = cos(got.float().cpu().numpy(), want.float().cpu().numpy())
            assert c > 0.9999, (what, shape, c)
            worst = min(worst, c)
        return worst

    @phase("path: QAT training, CIFAR mobilenet, route B (use_pallas=True: "
           "K4 with its STE backward, K1)")
    def train_b_phase():
        t0 = time.perf_counter()
        x, y = train_data(TB)
        sc = train_scales(x)
        model = train_model(8, sc, use_pallas=True)
        state, opt, step = new_step(model)
        # every K1 / K4 call of one step (forward and backward), held
        # against the plain versions and timed at its shape
        sites("mobilenet_train_b", lambda: step(x, y), WANT_B)
        counts = counted_step("route B", step, x, y, WANT_B)
        for key, name in (("k1", "act_quantize"),
                          ("k4", "fused_quant_matmul")):
            rows[key].counted("mobilenet_train_b", counts[name], 1)
        # K4's STE backward at each training site: card against CPU
        seen = record_sites(lambda: step(x, y))
        worst = min(backward_check(key) for key in seen if key[0] == "k4")
        print(f"  K4 backward (dx, dw, db) at {sum(k[0] == 'k4' for k in seen)}"
              f" site shapes: card vs CPU within the reordering bound, worst "
              f"cosine {worst:.7f}", flush=True)
        # one DSGD step from the same weights and batch, card against CPU
        xs, ys = x[:64], y[:64]
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        got = {}
        for where in ("cuda", "cpu"):
            m = train_model(8, sc, use_pallas=True, device=where)
            m.load_state_dict(sd)
            _, _, st = new_step(m)
            met = st(xs.to(where), ys.to(where))
            got[where] = (float(met["loss"]),
                          {k: p.grad.float().cpu() for k, p in
                           m.named_parameters()},
                          {k: v.float().cpu() for k, v in m.state_dict().items()
                           if "running" in k})
        (lg, gg, bg), (lc, gc, bc) = got["cuda"], got["cpu"]
        assert abs(lg - lc) <= 1e-3 * abs(lc), (lg, lc)
        worst = {"weights": (1.0, ""), "bn": (1.0, "")}
        for k in gg:
            kind = "bn" if k.startswith("bn") else "weights"
            worst[kind] = min(worst[kind], (cos(gg[k].numpy(), gc[k].numpy()),
                                            k))
        off = sum(int((~torch.isclose(bg[k], bc[k], rtol=1e-4,
                                      atol=1e-6)).sum()) for k in bg)
        total = sum(v.numel() for v in bg.values())
        rel = max(float(((bg[k] - bc[k]).abs() / (bc[k].abs() + 1e-6)).max())
                  for k in bg)
        print(f"  one DSGD step at batch 64, card vs CPU: loss {lg:.6f} vs "
              f"{lc:.6f}; gradient cosine worst {worst['weights']} (kernels), "
              f"{worst['bn']} (BN); BN running statistics beyond 1e-4: "
              f"{off} of {total}, largest relative difference {rel:.3g}",
              flush=True)
        # the card sums in another order, and at bf16 an activation at a
        # quantizer's bin edge flips by a step and moves the statistics
        # after it; BN's gradients are cancelling sums of bf16 cotangents,
        # where JAX against itself reads 0.97 (tests/test_torch_port_train.py)
        assert worst["weights"][0] > 0.999 and worst["bn"][0] > 0.95, worst
        assert off <= 1e-2 * total, (off, total)
        print(f"  route B: {time.perf_counter() - t0:.1f} s", flush=True)
        return sc

    @phase("path: QAT training learns, 20 DSGD steps on 10 synthetic classes")
    def train_learn_phase():
        model = train_model(8, calib.ScaleSet.ones(28), use_pallas=True)
        _, _, step = new_step(model, lr=0.02)
        losses = []
        for xb, yb in SyntheticIterator(num_classes=10, batch_size=TB,
                                        num_batches=20, seed=0):
            m = step(torch.from_numpy(xb).to(dev),
                     torch.from_numpy(yb.astype(np.int64)).to(dev))
            losses.append(float(m["loss"]))
        print(f"  losses {[round(v, 4) for v in losses]}: first 5 mean "
              f"{np.mean(losses[:5]):.4f}, last 5 {np.mean(losses[-5:]):.4f}",
              flush=True)
        assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses

    @phase("path: cifar100_train_eval (route A: K1), train / save / reload / "
           "resume")
    def train_cli_phase():
        import contextlib
        import io
        import tempfile

        args = ["--Qbits", "8", "--net", "mobilenet", "--optimizer", "DSGD",
                "--compute_dtype", "bfloat16", "--synthetic", "--retrain",
                "--synthetic_batches", "8", "--log_interval", "4"]
        with tempfile.TemporaryDirectory() as tmp:
            kernels.reset_launches()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                state, accs = cifar100_train_eval.main(
                    args + ["--save_model", "--save_state", "--root_dir",
                            tmp])
            torch.cuda.synchronize()
            counts = kernels.launches()
            printed = buf.getvalue()
            print("  " + printed.strip().replace("\n", "\n  "), flush=True)
            # 8 steps of 256 and 8 eval batches of 128, 28 K1 each; K7
            # once a step
            assert counts["act_quantize"] == 28 * 16, counts
            assert counts["qsgd_update"] == 8, counts
            assert sum(counts.values()) == 28 * 16 + 8, counts
            ckpt = pathlib.Path(tmp) / "ckpt" / "cifar-100" / "mobilenet0_tmp"
            log = pathlib.Path(tmp) / "logs" / "cifar-100" / "run.jsonl"
            names = {json.loads(r)["name"]
                     for r in log.read_text().splitlines()}
            assert names == {"epoch_time", "Precision@1", "Precision@5"}, names
            assert ckpt.exists() and pathlib.Path(f"{ckpt}_state").exists()
            with contextlib.redirect_stdout(io.StringIO()):
                _, again = cifar100_train_eval.main(
                    args[:8] + ["--synthetic", "--pretrain", "--pretrain_dir",
                                str(ckpt), "--root_dir", f"{tmp}/eval"])
                resumed, _ = cifar100_train_eval.main(
                    args + ["--max_epochs", "2", "--resume",
                            f"{ckpt}_state", "--root_dir", tmp])
            print(f"  launches {counts}; Precision@1 {accs} reloaded "
                  f"{again}; resumed from step {state.step} to "
                  f"{resumed.step}", flush=True)
            assert again == accs and state.step == 8 and resumed.step == 16

    def train_throughput(label, step, x, y):
        ips = throughput(lambda: step(x, y), x.shape[0], iters=8, warmup=2)
        print(f"  throughput {label}_b{x.shape[0]}: {ips:.1f} images/s "
              f"(training steps)", flush=True)
        return ips

    PHASE_STEPS = 4

    def step_profile(step, x, y, calls=3):
        """Where a step's device time goes: the mean of its own phase spans
        (``train.forward``, ``train.backward``, ``train.optimizer``, CUDA
        events between them) over PHASE_STEPS recorded steps, each waited
        for, so that every step's events are read; torch.profiler's kernel
        time by class and the top kernels over ``calls`` further steps
        after a lead-in step and a marker kernel."""
        profiling.reset()
        with profiling.recording():
            for _ in range(PHASE_STEPS):
                step(x, y)
                torch.cuda.synchronize()
        phases = {n: profiling.spans(n) for n in tloop.PHASES}
        assert all(st.count == PHASE_STEPS for st in phases.values()), {
            n: st.count for n, st in phases.items()}
        with profiling.marked_trace(lambda: step(x, y)) as kept:
            for _ in range(calls):
                step(x, y)
        evs = profiling.by_name(kept, calls)
        classes = {}
        for key, ms, _ in evs:
            c = profiling.kernel_class(key)
            classes[c] = classes.get(c, 0.0) + ms
        return {"phases": {n: st.mean_ns / 1e6 for n, st in phases.items()},
                "classes": classes, "top": evs[:12]}

    @phase("training images/s and where the step's time goes, batch 256")
    def train_speed_phase(sc):
        x, y = train_data(TB)
        routes = {
            "route_A_slfp8_bf16_k1": train_model(8, sc),
            "route_B_slfp8_bf16_k4": train_model(8, sc, use_pallas=True),
            "fp32": train_model(32, sc, cdt=None),
        }
        steps = {k: new_step(m) for k, m in routes.items()}
        # route A's K1 sites (the CLI's route), held and timed as route B's
        step_a = steps["route_A_slfp8_bf16_k1"][2]
        sites("mobilenet_train_a", lambda: step_a(x, y), WANT_A)
        counts = counted_step("route A", step_a, x, y, WANT_A)
        rows["k1"].counted("mobilenet_train_a", counts["act_quantize"], 1)
        ips = {k: [] for k in routes}
        for k in list(routes) + list(routes)[::-1]:     # in turns
            ips[k].append(train_throughput(k, steps[k][2], x, y))
        mean = {k: sum(v) / len(v) for k, v in ips.items()}
        print("  training images/s at batch 256 (mean of two, in turns): "
              + ", ".join(f"{k} {v:.1f}" for k, v in mean.items())
              + f"; route A / fp32 {mean['route_A_slfp8_bf16_k1'] / mean['fp32']:.3f}"
              f", route B / fp32 {mean['route_B_slfp8_bf16_k4'] / mean['fp32']:.3f}",
              flush=True)
        for k in routes:
            try:
                prof = step_profile(steps[k][2], x, y)
            except Exception:  # a measurement; the checks decide success
                print(f"  profile {k}: failed (not measured)\n"
                      f"{traceback.format_exc()}", flush=True)
                continue
            busy = sum(prof["classes"].values())
            wall = sum(prof["phases"].values())
            print(f"  profile {k} per step at batch {TB}: phases "
                  f"{wall:.3f} ms (" + ", ".join(
                      f"{ph} {ms:.3f}" for ph, ms in prof["phases"].items())
                  + f"), kernels {busy:.3f} ms, idle share "
                  f"{1 - busy / wall:.3f}; by class: " + ", ".join(
                      f"{c} {ms:.3f}" for c, ms in prof["classes"].items())
                  + " ms", flush=True)
            for name, ms, n in prof["top"]:
                print(f"    {ms:8.3f} ms  x{n:6.1f}  {name[:110]}", flush=True)

    # ------------------------------------------------ CUDA graphs
    GRAPH_STEPS = 8

    DROP_STEPS, DB = 4, 32

    def dropout_graph():
        """SqueezeNet 1.0 (Dropout(0.5) before its classifier) at 224, batch
        DB, SLFP8: DROP_STEPS replays of the captured step, drawing from a
        generator registered with the graph, against eager steps on a
        generator seeded alike: the same dropout outputs, losses, weights
        and momentum bit for bit; about half the nonzero inputs dropped,
        and another mask each step."""
        rng = np.random.default_rng(11)
        x0 = torch.from_numpy(rng.standard_normal((DB, 224, 224, 3)).astype(
            np.float32)).to(dev)
        y0 = torch.from_numpy(rng.integers(0, 1000, DB)).to(dev)
        xs = [_perturbed(x0, i) for i in range(DROP_STEPS)]

        def fresh():
            """The seed's model, a DSGD state, the step, the generator and
            the dropout's (output, dropped, nonzero input) of each call."""
            model = models.create_model(
                "squeezenet", 8, scales=calib.ScaleSet.ones(26),
                compute_dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(0)).to(dev)
            opt = topt.dsgd(model.parameters(), 1e-3, model.qbit)
            seen = []
            model.drop.register_forward_hook(lambda m, i, o: seen.append(
                (o.detach(), (o == 0) & (i[0] != 0), i[0] != 0)))
            return (tloop.TrainState(model, opt),
                    tloop.make_train_step(model, opt, has_dropout=True),
                    torch.Generator(device=dev).manual_seed(1234), seen)

        state, step, gen, _ = fresh()
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            try:
                tloop.GraphedTrainStep(step, state, x0, y0, gen)
            except RuntimeError as e:
                print(f"  dropout: this torch cannot register a generator "
                      f"with a graph, and GraphedTrainStep refuses: {e}",
                      flush=True)
                return
            raise AssertionError("a dropout step captured without its "
                                 "generator")
        kernels.reset_launches()
        step(state, x0, y0, gen)
        torch.cuda.synchronize()
        per_step = {k: n for k, n in kernels.launches().items() if n}
        # the step's K1 sites, held against the plain version and timed:
        # the dropout graph's row gets their time, plain time and bound
        state, step, gen, _ = fresh()
        sites("qat_graph_dropout_squeezenet",
              lambda: step(state, x0, y0, gen), per_step)
        got = {}
        for mode in ("eager", "graph"):
            state, step, gen, seen = fresh()
            if mode == "graph":
                g = tloop.GraphedTrainStep(step, state, x0, y0, gen)
                assert {k: n for k, n in g.launches.items() if n} == \
                    per_step, (g.launches, per_step)
                run = g
            else:
                def run(x, y, state=state, step=step, gen=gen):
                    return step(state, x, y, gen)
            outs = []
            for x in xs:
                loss = run(x, y0)["loss"].clone()
                outs.append((loss,) + tuple(t.clone() for t in seen[-1]))
            torch.cuda.synchronize()
            model, opt = state.model, state.optimizer
            got[mode] = {
                "outs": [bits(o[:3]) for o in outs],
                "weights": bits(model.parameters()),
                "momentum": bits(opt.state[p]["momentum"]
                                 for p in model.parameters())}
        for key in ("weights", "momentum"):
            assert same_bytes(got["graph"][key], got["eager"][key]), key
        for i, (a, b) in enumerate(zip(got["graph"]["outs"],
                                       got["eager"]["outs"])):
            assert same_bytes(a, b), ("dropout step", i)
        drops = [(float(d.sum()), float(nz.sum())) for *_, d, nz in outs]
        for d, nz in drops:
            assert nz > 1000 and 0.45 < d / nz < 0.55, drops
        assert all(not torch.equal(outs[i][2], outs[i + 1][2])
                   for i in range(DROP_STEPS - 1)), "a mask repeated"
        idle = replayed("qat_graph_dropout_squeezenet",
                        "squeezenet dropout graph replay",
                        lambda: g(x0, y0), per_step)
        print(f"  dropout (SqueezeNet, batch {DB}, 224): {DROP_STEPS} "
              f"replays on a registered generator give the eager steps' "
              f"dropout outputs, losses, weights and momentum bit for bit; "
              f"dropped {[round(d / nz, 4) for d, nz in drops]} of the "
              f"nonzero inputs, another mask each step; launches a step "
              f"{per_step}; idle share of a replay {idle} ({card})",
              flush=True)

    @phase("CUDA graphs: the QAT step captured and replayed against eager "
           "steps (routes A, B and float32, batch 256), the CIFAR "
           "MobileNetV1 engine's graph (batch 256)")
    def graph_phase(sc):
        x0, y0 = train_data(TB)
        xs = [_perturbed(x0, i) for i in range(GRAPH_STEPS)]
        makes = {
            "route_A": (lambda: train_model(8, sc), WANT_A),
            "route_B": (lambda: train_model(8, sc, use_pallas=True), WANT_B),
            "float32": (lambda: train_model(32, sc, cdt=None), WANT_F32),
        }

        def fresh(make):
            model = make()
            opt = topt.dsgd(model.parameters(), 1e-3, model.qbit)
            return (tloop.TrainState(model, opt),
                    tloop.make_train_step(model, opt))

        for label, (make, want) in makes.items():
            # 8 replays against 8 eager steps, each from the seed's state
            got = {}
            for mode in ("eager", "graph"):
                state, step = fresh(make)
                if mode == "graph":
                    g = tloop.GraphedTrainStep(step, state, x0, y0)
                    per_step = {k: n for k, n in g.launches.items() if n}
                    run = g
                else:
                    def run(x, y, state=state, step=step):
                        return step(state, x, y)
                losses = [run(x, y0)["loss"].clone() for x in xs]
                torch.cuda.synchronize()
                model, opt = state.model, state.optimizer
                got[mode] = {
                    "losses": bits(losses),
                    "weights": bits(model.parameters()),
                    "momentum": bits(opt.state[p]["momentum"]
                                     for p in model.parameters()),
                    "bn": bits(b for n, b in model.named_buffers()
                               if "running" in n),
                    "steps": (state.step, opt.count)}
            for key in ("losses", "weights", "momentum", "bn"):
                assert same_bytes(got["graph"][key], got["eager"][key]), \
                    (label, key)
            assert got["graph"]["steps"] == got["eager"]["steps"] == \
                (GRAPH_STEPS, GRAPH_STEPS), got
            assert per_step == {k: v for k, v in want.items() if v}, \
                (label, per_step, want)
            print(f"  {label}: {GRAPH_STEPS} replays of the captured step "
                  f"give the eager steps' losses, weights, momentum and BN "
                  f"statistics bit for bit; launches a step {per_step} "
                  f"(counted at the capture)", flush=True)
            # images/s in turns, two rounds: eager, graph, graph, eager
            state, step = fresh(make)
            ips = {"eager": [], "graph": []}
            for mode in ("eager", "graph", "graph", "eager") * 2:
                ips[mode].append(scan_train_throughput(
                    step, state, x0, y0, steps=GRAPH_STEPS,
                    graph=mode == "graph"))
            mean = {k: sum(v) / len(v) for k, v in ips.items()}
            g = tloop.GraphedTrainStep(step, state, x0, y0)
            idle = {"eager": busy_line(f"{label} eager step",
                                       lambda: step(state, x0, y0))[0],
                    "graph": replayed(f"qat_graph_{label}",
                                      f"{label} graph replay",
                                      lambda: g(x0, y0), g.launches)}
            print(f"  {label} training images/s at batch {TB} in turns "
                  f"(eager, graph, graph, eager, twice): eager "
                  f"{[round(v, 1) for v in ips['eager']]}, graph "
                  f"{[round(v, 1) for v in ips['graph']]}; means "
                  f"{mean['eager']:.1f} / {mean['graph']:.1f} = graph "
                  f"{mean['graph'] / mean['eager']:.3f}x; idle share eager "
                  f"{idle['eager']}, graph {idle['graph']} ({card})",
                  flush=True)

        dropout_graph()

        # fused CIFAR MobileNetV1 (K1, K3, K5) at batch 256 through the
        # engine's own graph, unit scales (a random-init model's
        # activations stay off the pseudo-zero); fused ResNet-50's forward
        # graph is the engine's on every served path (serve())
        mob = InferenceEngine("mobilenet", qbit=8, batch_size=TB, seed=0,
                              scales=calib.ScaleSet.ones(28))
        xm = np.random.default_rng(3).standard_normal(
            (TB, 32, 32, 3)).astype(np.float32)
        per_fwd = graph_checks(mob, "mobilenet_fused_graph", [xm], 100)
        assert per_fwd == {"act_quantize": 2, "bn_epilogue": 18,
                           "dw3x3": 9}, per_fwd
        assert bool((torch.from_numpy(mob.predict(xm)).std(0) > 0).any())
        for key, name in (("k1", "act_quantize"), ("k3", "bn_epilogue"),
                          ("k5", "dw3x3")):
            rows[key].counted("mobilenet_fused_graph",
                              per_fwd[name] * BUSY_CALLS, BUSY_CALLS)

    # ------------------------------------------------ the PTQ workflow
    from cnns_slfp_quantization_tpu_torch.calib import calibrate as tcal
    from cnns_slfp_quantization_tpu_torch.cli import (
        imgnet_train_eval,
        ptq_sweep,
        recovery,
    )
    from cnns_slfp_quantization_tpu_torch.data import subset as tsubset
    from cnns_slfp_quantization_tpu_torch.models import resnet50_fused as rf
    from cnns_slfp_quantization_tpu_torch.models.resnet50 import STAGES
    from cnns_slfp_quantization_tpu_torch.utils import native as tnative

    def echoed(fn, *a, **k):
        """fn's result and what it printed, echoed indented."""
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(*a, **k)
        text = buf.getvalue()
        print("  " + text.strip().replace("\n", "\n  "), flush=True)
        return out, text

    def counted(fn, *a, **k):
        """echoed(fn), with the launch counts of that run alone."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        out, text = echoed(fn, *a, **k)
        torch.cuda.synchronize()
        return out, text, kernels.launches()

    def only_k1(counts, n, label, steps=0):
        """``counts`` launched K1 n times, K7 once a training step and no
        other kernel."""
        assert (counts["act_quantize"] == n
                and counts["qsgd_update"] == steps
                and sum(counts.values()) == n + steps), \
            (label, n, steps, counts)

    # the largest relative difference allowed between a maximum the card
    # calibrates and the CPU's (weights and the image's maximum bit-equal):
    # both sum in float32 in another order
    CAL_RTOL = 1e-5
    CAL_IMAGES = 256

    def k2_sites(path, call):
        """K2 at every call of one forward of ``path``: its device time,
        its plain version's, torch.matmul's on the same operands (bf16,
        unfused) and the bound from the bytes of each operand read once
        and the output written once (or the operations), summed per
        forward into the K2 row of ``path``."""
        seen, orig = [], k2.qmm_fused

        def record(x, w, s, t, **kw):
            seen.append((x, w, s, t, kw))
            return orig(x, w, s, t, **kw)

        record.__dict__ = orig.__dict__     # K2 counts through this name
        k2.qmm_fused = record
        try:
            call()
        finally:
            k2.qmm_fused = orig
        torch.cuda.synchronize()
        tot = Counter()
        for x, w, s, t, kw in seen:
            (m, k), n = x.shape, w.shape[1]
            ms = kernel_ms(lambda: orig(x, w, s, t, **kw))
            pms = median_ms(lambda: k2.qmm_plain(x, w, s, t, **kw), iters=5,
                            inner=1)
            xb = x.to(torch.bfloat16)
            wb = (w if w.dtype == torch.bfloat16
                  else sfp.slfp34_decode_bits(w).to(torch.bfloat16))
            lms = kernel_ms(lambda: torch.matmul(xb, wb))
            out = torch.empty((), dtype=kw.get("out_dtype", torch.bfloat16))
            res = kw.get("residual")
            nbytes = (x.numel() * x.element_size()
                      + w.numel() * w.element_size() + n * 8
                      + m * n * out.element_size()
                      + (0 if res is None
                         else res.numel() * res.element_size()))
            ops = 2 * m * k * n
            rows["k2"].add(1, ms, pms, nbytes, ops, BF16_FLOPS, lms,
                           path=path)
            tot.update(ms=ms, plain=pms, lib=lms,
                       bound=bound_ms(nbytes, ops, BF16_FLOPS)[0])
        print(f"  {path}: K2 at its {len(seen)} calls a forward: "
              f"{tot['ms']:.4f} ms, plain {tot['plain']:.4f} ms, "
              f"torch.matmul unfused {tot['lib']:.4f} ms, bound "
              f"{tot['bound']:.4f} ms ({card})", flush=True)

    @phase("path: calibrate -> serve, ResNet-50 SLFP8 at 224, 1000 classes")
    def calibrate_serve_phase(shipped):
        import tempfile

        x = np.random.default_rng(11).standard_normal(
            (CAL_IMAGES, 224, 224, 3)).astype(np.float32)
        batches = [x[i:i + B] for i in range(0, CAL_IMAGES, B)]
        res = {}
        for where in ("cuda", "cpu"):
            t0 = time.perf_counter()
            # the engine's weights (seed 0), float32, capture="absmax"
            cap = models.create_model(
                "resnet", 32, capture="absmax",
                generator=torch.Generator().manual_seed(0)).to(where)
            kernels.reset_launches()
            res[where] = tcal.calibrate(cap, batches, max_images=CAL_IMAGES)
            if where == "cuda":   # a float32 pass: no kernel of the port
                torch.cuda.synchronize()
                assert sum(kernels.launches().values()) == 0
            print(f"  calibrated on the {where} over {CAL_IMAGES} images "
                  f"(exact float32) in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            del cap
        g, c = res["cuda"], res["cpu"]
        worst = {}
        for kind in ("input_absmax", "weight_absmax", "output_absmax"):
            gd, cd = getattr(g, kind), getattr(c, kind)
            assert set(gd) == set(cd) == set(range(54)), kind
            worst[kind] = max((abs(gd[i] - cd[i]) / cd[i], i) for i in cd)
        print(f"  card vs CPU, worst relative difference (layer): weights "
              f"{worst['weight_absmax']}, inputs {worst['input_absmax']} "
              f"(in0 {g.input_absmax[0]} vs {c.input_absmax[0]}), outputs "
              f"{worst['output_absmax']}", flush=True)
        assert worst["weight_absmax"][0] == 0
        assert g.input_absmax[0] == c.input_absmax[0]
        assert max(worst["input_absmax"][0],
                   worst["output_absmax"][0]) <= CAL_RTOL, worst
        with tempfile.TemporaryDirectory() as tmp:
            path = calib.save_scales("resnet50_calibrated", g.ka_max(),
                                     g.kw_max(), 15.5,
                                     source="chip_smoke calibration",
                                     out_dir=tmp)
            sc = calib.load_scales_path(path)
            # the executor's guard: conv1 and the downsample conv share
            # the stage input's quantize
            for _, _, _, base in STAGES:
                assert sc.ka[base] == sc.ka[base + 1], base
            eng = InferenceEngine("resnet", qbit=8, batch_size=B,
                                  image_size=224, seed=0, scales=str(path))
            mod = InferenceEngine("resnet", qbit=8, batch_size=B,
                                  image_size=224, seed=0, scales=str(path),
                                  fused=False)
        assert eng.fused and not mod.fused
        sites("resnet_calibrated",
              lambda: eager_forward(eng, batch_of(224)),
              {"act_quantize": 5, "bn_epilogue": 14})
        k2_sites("resnet_calibrated",
                 lambda: eager_forward(eng, batch_of(224)))
        lf = serve(eng, "resnet_calibrated", {
            "act_quantize": 5, "qmm_fused": 18, "bn_epilogue": 14,
            "bottleneck_chain": 7})
        sites("resnet_calibrated_module",
              lambda: eager_forward(mod, batch_of(224)),
              {"act_quantize": 54})
        lm = serve(mod, "resnet_calibrated_module", {"act_quantize": 54})
        worst = min(cos(a, b) for a, b in zip(lf, lm))
        print(f"  fused executor against the module path on the calibrated "
              f"constants: worst cos {worst:.6f} over {len(lf)} requests",
              flush=True)
        assert worst > 0.995
        assert all(same_top1(a, b) for a, b in zip(lf, lm))
        if shipped is not None:
            # the same executor and weights on the shipped constants, in
            # turns: the constants change values, not shapes
            ips = [images_per_s(e, label) for e, label in (
                (shipped, "resnet_shipped"), (eng, "resnet_calibrated"),
                (eng, "resnet_calibrated"), (shipped, "resnet_shipped"))]
            print(f"  calibrated / shipped constants, images/s in turns: "
                  f"{(ips[1] + ips[2]) / (ips[0] + ips[3]):.3f}", flush=True)
        return eng

    @phase("path: ptq_sweep, AlexNet (JAX's default net), ImageNet size, "
           "qbits 32 8 7, bf16")
    def ptq_sweep_phase():
        res, text, counts = counted(ptq_sweep.main, [
            "--synthetic", "--eval_batch_size", "32", "--compute_dtype",
            "bfloat16"])
        line = json.loads(text.strip().splitlines()[-1])
        assert list(line) == ["32", "8", "7"], line
        for q, m in line.items():
            assert m["images"] == 8 * 32, (q, m)
            assert all(np.isfinite(m[k]) and 0 <= m[k] <= 100
                       for k in ("top1", "top5")), (q, m)
        assert "PTQ top-1 loss @ Qbits=8" in text
        # K1 at the input of each of AlexNet's 8 quantized layers, 8
        # batches each at qbit 8 and 7; none at qbit 32
        only_k1(counts, 2 * 8 * 8, "ptq_sweep")
        print(f"  launches {counts}: K1 8 per quantized forward", flush=True)
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (32, 224, 224, 3)).astype(np.float32)).to(dev)
        for q in (8, 7):
            m = models.create_model(
                "alexnet", q, compute_dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(0)).to(dev).eval()

            def forward():
                with torch.no_grad(), exact_f32():   # as the eval step
                    m(x)

            sites(f"ptq_sweep_alexnet_q{q}", forward, {"act_quantize": 8})
            # the sweep's own launches: 8 forwards at each quantized qbit
            rows["k1"].counted(f"ptq_sweep_alexnet_q{q}",
                               counts["act_quantize"] // 2, 8)
            del m

    @phase("path: imgnet_train_eval --net resnet --Qbits 8 --compute_dtype "
           "bfloat16 --synthetic")
    def imgnet_phase():
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            (_, accs), text, counts = counted(imgnet_train_eval.main, [
                "--net", "resnet", "--Qbits", "8", "--compute_dtype",
                "bfloat16", "--synthetic", "--root_dir", tmp])
        # two epochs' smoke evals of 100 images in batches of 16, K1 at
        # each of the 54 quantized layers' inputs
        assert text.count("(100 images)") == 2 and len(accs) == 2, text
        assert all(0 <= a <= 100 for a in accs)
        only_k1(counts, 54 * 2 * -(-100 // 16), "imgnet_train_eval")
        m = models.create_model(
            "resnet", 8, compute_dtype=torch.bfloat16,
            generator=torch.Generator().manual_seed(0)).to(dev).eval()
        x = batch_of(224)[:16]

        def forward():
            with torch.no_grad(), exact_f32():
                m(x)

        sites("imgnet_resnet_bf16", forward, {"act_quantize": 54})
        rows["k1"].counted("imgnet_resnet_bf16", counts["act_quantize"],
                           2 * -(-100 // 16))

    def write_cifar100(root, n_train, n_test, seed=0):
        """cifar-100-python/{train,test} in the published pickle layout
        (uint8 rows of 3072 in CHW order, ``fine_labels``), from a seed."""
        import pickle

        rng = np.random.default_rng(seed)
        d = pathlib.Path(root) / "cifar-100-python"
        d.mkdir(parents=True)
        labels = {}
        for name, n in (("train", n_train), ("test", n_test)):
            labels[name] = rng.integers(0, 100, n)
            with open(d / name, "wb") as f:
                pickle.dump({"data": rng.integers(0, 256, (n, 3072),
                                                  dtype=np.uint8),
                             "fine_labels": labels[name].tolist()}, f)
        return labels

    @phase("path: cifar100_train_eval from a CIFAR-100 on disk")
    def cifar_disk_phase():
        import tempfile

        assert tnative.available(), f"native library: {tnative.error}"
        print(f"  native library built on this host: {tnative.path}",
              flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            labels = write_cifar100(f"{tmp}/data", 2560, 1000)
            args = ["--net", "mobilenet", "--data_dir", f"{tmp}/data"]
            _, text, counts = counted(cifar100_train_eval.main, args + [
                "--pre_reference", "--root_dir", f"{tmp}/cal"])
            for name in ("max_inout_mobilenet.txt", "max_weight_mobilenet.txt",
                         "calib/mobilenet_calibrated.json"):
                assert (pathlib.Path(tmp) / "cal" / name).stat().st_size, name
            first = (pathlib.Path(tmp) / "cal" /
                     "max_inout_mobilenet.txt").read_text().splitlines()[:2]
            print(f"  --pre_reference wrote its three files; {first}",
                  flush=True)
            assert sum(counts.values()) == 0, counts   # a float32 pass
            (state, accs), text, counts = counted(
                cifar100_train_eval.main, args + [
                    "--Qbits", "8", "--compute_dtype", "bfloat16",
                    "--optimizer", "DSGD", "--retrain", "--train_subset",
                    "0.06", "--root_dir", f"{tmp}/run"])
        assert "augmenter: native" in text, text
        n = len(tsubset.stratified_indices(labels["train"], 0.06))
        steps, evals = -(-n // 256), -(-1000 // 128)
        assert state.step == steps and len(accs) == 1, (n, state.step)
        assert "(1000 images)" in text
        only_k1(counts, 28 * (steps + evals), "cifar100_train_eval", steps)
        print(f"  the 6% subset: {n} of 2560 images, {steps} step(s); "
              f"launches {counts}", flush=True)

    @phase("path: recovery, mobilenet (CIFAR), qbit 8")
    def recovery_phase():
        row, _, counts = counted(
            recovery.run, "mobilenet", 8, fp32_epochs=2, train_images=2560,
            batch=128, subset_fraction=0.06, qat_epochs=2, eval_images=512,
            seed=0, device="cuda")
        _, tr_y = recovery._train_arrays(2560, 128,
                                         recovery._task("mobilenet"), seed=0)
        n = len(tsubset.stratified_indices(tr_y, 0.06, seed=0))
        assert row["subset_images"] == n, (row, n)
        assert all(np.isfinite(row[k]) and 0 <= row[k] <= 100
                   for k in ("acc_fp32", "acc_ptq", "acc_recovered")), row
        # float32 compute, as JAX's recovery: the quantizers are the plain
        # float ones there (JAX runs no Pallas kernel either)
        print(f"  subset {n} images; launches {counts}", flush=True)

    @phase("path: block-input levers, ResNet-50 at batch 8, 224")
    def blockin_phase():
        x = torch.from_numpy(requests[0][:8]).to(dev)
        counts = {}
        for pol in ({"conv1": "torch", "conv3": "torch", **NO_CHAIN},
                    {"conv3": "torch", **NO_CHAIN}):
            eng = InferenceEngine("resnet", qbit=8, batch_size=8,
                                  image_size=224, seed=0, policy=pol)
            out = {}
            for mode in rf.BLOCKIN_FUSE:
                def fwd(mode=mode):
                    with torch.inference_mode():
                        return rf.fused_apply(eng.executor, x, policy=pol,
                                              _diag_blockin_fuse=mode)
                fwd()
                torch.cuda.synchronize()
                kernels.reset_launches()
                y = fwd()
                torch.cuda.synchronize()
                counts[(pol.get("conv1", "kernel"), mode)] = \
                    kernels.launches()
                out[mode] = y.float().cpu().numpy()
            base = out["consumer"]
            assert np.array_equal(out["pallas_dual"].view(np.int32),
                                  base.view(np.int32)), pol
            err = float(np.abs(out["packed"] - base).max())
            assert err < 1e-2 and same_top1(out["packed"], base), (pol, err)
            c = cos(out["producer"], base)
            assert c > 0.995 and same_top1(out["producer"], base), (pol, c)
            print(f"  {pol}: pallas_dual bit-equal to consumer; packed max "
                  f"|diff| {err:.3g}, same top-1; producer cos {c:.6f}",
                  flush=True)
        for key, cnt in counts.items():
            print(f"  launches {key}: {dict(cnt)}", flush=True)
        dual, cons = counts[("torch", "pallas_dual")], \
            counts[("torch", "consumer")]
        # the 12 mid-stage block outputs: K3's dual form, or K3 raw and the
        # consumer's K1
        assert dual["bn_epilogue_dual"] == 12 == cons["act_quantize"] - \
            dual["act_quantize"] and cons["bn_epilogue_dual"] == 0, counts
        assert cons["bn_epilogue"] == dual["bn_epilogue"], counts
        eng = InferenceEngine("resnet", qbit=8, batch_size=8, image_size=224,
                              seed=0, policy={"conv1": "torch",
                                              "conv3": "torch", **NO_CHAIN})
        for mode in ("consumer", "pallas_dual"):
            cnt = counts[("torch", mode)]

            def fwd(mode=mode):
                with torch.inference_mode():
                    rf.fused_apply(eng.executor, x, policy=eng.policy,
                                   _diag_blockin_fuse=mode)

            sites(f"blockin_{mode}", fwd, {"act_quantize": cnt["act_quantize"],
                                           "bn_epilogue": cnt["bn_epilogue"]})
            for key, name in (("k1", "act_quantize"), ("k3", "bn_epilogue")):
                rows[key].counted(f"blockin_{mode}", cnt[name], 1)

    def k2_against_plain(path, call):
        """Every K2 call of one run of ``call`` held against its plain
        version on the same operands (``bench_gemm.check_gemm``)."""
        seen, orig = [], k2.qmm_fused

        def record(x, w, s_, t_, **kw):
            seen.append((x, w, s_, t_, kw))
            return orig(x, w, s_, t_, **kw)

        record.__dict__ = orig.__dict__     # K2 counts through this name
        k2.qmm_fused = record
        try:
            call()
        finally:
            k2.qmm_fused = orig
        forms = Counter()
        for x, w, s_, t_, kw in seen:
            got = orig(x, w, s_, t_, **kw)
            want = k2.qmm_plain(x, w, s_, t_, **kw)
            torch.cuda.synchronize()
            r = kw.get("quant_in_recip")
            xq = k1.act_quantize_plain(x, r) if r is not None else x
            wv = (sfp.slfp34_decode_bits(w) if w.dtype == torch.uint8
                  else w).to(torch.bfloat16)
            mag = bench_gemm.gemm_mag(xq, wv, s_, t_, kw.get("residual"))
            rows["k2"].err(k2_check(
                got, want, kw.get("quant_out_recip") is not None,
                f"K2 {path} M={x.shape[0]} N={w.shape[1]}", mag,
                x.shape[1]))
            forms[(r is not None, kw.get("quant_out_recip") is not None,
                   str(kw.get("out_dtype", torch.bfloat16)))] += 1
        print(f"  {path}: K2 at its {len(seen)} calls against the plain "
              f"version by the reordering rule; forms (quantize in, "
              f"quantize out, out type): {dict(forms)}", flush=True)

    @phase("path: bench_quant_sites at batch 64, fused ResNet-50 (each "
           "activation-quantize site priced; default and JAX placements)")
    def quant_sites_phase():
        from cnns_slfp_quantization_tpu_torch.utils import bench_quant_sites

        for case, pol in bench_quant_sites.CASES.items():
            got = bench_quant_sites.measure(B, case, steps=16)
            for r in got:
                assert r["finite"], r
                assert r.get("bit_equal_to_default", True), r
            base = got[0]["img_per_sec"]
            print(f"  {case} ({pol}), batch {B}: images/s all "
                  f"{base:.1f}; " + "; ".join(
                      f"{r['config']} {r['img_per_sec']:.1f} "
                      f"({r['img_per_sec'] / base - 1:+.4f})"
                      for r in got[1:]) + f" ({card})", flush=True)
            for r in (got[0], got[-1]):
                path = f"quant_sites_{case}_{r['config'].split()[0]}"
                for key, name in (("k1", "act_quantize"), ("k2", "qmm_fused"),
                                  ("k3", "bn_epilogue"),
                                  ("k6", "bottleneck_chain")):
                    if r["launches"].get(name):
                        rows[key].counted(path, r["launches"][name], 1)
        # the lever's K2 forms with every site off (raw f32 out for cuDNN,
        # raw bf16 in) against the plain version
        eng = InferenceEngine("resnet", qbit=8, batch_size=B, image_size=224,
                              seed=0)
        x = torch.from_numpy(requests[0]).to(dev)

        def ceiling():
            with torch.inference_mode():
                rf.fused_apply(eng.executor, x, _diag_quant_sites=frozenset())

        k2_against_plain("quant_sites_default_none", ceiling)

    # ------------------------------------------------ the ported tools
    @phase("tools: the measuring tools in-process at a small size "
           "(roofline at batch 64, QAT cost by quantize class, packed "
           "weights, block input, ShuffleNetV2 gate, act-variant "
           "calibration, task probe)")
    def tools_phase(sh_scales):
        import tempfile

        from cnns_slfp_quantization_tpu_torch.utils import (
            bench_blockin,
            bench_packed_fused,
            bench_roofline,
            bench_shufflenet_fused,
            bench_train_sites,
            calibrate_act_variants,
            tune_task_signal,
        )

        t0 = time.perf_counter()
        # the slice's path: every row of the default forward at batch 64,
        # each kernel launched by its wrapper; the launches recorded are
        # those of the executor's one eager forward that run_case makes with
        # the counts set to 0 just before it (the rows' own launches are
        # compared with them there: launches_agree)
        eng = bench_roofline.engine(B, 224, dev)
        summ = bench_roofline.run_case("default", eng, dev, card, runs=1,
                                       engine_iters=8)
        for key, cls in (("k1", "K1"), ("k2", "K2"), ("k3", "K3"),
                         ("k6", "K6")):
            rows[key].counted("tools_roofline",
                              summ["executor_launches"][cls], 1)
        del eng
        assert not summ["rows_above_bound"], summ["rows_above_bound"]
        assert summ["launches_agree"], (summ["executor_launches"],
                                        summ["row_launches"])
        print(f"  roofline, default policy, batch {B}: rows "
              f"{summ['total_ms']:.3f} ms against their bound "
              f"{summ['total_roofline_ms']:.3f} ms (roofline_frac "
              f"{summ['roofline_frac']:.3f}); the engine "
              f"{summ['engine_ms_per_batch']:.3f} ms a batch; launches a "
              f"forward {summ['executor_launches']} ({card})", flush=True)
        # the QAT step by quantize class, CIFAR mobilenet at JAX's batch;
        # the launches are those of the prod variant's one eager step, the
        # counts set to 0 just before it
        ts = bench_train_sites.run_net("mobilenet", batch=256, size=32,
                                       n_classes=100, dev=dev, steps=2,
                                       card=card)
        assert all(ts["replay_bit_equal_to_eager"].values()), ts
        step_launches = ts["eager_step_launches"]["prod"]
        assert step_launches.get("act_quantize"), step_launches
        for key, row in rows.items():
            if step_launches.get(row.head["name"]):
                row.counted("tools_train_sites",
                            step_launches[row.head["name"]], 1)
        # packed against float weights on the fused executor: the codes
        # decode to the float-frozen values, so the logits are bit-equal
        (flt, lf), (pk, lp) = (bench_packed_fused.measure(p, B, 224, dev,
                                                          iters=4)
                               for p in (False, True))
        assert flt["finite"] and pk["finite"], (flt, pk)
        cmp = bench_packed_fused.compare(lf, lp)
        assert cmp["bit_equal"], cmp
        assert pk["weight_MB"] < flt["weight_MB"], (flt, pk)
        # the block-input guard: the dual form is the consumer placement
        bi = bench_blockin.run(B, ["consumer", "pallas_dual"], 224, dev,
                               steps=4)
        assert all(g["outputs_bit_identical"] for g in bi["guard"]), bi
        # ShuffleNetV2's gate, on the scales derived for its random weights
        assert bench_shufflenet_fused.main(
            ["--batch", str(B), "--steps", "2"], scales=sh_scales) == 0
        # act-variant calibration, 2 steps, into a directory of its own
        with tempfile.TemporaryDirectory() as tmp:
            calibrate_act_variants.calibrate_variant(
                "stl", train_steps=2, batch=32, size=224, calib_images=128,
                out_dir=tmp)
            got = json.loads((pathlib.Path(tmp) /
                              "resnet50_stl_imgnet.json").read_text())
        shipped = json.loads((REPO / PKG / "calib" / "constants" /
                              "resnet50_stl_imgnet.json").read_text())
        assert list(got) == list(shipped), (list(got), list(shipped))
        assert all(len(got[k]) == len(shipped[k])
                   for k in ("ka_max", "kw_max")), got
        assert all(np.isfinite(v) and v > 0 for k in ("ka_max", "kw_max")
                   for v in got[k]), got
        # one probe of the synthetic task
        acc = tune_task_signal.probe("mobilenet", 0.25, train_steps=10,
                                     eval_images=128, proto_res=None,
                                     classes=None, lr=None, seed=0)
        assert 0.0 <= acc <= 100.0, acc
        print(f"  tools: QAT cost_ms {ts['cost_ms']}, idle "
              f"{ts['idle_share']}; weight MB float / packed "
              f"{flt['weight_MB']:.2f} / {pk['weight_MB']:.2f} (logits "
              f"bit-equal); "
              f"probe fp32 top-1 {acc:.2f}%; the phase took "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)

    # ------------------------------------------------ determinism and mesh
    def same_state(a, b):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(a, b))

    def step_from(make, x, y):
        """One step of a fresh model from the seed's weights: the loss and
        the parameters after it."""
        model = make()
        state, _, step = new_step(model)
        m = step(x, y)
        torch.cuda.synchronize()
        return float(m["loss"]), [p.detach().clone()
                                  for p in model.parameters()]

    @phase("determinism: two train steps from one state, the same bits "
           "(float32 and route B, batch 256)")
    def determinism_phase(sc):
        x, y = train_data(TB)
        makes = {"float32": lambda: train_model(32, None, cdt=None),
                 "route B": lambda: train_model(8, sc, use_pallas=True)}
        for label, make in makes.items():
            (la, pa), (lb, pb) = step_from(make, x, y), step_from(make, x, y)
            assert la == lb and same_state(pa, pb), label
            # the setting before the repair, for the record
            tloop.exact_f32 = _parent_exact_f32
            try:
                (_, qa), (_, qb) = step_from(make, x, y), step_from(make, x, y)
            finally:
                tloop.exact_f32 = exact_f32
            moved = sum(int((u != v).sum()) for u, v in zip(qa, qb))
            print(f"  {label}: two steps give the same bits (loss {la!r}); "
                  f"without deterministic cuDNN {moved} of "
                  f"{sum(p.numel() for p in qa)} weights differed between "
                  f"two steps", flush=True)
        # the cost: the step under each setting, in turns
        for label, make in makes.items():
            model = make()
            _, _, step = new_step(model)
            times = {"deterministic": [], "parent": []}
            for turn in range(6):
                for key in (("deterministic", "parent") if turn % 2 == 0
                            else ("parent", "deterministic")):
                    tloop.exact_f32 = (exact_f32 if key == "deterministic"
                                       else _parent_exact_f32)
                    try:
                        step(x, y)
                        times[key].append(median_ms(
                            lambda: step(x, y), iters=3, inner=2, warmup=0))
                    finally:
                        tloop.exact_f32 = exact_f32
            d, p = (float(np.median(times[k])) for k in ("deterministic",
                                                         "parent"))
            print(f"  {label} step at batch {TB}, ms in 6 turns: "
                  f"deterministic {[round(t, 3) for t in times['deterministic']]}"
                  f", parent setting {[round(t, 3) for t in times['parent']]}"
                  f"; medians {d:.3f} / {p:.3f} = {d / p:.4f} ({card})",
                  flush=True)

    def mesh_counts(path, counts, want, forwards=1):
        for name, n in counts.items():
            assert n == forwards * want.get(name, 0), (path, counts, want)
        for key, name in (("k1", "act_quantize"), ("k2", "qmm_fused"),
                          ("k3", "bn_epilogue"), ("k4", "fused_quant_matmul"),
                          ("k5", "dw3x3"), ("k6", "bottleneck_chain"),
                          ("k7", "qsgd_update")):
            if want.get(name):
                rows[key].counted(path, counts[name], forwards)

    RN_WANT = {"act_quantize": 5, "qmm_fused": 18, "bn_epilogue": 14,
               "bottleneck_chain": 7}

    @phase("mesh: NCCL at world size 1, mesh 1x1 (the engine's mesh= and "
           "the data-parallel QAT step against the unsharded ones)")
    def nccl_phase(sc):
        import socket

        import torch.distributed as dist

        from cnns_slfp_quantization_tpu_torch.parallel import (
            make_mesh,
            steps,
        )

        with socket.socket() as s_:
            s_.bind(("localhost", 0))
            port = s_.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(1, 1)
            x = requests[0]
            plain = InferenceEngine("resnet", qbit=8, batch_size=B,
                                    image_size=224, seed=0)
            want = plain.predict(x)
            eng = InferenceEngine("resnet", qbit=8, batch_size=B,
                                  image_size=224, seed=0, mesh=mesh)
            assert eng.graphed
            got, counts = _counted_run(lambda: eng.predict(x))
            assert np.array_equal(got.view(np.uint16), want.view(np.uint16))
            # the run captured the rank's graph: the capture's two
            # forwards' launches; the replay launched without Python
            mesh_counts("mesh1x1_nccl_resnet_fused", counts, RN_WANT, 2)
            print(f"  fused ResNet-50, batch {B}: graph logits bit-equal to "
                  f"the engine without mesh= (graphed too); launches at "
                  f"the capture {counts}", flush=True)
            xt, yt = train_data(TB)
            loss, params = step_from(
                lambda: train_model(8, sc, use_pallas=True), xt, yt)
            model = train_model(8, sc, use_pallas=True)
            state, _, _ = new_step(model)
            steps.shard_state(state, mesh)
            step = steps.jit_train_step(tloop.make_train_step(
                model, state.optimizer))
            xs, ys = steps.place_batch(mesh, xt, yt)
            m, counts = _counted_run(lambda: step(state, xs, ys))
            assert float(m["loss"]) == loss
            assert same_state([p.detach() for p in model.parameters()],
                              params)
            mesh_counts("mesh1x1_nccl_qat_b", counts, WANT_B)
            print(f"  route B DSGD step at batch {TB} through "
                  f"parallel.steps: loss and weights bit-equal to the plain "
                  f"step; launches {counts}", flush=True)
        finally:
            dist.destroy_process_group()

    @phase("mesh: gloo, 2 ranks sharing the card (fused ResNet-50 2x1 and "
           "1x2, SqueezeNet module path 1x2, fused MobileNetV1 2x1, QAT "
           "2x1 and 1x2, spatial conv, the CLI, scaling_bench)")
    def gloo_phase(sc, fused_scales):
        import pickle
        import socket
        import tempfile

        import torch.multiprocessing as mp

        with socket.socket() as s_:
            s_.bind(("localhost", 0))
            port = s_.getsockname()[1]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            out = f"{tmp}/rank"
            mp.spawn(_mesh_rank, (2, port, out, list(sc.ka), list(sc.kw),
                                  fused_scales),
                     nprocs=2, start_method="spawn")
            res = []
            for r in range(2):
                with open(f"{out}.{r}", "rb") as f:
                    res.append(pickle.load(f))
        print(f"  2 ranks on {card}, done in "
              f"{time.perf_counter() - t0:.1f} s; seconds per task "
              f"{ {k: round(v, 1) for k, v in res[0]['seconds'].items()} }; "
              f"gloo took every collective's CUDA tensors (nothing staged "
              f"through the host)", flush=True)
        for r, rr in enumerate(res):
            for k, v in rr.items():
                if isinstance(v, dict) and "error" in v:
                    raise AssertionError(f"rank {r}, {k}:\n{v['error']}")
        for r, rr in enumerate(res):
            rn = rr["_mesh_resnet"]
            want = rn["want"]
            dp, tp = rn[(2, 1)], rn[(1, 2)]
            i = dp["i"]
            assert np.array_equal(dp["got"].view(np.uint16),
                                  res[0]["_mesh_resnet"][(2, 1)]["got"].view(
                                      np.uint16))
            assert np.array_equal(
                dp["got"][i * 32:(i + 1) * 32].view(np.uint16),
                want[i * 32:(i + 1) * 32].view(np.uint16)), r
            c = cos(tp["got"], want)
            assert c > 0.999 and same_top1(tp["got"], want), (r, c)
            # a data axis serves the rank's rows through its graph, whose
            # capture the counted run holds (two forwards' launches); a
            # model axis gathers every forward, eager by the engine's rule
            assert dp["graphed"] and not tp["graphed"], (dp, tp)
            mesh_counts(f"mesh2x1_resnet_fused_rank{r}", dp["counts"],
                        RN_WANT, 2)
            mesh_counts(f"mesh1x2_resnet_fused_rank{r}", tp["counts"],
                        RN_WANT)
            print(f"  rank {r}: fused ResNet-50, batch {B}: 2x1 (graph) rows "
                  f"{i * 32}-{i * 32 + 31} bit-equal to an unsharded engine "
                  f"at batch 32 (graph; launches at the capture "
                  f"{dp['counts']}); 1x2 (graphed {tp['graphed']}: eager by "
                  f"the model-axis rule) cos "
                  f"{c:.6f}, same top-1 (launches {tp['counts']}); "
                  f"images/s 2x1 {dp['ips']:.1f}, 1x2 {tp['ips']:.1f} "
                  f"(2 ranks sharing one {card})", flush=True)
            sq = rr["_mesh_module"]
            c = cos(sq["got"], sq["want"])
            assert c > 0.999 and same_top1(sq["got"], sq["want"]), (r, c)
            assert not sq["graphed"], r
            mesh_counts(f"mesh1x2_squeezenet_module_rank{r}", sq["counts"],
                        {"fused_quant_matmul": 17, "act_quantize": 9})
            print(f"  rank {r}: SqueezeNet module path, packed, 1x2, batch "
                  f"{B}: cos {c:.6f} against unsharded, same top-1 "
                  f"(launches {sq['counts']})", flush=True)
            mn = rr["_mesh_mobilenet"]
            i = mn["i"]
            assert np.array_equal(mn["got"][i * 32:(i + 1) * 32].view(
                np.uint16), mn["want"][i * 32:(i + 1) * 32].view(np.uint16))
            assert mn["graphed"], r
            mesh_counts(f"mesh2x1_mobilenet_fused_rank{r}", mn["counts"],
                        {"act_quantize": 2, "bn_epilogue": 18, "dw3x3": 9}, 2)
            for net, want in (("mobilenetv1", {"act_quantize": 1,
                                               "bn_epilogue": 18,
                                               "dw3x3": 9}),
                              ("shufflenetv2", {"act_quantize": 35,
                                                "bn_epilogue": 20})):
                tp = rr["_mesh_fused_tp"][net]
                c = cos(tp["got"], tp["want"])
                flips, diff = top1_rows(tp["got"], tp["want"])
                print(f"  rank {r}: fused {net}, 1x2: rows whose top-1 "
                      f"differs from the unsharded engine's (row, its top-2 "
                      f"margin, one of its tied top classes): {flips}; "
                      f"largest |diff| {diff:.4g}; logits "
                      f"differing {int((tp['got'] != tp['want']).sum())} of "
                      f"{tp['want'].size}", flush=True)
                # the same top-1, a tie's classes each counting as it
                assert c > 0.999 and all(tie for *_, tie in flips), \
                    (r, net, c, flips)
                assert np.array_equal(
                    tp["got"].view(np.uint32),
                    res[0]["_mesh_fused_tp"][net]["got"].view(np.uint32))
                assert not tp["graphed"], (r, net)
                mesh_counts(f"mesh1x2_{net}_fused_rank{r}", tp["counts"],
                            want)
                print(f"  rank {r}: fused {net}, 1x2, batch {B}: cos "
                      f"{c:.6f} against an unsharded engine, same top-1 "
                      f"(where tied: one of the tied classes), "
                      f"the same logits on both ranks; launches a forward "
                      f"{ {k: n for k, n in tp['counts'].items() if n} }; "
                      f"{tp['s']:.2f} s a forward (2 ranks sharing one "
                      f"{card}, gloo)", flush=True)
            qf, qa = rr["_mesh_qat"][32], rr["_mesh_qat"][8]

            def bn_rel(got, want):
                return float((got - want).abs().max() / want.abs().max())
            for label, q in (("float32", qf), ("route B", qa)):
                def rel(v, q=q):
                    return abs(v - q["single"]) / q["single"]
                for shape in ((2, 1), (1, 2)):
                    g = q[shape]
                    print(f"  rank {r}: {label} DSGD step on "
                          f"{shape[0]}x{shape[1]} ({g['rows']} rows a "
                          f"rank): loss {g['loss']!r} vs the single-rank "
                          f"step's {q['single']!r} (rel {rel(g['loss']):.3g})"
                          f"; weights outside rtol 2e-4 / atol 1e-6: "
                          f"{g['params']['misses']} of {g['params']['of']} "
                          f"(max |diff| {g['params']['max_abs']:.3g}); "
                          f"counters {g['stats']} vs {q['single_stats']}; "
                          f"launches {g['counts']}", flush=True)
                extra = (
                    f"; 2x1 without the gradient reduction: weights "
                    f"outside the bar {q['no_grad_reduce']['misses']} "
                    f"(max |diff| {q['no_grad_reduce']['max_abs']:.3g})"
                    if "no_grad_reduce" in q else
                    f"; 2x1 with the single step's BN statistics replayed: "
                    f"loss rel {rel(q['replayed_bn']):.3g}; eval mode at "
                    f"128 rows against 256: logits' rows bit-equal "
                    f"{q['rowwise']['logits_equal']}, ops that give a row "
                    f"other bits from the same input rows (name, type, "
                    f"elements, of, max) {q['rowwise']['ops']}")
                ro = q["reordered"]
                losses = [float(f"{rel(o['loss']):.3g}") for o in ro]
                misses = [o["params"]["misses"] for o in ro]
                worst = [float(f"{o['params']['max_abs']:.3g}") for o in ro]
                print(f"  rank {r}: {label} bars: single steps on "
                      f"reordered rows: loss rel {losses}, weights outside "
                      f"the bar {misses} (max |diff| {worst}); the first "
                      f"BN's statistics against the single step's, rel: "
                      f"2x1 {bn_rel(q[(2, 1)]['bn0'], q['bn0']):.3g}; 2x1 "
                      f"with each rank's BN statistics its own "
                      f"{bn_rel(q['local_bn0'], q['bn0']):.3g}, loss rel "
                      f"{rel(q['local_bn']):.3g}{extra}", flush=True)
            # both: the first BN's statistics (its input rows have the same
            # bits at any row count) are the global batch's but for their
            # summation order, which a rank's own statistics are not
            for q in (qf, qa):
                assert bn_rel(q[(2, 1)]["bn0"], q["bn0"]) <= 1e-5
                assert bn_rel(q["local_bn0"], q["bn0"]) > 1e-5
            # float32: the loss at the CPU test's bar, which a rank's own
            # BN statistics break.  The weights: with this init and data a
            # single step on reordered rows already puts some outside the
            # CPU test's rtol 2e-4 / atol 1e-6 (DSGD's stuck threshold and
            # BN's cancelling sums), so the sharded step is held to 4x that
            # spread, which a missing gradient reduction breaks
            fl = abs(qf["local_bn"] - qf["single"]) / qf["single"]
            assert fl > 1e-5, fl
            sound = max(max(o["params"]["misses"] for o in qf["reordered"]),
                        1)
            assert qf["no_grad_reduce"]["misses"] > 4 * sound, qf
            for shape in ((2, 1), (1, 2)):
                g = qf[shape]
                assert abs(g["loss"] - qf["single"]) <= 1e-5 * qf["single"]
                assert g["params"]["misses"] <= 4 * sound, (shape, g)
            # route B: one quantized step is chaotic.  A bin flipped by a
            # sum in another order (BN's statistics over two ranks; K4's
            # split at 128 rows, a bf16 ulp in a few outputs) moves the
            # loss by up to a few 1e-3, as far as a rank's own BN
            # statistics do: the loss only shows that the step runs
            assert abs(qa[(2, 1)]["loss"] - qa["single"]) <= \
                1e-2 * qa["single"]
            # DSGD's counters, each global parameter once (the CPU test's
            # bar, JAX's tests/test_parallel.py)
            for q in (qf, qa):
                for shape in ((2, 1), (1, 2)):
                    total = sum(q[shape]["stats"].values())
                    assert 0 < total <= 3 * q["n_params"], q[shape]
            mesh_counts(f"mesh2x1_qat_f32_rank{r}", qf[(2, 1)]["counts"],
                        WANT_F32)
            mesh_counts(f"mesh1x2_qat_f32_rank{r}", qf[(1, 2)]["counts"],
                        WANT_F32)
            mesh_counts(f"mesh2x1_qat_b_rank{r}", qa[(2, 1)]["counts"],
                        WANT_B)
            mesh_counts(f"mesh1x2_qat_b_rank{r}", qa[(1, 2)]["counts"],
                        WANT_B)
            sp = rr["_mesh_spatial"]
            assert sp["err"] <= 1e-5 * max(sp["scale"], 1.0), sp
            cl = rr["_mesh_cli"]
            assert cl["step"] == 2 and cl["counts"]["act_quantize"] > 0, cl
            assert cl["accs"] == res[0]["_mesh_cli"]["accs"]
            print(f"  rank {r}: fused MobileNetV1 (CIFAR) rows bit-equal "
                  f"(launches {mn['counts']}); spatial 3x3 max |diff| {sp['err']:.3g} "
                  f"of {sp['scale']:.3g}; CLI {cl['mesh_line']} step "
                  f"{cl['step']}, Precision@1 {cl['accs']}, launches "
                  f"{cl['counts']}", flush=True)
        for row in res[0]["_mesh_scaling"]:
            assert np.isfinite(row["images_per_sec"]) and \
                row["images_per_sec"] > 0, row
            print(f"  scaling_bench (ranks sharing one {card}): "
                  f"{json.dumps(row)}", flush=True)

    def where_the_time_goes(eng, label):
        """Device time per forward at batch 64 by kernel, the idle share
        and the bf16 -> f32 copies, from torch.profiler
        (``profiling.print_forward_profile``)."""
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (B, eng.image_size, eng.image_size, 3)).astype(np.float32)).to(dev)
        print(f"  profile {label} (eager forward):", flush=True)
        print_forward_profile(lambda: eager_forward(eng, x), B)

    k1_phase()
    k2_phase()
    k3_phase()
    k4_phase()
    k5_phase()
    k6_phase()
    k7_phase()
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
    sh = shufflenet_fused_phase()
    if sh is not None:
        shufflenet_module_phase(*sh)
        pth_phase(sh[1])
    else:
        failures.append("shufflenetv2 module path and .pth: no fused path "
                        "to compare")
    resnet_q7_phase()
    zoo_phase()
    engine_graph_phase()
    shufflenet_imgnet_phase()
    sc_train = train_b_phase()
    train_learn_phase()
    train_cli_phase()
    if sc_train is not None:
        train_speed_phase(sc_train)
        graph_phase(sc_train)
    else:
        failures.append("training speed and graphs: no route B scales")
    cal = calibrate_serve_phase(ch)
    ptq_sweep_phase()
    imgnet_phase()
    cifar_disk_phase()
    recovery_phase()
    blockin_phase()
    quant_sites_phase()
    if sh is not None:
        tools_phase(sh[1])
    else:
        failures.append("tools: no ShuffleNetV2 scales")
    if sc_train is not None and mn is not None and sh is not None:
        determinism_phase(sc_train)
        nccl_phase(sc_train)
        gloo_phase(sc_train, {
            "mobilenetv1": (list(mn[1].ka), list(mn[1].kw)),
            "shufflenetv2": (list(sh[1].ka), list(sh[1].kw))})
    else:
        failures.append("determinism and mesh phases: no route B, "
                        "MobileNetV1 or ShuffleNetV2 scales")
    for eng, label in ((fused and fused[0], "resnet fused, chain off"),
                       (ch, "resnet fused, default: chain={2,3}"),
                       (cal, "resnet fused, freshly calibrated constants"),
                       (sq, "squeezenet module path"),
                       (mn and mn[0], "mobilenetv1 fused"),
                       (mn and mn[4], "mobilenetv1 fused, dw=torch"),
                       (sh and sh[0], "shufflenetv2 fused")):
        if eng is None:
            continue
        try:
            where_the_time_goes(eng, label)
        except Exception:  # a measurement; the checks above decide success
            print(f"  profiler failed (not measured):\n"
                  f"{traceback.format_exc()}", flush=True)
    print(f"engine graphs, {card}: path, batch, throughput() images/s "
          f"graph / eager (mean of 2 turns each), ratio, idle share eager "
          f"-> graph, kernel ms a forward eager -> graph, by class (graph)",
          flush=True)
    for path, g in engine_graphs.items():
        gi, ei = (sum(g[k]) / len(g[k]) for k in ("graph_ips", "eager_ips"))
        idle = {m: "n/m" if v is None else f"{v:.3f}"
                for m, v in g["idle"].items()}
        kms = {m: "n/m" if v is None else f"{v:.3f}"
               for m, v in g["kernel_ms"].items()}
        print(f"  {path}, b{g['batch']}, iters {g['iters']}: {gi:.1f} / "
              f"{ei:.1f} = "
              f"{g['ratio']:.3f}; idle {idle['eager']} -> {idle['graph']}; "
              f"kernels {kms['eager']} -> {kms['graph']} ms; " + ", ".join(
                  f"{c} {ms:.3f}" for c, ms in sorted(
                      g["classes"]["graph"].items())), flush=True)
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
