"""K5 (``csrc/depthwise.cu``) on the card: its device time at every served
site against another checkout of the repository, and the fused MobileNetV1
executors' images/s under both ``dw`` routes in turns.

    python3 -m cnns_slfp_quantization_tpu_torch.utils.bench_dw \\
        [--against ROOT] [--pairs N]

:func:`k5_sites` lists the shapes K5 serves: the 9 stride-1 depthwise sites
of ImageNet MobileNetV1 at batch 64 and 256 and of CIFAR ``mobilenet`` at
64.  At each it calls the wrapper in the serving form (bf16, ReLU, the
pointwise conv's quantize) on inputs from seed 0 and reports the device
time of the kernels alone from torch.profiler (median of 3 runs of 5
calls that recorded every kernel, ``profiling.kernel_ms``), the same for
the exact route (one subnormal tap), for ``F.conv2d(groups=C)`` on the
same bf16 operands (the library call) and for the route ``dw="torch"``
runs instead (the float32 grouped conv and K3), and whether the output is bit-equal to the plain
version.  With ``--against ROOT`` the kernel's times also come from the
wrappers of another checkout (for example the parent commit, unpacked with
``git archive``), each version in its own process, in turns (this, other,
other, this); the totals per forward list each version's runs in turn
order.  Then, in one process, the fused executors
(``InferenceEngine("mobilenetv1" | "mobilenet", qbit=8)``, random weights
from seed 0) serve batches of 64 and 256 under ``dw="kernel"`` and
``dw="torch"`` in turns (kernel, torch, torch, kernel, ``--pairs`` times,
after one untimed round of each): images/s from CUDA events around 16
back-to-back forwards, each turn listed.  It prints the card's name and
power limit first.  Needs a CUDA device and nvcc; it is a measuring tool,
not part of the serving path.
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

NETS = (("mobilenetv1", 224, 64), ("mobilenetv1", 224, 256),
        ("mobilenet", 32, 64))


def k5_sites():
    """(path, NHWC shape, launches per forward) of K5 in the fused
    MobileNetV1 executors: ``mobilenetv1_b64``, ``mobilenetv1_b256`` and
    ``mobilenet_b64``."""
    from cnns_slfp_quantization_tpu_torch.models.mobilenetv1 import DW_CONFIG

    out = []
    for net, size, batch in NETS:
        res, sites = (size - 1) // 2 + 1, Counter()   # stem 3x3/s2/p1
        for inp, _, stride in DW_CONFIG:
            if stride == 1:
                sites[(batch, res, res, inp)] += 1
            res = (res - 1) // stride + 1
        assert sum(sites.values()) == 9
        out += [(f"{net}_b{batch}", shape, n) for shape, n in sites.items()]
    return out


def time_sites(dev):
    """{"path shape": {kernel, exact, library, route: device ms per call;
    bit_equal}} at every site, through the wrappers of whichever checkout
    is on sys.path."""
    import torch
    import torch.nn.functional as F

    from cnns_slfp_quantization_tpu_torch import calib
    from cnns_slfp_quantization_tpu_torch.kernels import depthwise as k5
    from cnns_slfp_quantization_tpu_torch.kernels import epilogue as k3
    from cnns_slfp_quantization_tpu_torch.models.resnet50_fused import (
        ConvKxK,
        _conv_f32,
    )
    from cnns_slfp_quantization_tpu_torch.ops import sfp
    from cnns_slfp_quantization_tpu_torch.ops.backend import backend_flags
    from cnns_slfp_quantization_tpu_torch.utils.bench_gemm import same_bits

    kernel_ms = profiling.kernel_ms
    # the route, decided here once as an executor decides it when it lays
    # out its weights (a wrapper without routes takes none)
    routes = "ftz" in inspect.signature(k5.dw3x3).parameters
    gen = torch.Generator(device=dev).manual_seed(0)
    r = sfp.recip_of(calib.load_scales("mobilenetv1_imgnet").ka[2])
    out = {}
    for path, shape, _ in k5_sites():
        c = shape[-1]
        x = (torch.randn(*shape, device=dev, generator=gen) * 2).to(
            torch.bfloat16)
        w = torch.randn(3, 3, c, device=dev, generator=gen) * 0.5
        s = torch.rand(c, device=dev, generator=gen) + 0.5
        t = torch.randn(c, device=dev, generator=gen) * 0.1
        w_sub = w.clone()
        w_sub[0, 0, 0] = 1e-40
        kw = dict(relu=True, quant_out_recip=r)
        got = k5.dw3x3(x, w, scale=s, shift=t, **kw)
        want = k5.dw3x3_plain(x, w, s, t, **kw)
        xn = x.permute(0, 3, 1, 2)
        wn = w.permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        conv = ConvKxK(w=wn.float(), scale=s, shift=t, stride=1, pad=1,
                       groups=c)

        def route():
            with backend_flags():
                return k3.bn_epilogue(_conv_f32(x, conv), s, t, relu=True,
                                      emit_raw=False, quant_recip=r)
        fast = dict(kw, ftz=True) if routes else kw
        exact = dict(kw, ftz=False) if routes else kw
        out[f"{path} {shape}"] = dict(
            kernel=kernel_ms(lambda: k5.dw3x3(x, w, scale=s, shift=t,
                                              **fast)),
            exact=kernel_ms(lambda: k5.dw3x3(x, w_sub, scale=s, shift=t,
                                             **exact)),
            library=kernel_ms(lambda: F.conv2d(xn, wn, padding=1, groups=c)),
            route=kernel_ms(route), bit_equal=same_bits(got, want))
    return out


def serve_turns(dev, pairs: int):
    """{"net_bBATCH": {"kernel": [images/s, ...], "torch": [...]}}: the
    fused executors under both ``dw`` routes, in turns."""
    import torch

    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    out = {}
    for net, size, batch in NETS + (("mobilenet", 32, 256),):
        engines = {route: InferenceEngine(net, qbit=8, batch_size=batch,
                                          seed=0, policy={"dw": route})
                   for route in ("kernel", "torch")}
        x = torch.randn(batch, size, size, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
        out[f"{net}_b{batch}"] = turns.alternate(
            {route: (lambda e=eng: profiling.throughput(
                lambda: e.forward(x), batch))
             for route, eng in engines.items()}, pairs)
    return out


def _worker(root: str, serve_pairs: int) -> None:
    sys.path.insert(0, root)
    import torch

    dev = torch.device("cuda")
    print(json.dumps(serve_turns(dev, serve_pairs) if serve_pairs
                     else time_sites(dev)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=pathlib.Path,
                    help="root of another checkout to time in turns")
    ap.add_argument("--pairs", type=int, default=2,
                    help="kernel, torch, torch, kernel turns per batch "
                    "(0: none)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        _worker(a.worker, a.pairs)
        return 0
    card = turns.card()
    if card is None:
        return 2
    print(f"card: {card}", flush=True)
    runs = turns.across_checkouts(__file__, a.against, "--pairs", "0")
    per_fwd = {}
    for path, shape, n in k5_sites():
        label = f"{path} {shape}"
        first = runs["this"][0][label]
        print(f"  {label} x{n}: " + ", ".join(
            f"{name} {turns.joined((r[label]['kernel'] for r in rs), '.4f')}"
            for name, rs in runs.items())
            + f" ms; this: exact route {first['exact']:.4f}, "
            f"F.conv2d(groups=C) {first['library']:.4f}, grouped conv + K3 "
            f"{first['route']:.4f}; bit-equal "
            + "/".join(str(r[label]["bit_equal"]) for rs in runs.values()
                       for r in rs), flush=True)
        for name, rs in runs.items():
            tot = per_fwd.setdefault((path, name), [0.0] * len(rs))
            for i, r in enumerate(rs):
                tot[i] += n * r[label]["kernel"]
        for key in ("exact", "library", "route"):
            tot = per_fwd.setdefault((path, key), [0.0])
            tot[0] += n * first[key]
    for (path, name), tot in per_fwd.items():
        print(f"per forward {path} {name}: {turns.joined(tot, '.4f')} ms",
              flush=True)
    if a.pairs:
        print(turns.FORWARD_NOTE, flush=True)
        served = turns.worker(__file__, turns.ROOT, "--pairs", str(a.pairs))
        for key, runs in served.items():
            print(f"fused {key} in turns: " + turns.compared(
                {f"dw={k}": v for k, v in runs.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
