"""The served shapes of K2 and K4 (the shared Hopper GEMM mainloop,
``csrc/gemm_sm90.cuh``), the rule their outputs are checked by, and their
times on the card against another checkout of the repository.

    python3 -m cnns_slfp_quantization_tpu_torch.utils.bench_gemm \\
        [--against ROOT | --plans]

:func:`k2_sites`, :func:`k2_flags` and :func:`k4_sites` list every shape
and flag set K2 serves in the fused ResNet-50 executor and K4 on the four
module paths at batch 64; :func:`check_gemm` is the rule ``chip_smoke.py``
holds both kernels to (the only correctness check on the card).

Run as a script, it times every served shape through the wrappers: the
device time of the kernels alone from torch.profiler (median of 3 runs of
5 calls that recorded every kernel, ``profiling.kernel_ms``), and CUDA
events around 20 runs of 5 back-to-back calls, which for kernels of a few
microseconds time the host.  K4 gets uint8 weights,
as the paths serve them.  With ``--against ROOT`` the same calls also go
through the wrappers of another checkout (for example the parent commit,
unpacked with ``git archive``), each version in its own process, in turns
(this, other, other, this); the totals per forward list each version's
runs in turn order, and so does the fused ResNet-50 executor's images/s
at batch 64 (:func:`serve_ips`).  ``--plans`` instead times every shape
under each candidate tile plan (:func:`time_plans`), the sweep the rules
of ``kernels/_gemm_plan.py`` were read from.  It prints the card's name
and power limit first.  Needs a CUDA device and nvcc; it is a measuring
tool, not part of the serving path.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

if __package__:
    from cnns_slfp_quantization_tpu_torch.utils import profiling, turns
else:   # a worker, run as a file: this checkout's timing, another's wrappers
    import profiling
    import turns

B = 64


# ----------------------------------------------------------- served shapes

def k2_sites(batch: int = B):
    """(M, K, N, site, launches per forward) of K2 in the fused ResNet-50
    executor at 224x224: conv1 and conv3 of every bottleneck."""
    out, res, in_ch = [], 56, 64
    for s, (planes, blocks, stride) in enumerate(
            [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]):
        m_in = batch * res * res
        res //= stride
        m = batch * res * res
        out.append((m_in, in_ch, planes, "c1_b0", 1))
        out.append((m, planes * 4, planes, "c1_mid", blocks - 1))
        out.append((m, planes, planes * 4, "c3_mid", blocks - 1))
        out.append((m, planes, planes * 4, "c3_end" if s < 3 else "c3_last",
                    1))
        in_ch = planes * 4
    return out


def k2_flags(rc):
    """{site: qmm_fused flags} of the executor's K2 sites, given the
    reciprocals of ResNet-50's activation scales (``rc``); ``residual:
    True`` stands for a bf16 [M, N] residual, ``out_f32: True`` for
    ``out_dtype=torch.float32`` (conv1 writes the operand cuDNN's conv2
    reads)."""
    return {
        "c1_b0": dict(relu=True, quant_out_recip=rc[2], out_f32=True),
        "c1_mid": dict(relu=True, quant_in_recip=rc[4],
                       quant_out_recip=rc[5], out_f32=True),
        "c3_mid": dict(relu=True, residual=True),
        "c3_end": dict(relu=True, residual=True, quant_out_recip=rc[12]),
        "c3_last": dict(relu=True, residual=True),
    }


def k4_sites(batch: int = B):
    """{path: [(input shape, K, N, stride, bias, launches per forward)]} of
    K4 on the module paths at 224x224 (a 2-D input shape for a dense
    layer): SqueezeNet 1.0 (17 per forward), AlexNet (3), ResNet-50 with
    ``use_pallas=True`` (37), MobileNetV1 (13)."""
    from collections import Counter

    from cnns_slfp_quantization_tpu_torch.models.mobilenetv1 import DW_CONFIG
    from cnns_slfp_quantization_tpu_torch.models.squeezenet import (
        FIRE_PLAN,
        POOL_BEFORE,
    )

    out = {}
    sq, res, cin = Counter(), 54, 96      # stem 109, ceil pools 54, 27, 13
    for f, (s, e1, _) in enumerate(FIRE_PLAN):
        if f in POOL_BEFORE and f:
            res = -(-(res - 3) // 2) + 1
        sq[((batch, res, res, cin), cin, s, 1, True)] += 1
        sq[((batch, res, res, s), s, e1, 1, True)] += 1
        cin = 2 * e1
    sq[((batch, res, res, cin), cin, 1000, 1, True)] += 1
    out["squeezenet"] = [(*key, c) for key, c in sq.items()]
    out["alexnet"] = [((batch, 9216), 9216, 4096, 1, True, 1),
                      ((batch, 4096), 4096, 4096, 1, True, 1),
                      ((batch, 4096), 4096, 1000, 1, True, 1)]
    rn, res, cin = Counter(), 56, 64
    for planes, blocks, stride in [(64, 3, 1), (128, 4, 2), (256, 6, 2),
                                   (512, 3, 2)]:
        for b in range(blocks):
            st = stride if b == 0 else 1
            o = res // st
            rn[((batch, res, res, cin), cin, planes, 1, False)] += 1
            rn[((batch, o, o, planes), planes, 4 * planes, 1, False)] += 1
            if b == 0:
                rn[((batch, res, res, cin), cin, 4 * planes, st, False)] += 1
            res, cin = o, 4 * planes
    rn[((batch, 2048), 2048, 1000, 1, True)] += 1
    out["resnet_module"] = [(*key, c) for key, c in rn.items()]
    mn, res = Counter(), 112
    for inp, oup, stride in DW_CONFIG:
        res = (res - 1) // stride + 1
        mn[((batch, res, res, inp), inp, oup, 1, False)] += 1
    out["mobilenetv1_module"] = [(*key, c) for key, c in mn.items()]
    want = {"squeezenet": 17, "alexnet": 3, "resnet_module": 37,
            "mobilenetv1_module": 13}
    assert {p: sum(s[-1] for s in v) for p, v in out.items()} == want
    return out


def gemm_shape(shape, k, n, stride):
    """(M, K, N) of a K4 site."""
    if len(shape) == 2:
        return shape[0], k, n
    b, h, w, _ = shape
    return b * -(-h // stride) * -(-w // stride), k, n


# ------------------------------------------------------------------ checks

def emitted_values(device):
    """Every bf16 value the SLFP<3,4> activation quantizer emits (0, the
    pseudo-zero, 0.125 and up), from the quantizer fed every finite
    non-negative bf16 value: its linear pre-round skips some codebook
    entries, so the codebook itself would count one step as two."""
    import torch

    from cnns_slfp_quantization_tpu_torch.ops import sfp

    return sfp.act_bf16_bits(
        torch.arange(0x7F80, dtype=torch.int32, device=device).to(
            torch.int16).view(torch.bfloat16), 1.0, 8, True).float().unique()


def gemm_mag(xq, wv, s=None, t=None, res=None):
    """Per-element sum of the magnitudes of the terms of an output:
    |x| @ |w| from bf16 operands, times |s| plus |t| (+ |residual|) for
    K2's affine."""
    mag = xq.float().abs() @ wv.float().abs()
    if s is not None:
        mag = mag * s.abs() + t.abs()
    return mag if res is None else mag + res.float().abs()


def check_gemm(got, want, quantized, label, mag, k, emitted):
    """K2 and K4 sum their K products in another order than the plain
    version.  Each order rounds at most K times, each by at most 2**-23 of
    the running sum (tensor cores may truncate), which never exceeds
    ``mag``, the per-element sum of the magnitudes of all terms; so the f32
    values before the output rounding differ by at most delta = K * 2**-22
    * mag, and the outputs by delta plus one ulp of the output type.
    Quantized outputs: within one step of the quantizer's output in at most
    0.1% of elements.  Returns the largest absolute difference."""
    import torch

    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if quantized:
        gi = torch.searchsorted(emitted, g.abs().contiguous()) * torch.sign(g)
        wi = torch.searchsorted(emitted, w.abs().contiguous()) * torch.sign(w)
        step = (gi - wi).abs()
        frac = float((step > 0).float().mean())
        if float(step.max()) > 1 or frac > 1e-3:
            i = int(step.flatten().argmax())
            raise AssertionError(
                f"{label}: {frac:.2e} of elements differ, max step "
                f"{float(step.max())}; first: got {float(g.flatten()[i])}, "
                f"want {float(w.flatten()[i])}")
    else:
        delta = k * 2.0**-22 * mag
        v = w.abs() + delta
        _, e = torch.frexp(v)  # v = f * 2**e, f in [0.5, 1)
        p = 7 if got.dtype == torch.bfloat16 else 23
        ulp = torch.ldexp(torch.ones_like(v), e - 1 - p) * (v > 0)
        bad = (g - w).abs() > delta + ulp
        if bool(bad.any()):
            i = int(bad.flatten().nonzero()[0])
            raise AssertionError(
                f"{label}: {int(bad.sum())} elements beyond the bound; "
                f"first at {i}: got {float(g.flatten()[i])}, want "
                f"{float(w.flatten()[i])}, mag {float(mag.flatten()[i])}")
    return err


def same_bits(a, b):
    import torch

    it = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return bool(torch.equal(a.view(it), b.view(it)))


# ------------------------------------------------------------------- times

def site_calls(dev):
    """(label, plan arguments (M, K, N, residual), call) of every served
    shape, ``call`` launching K2 or K4 on fresh inputs from seed 0 through
    the wrappers of whichever checkout is on sys.path: K2 with its site's
    flags, K4 with uint8 codes in the layers' [N, K] storage."""
    import torch

    from cnns_slfp_quantization_tpu_torch import calib
    from cnns_slfp_quantization_tpu_torch.kernels import fused_matmul as k4
    from cnns_slfp_quantization_tpu_torch.kernels import qmm as k2
    from cnns_slfp_quantization_tpu_torch.kernels.quantize import (
        act_quantize_plain)
    from cnns_slfp_quantization_tpu_torch.ops import sfp

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    rc = [sfp.recip_of(a) for a in calib.load_scales("resnet50_imgnet").ka]
    flag_sets = k2_flags(rc)
    for m, k, n, site, _ in k2_sites():
        flags = dict(flag_sets[site])
        res = (randn(m, n, scale=2.0).to(torch.bfloat16)
               if flags.pop("residual", False) else None)
        if flags.pop("out_f32", False):
            flags["out_dtype"] = torch.float32
        x = randn(m, k, scale=3.0).abs().to(torch.bfloat16)
        if "quant_in_recip" not in flags:
            x = act_quantize_plain(x, 1.0)
        # the executor's [N, K] storage, handed over as its transpose; a
        # checkout whose executor stores [K, N] gets that
        w = sfp.quantize_weight(randn(n, k, scale=4.0), 8).to(
            torch.bfloat16).t()
        s, t = torch.rand(n, device=dev) * 0.01, randn(n)
        try:
            k2.qmm_fused(x, w, s, t, residual=res, **flags)
        except ValueError:
            w = w.contiguous()
        yield (f"K2 {site} {m}x{k}x{n}", (m, k, n, res is not None),
               lambda x=x, w=w, s=s, t=t, res=res, flags=flags:
               k2.qmm_fused(x, w, s, t, residual=res, **flags))
    for path, sites in k4_sites().items():
        for shape, k, n, stride, bias, _ in sites:
            x = randn(*shape, scale=1.5).abs().to(torch.bfloat16)
            w = sfp.pack_slfp34(sfp.quantize_weight(
                randn(n, k, scale=4.0), 8)).t()
            b = randn(n, scale=0.1) if bias else None
            kw = dict(ka=0.37, kw=0.11, bias=b, nonneg=True,
                      out_dtype=torch.bfloat16)
            if len(shape) == 2:
                call = (lambda x=x, w=w, kw=kw:
                        k4.fused_quant_matmul(x, w, **kw))
            else:
                call = (lambda x=x, w=w, kw=kw, stride=stride:
                        k4.quant_conv1x1(x, w, stride=stride, **kw))
            yield (f"K4 {path} {shape} {k}x{n} s{stride}",
                   (*gemm_shape(shape, k, n, stride), False), call)


def time_sites(dev):
    """{label: (ms per launch between CUDA events, device ms per launch
    from the profiler)} at every served shape."""
    return {label: (profiling.median_ms(call), profiling.kernel_ms(call))
            for label, _, call in site_calls(dev)}


def time_plans(dev):
    """Device ms per launch (profiler) at every served shape under each
    candidate tile plan: row and column tiles of 64 and 128, rings of 3
    and 4 stages, the split of :func:`_gemm_plan.plan`; ``*`` marks the
    plan the wrappers use."""
    from cnns_slfp_quantization_tpu_torch.kernels import _gemm_plan

    plan = _gemm_plan.plan
    try:
        for label, shape, call in site_calls(dev):
            chosen = plan(*shape)
            times = []
            for bm in (64, 128):
                for bn in (64, 128):
                    for st in (3, 4):
                        p = _gemm_plan.Plan(bm, bn, chosen.split, st,
                                            _gemm_plan.smem_bytes(bm, bn, st))
                        _gemm_plan.plan = lambda *_, p=p: p
                        mark = "*" if p == chosen else ""
                        times.append(f"{bm}x{bn}x{st}{mark} "
                                     f"{profiling.kernel_ms(call):.4f}")
            _gemm_plan.plan = plan
            print(f"  {label}: " + ", ".join(times), flush=True)
    finally:
        _gemm_plan.plan = plan


def serve_ips(dev, batch: int = B):
    """images/s of the fused ResNet-50 executor (random weights from seed
    0) at ``batch``: the median of 3 runs of 16 back-to-back forwards."""
    import statistics

    import torch

    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    eng = InferenceEngine("resnet", qbit=8, batch_size=batch,
                          image_size=224, seed=0)
    x = torch.randn(batch, 224, 224, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    return statistics.median(profiling.throughput(lambda: eng.forward(x),
                                                  batch)
                             for _ in range(3))


def _worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    dev = torch.device("cuda")
    out = time_sites(dev)
    out["serve"] = serve_ips(dev)
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=pathlib.Path,
                    help="root of another checkout to time in turns")
    ap.add_argument("--plans", action="store_true",
                    help="time each candidate tile plan at every shape")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        _worker(a.worker)
        return 0
    card = turns.card()
    if card is None:
        return 2
    print(f"card: {card}", flush=True)
    if a.plans:
        import torch

        time_plans(torch.device("cuda"))
        return 0
    runs = turns.across_checkouts(__file__, a.against)
    per_fwd = {}
    counts = {f"K2 {site} {m}x{k}x{n}": c
              for m, k, n, site, c in k2_sites()}
    for path, sites in k4_sites().items():
        for shape, k, n, stride, _, c in sites:
            counts[f"K4 {path} {shape} {k}x{n} s{stride}"] = c
    for label, c in counts.items():
        times = {name: [r[label] for r in rs] for name, rs in runs.items()}
        print(f"  {label} x{c}: " + ", ".join(
            f"{name} {' / '.join(f'{v[0]:.4f}' for v in ts)} ms (kernels "
            f"{' / '.join(f'{v[1]:.4f}' for v in ts)})"
            for name, ts in times.items()), flush=True)
        key = label.split(" ")[0] + " " + (
            "resnet_fused" if label.startswith("K2") else label.split(" ")[1])
        for name, ts in times.items():
            tot = per_fwd.setdefault((key, name), [[0.0, 0.0] for _ in ts])
            for run, v in zip(tot, ts):
                run[0] += c * v[0]
                run[1] += c * v[1]
    for (key, name), tot in sorted(per_fwd.items()):
        print(f"per forward {key} {name}: "
              f"{' / '.join(f'{ms:.4f}' for ms, _ in tot)} ms, kernels "
              f"{' / '.join(f'{kms:.4f}' for _, kms in tot)} ms", flush=True)
    print(turns.FORWARD_NOTE, flush=True)
    for name, rs in runs.items():
        print(f"fused ResNet-50 b{B} {name}: "
              f"{turns.joined(r['serve'] for r in rs)} images/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
