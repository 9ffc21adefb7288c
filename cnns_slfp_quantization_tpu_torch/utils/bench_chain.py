"""K6 (``csrc/chain.cu``) on the card: exactness, times and cycles per phase.

    python3 -m cnns_slfp_quantization_tpu_torch.utils.bench_chain \\
        [--against OTHER.cu] [--shapes stage2,stage3,...] [--serve PAIRS]

For each shape (ResNet-50's stage 1-3 bottlenecks at batch 64 and 256 by
default) it builds the kernel from the checkout's ``csrc/chain.cu`` and, with
``--against``, a second version of that source with the same C interface
(for example the parent commit's, unpacked with ``git archive``), then for
each version, at the band of its own ``kernels/chain.py::_plan`` (the
other's where it sits in a checkout beside its source):

- checks the outputs against the plain version bit for bit on inputs whose
  sums are exact in float32 (sparse weights of +-1 and +-0.5, quantizer
  values, power-of-two scales);
- times 20 back-to-back launches between CUDA events after 3 warm-up ones,
  in turns (this, other, other, this) on random inputs;
- for a source with phase hooks (``CHAIN_PHASES``), counts clock64 cycles
  per block in each phase with a copy built with ``-DCHAIN_PHASES``, in
  which thread 0 of every block adds them up: each GEMM's mainloops
  (including the wait at the barrier before it) and its epilogues.

With ``--serve PAIRS`` it also times the fused ResNet-50 executor
(``InferenceEngine("resnet", qbit=8)``, random weights from seed 0) at
batch 64 and 256 with K6 off (``chain=frozenset()``, JAX's placement)
against ``chain={2}``, ``chain={3}`` and ``chain={2, 3}``, each in turns
with K6 off (chain, off, off, chain, PAIRS times, after one untimed round
of each): images/s from CUDA events around 16 back-to-back forwards, each
turn listed; the ``chain`` default is decided on them.  It prints the
card's name and power limit first.  Needs a CUDA device and
nvcc; it is a measuring tool, not part of the serving path.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import pathlib
import subprocess
import tempfile

import torch

from cnns_slfp_quantization_tpu_torch.kernels import _build
from cnns_slfp_quantization_tpu_torch.kernels import chain as k6
from cnns_slfp_quantization_tpu_torch.ops import sfp
from cnns_slfp_quantization_tpu_torch.utils import profiling, turns

SHAPES = {
    "stage1": (64, 28, 28, 512, 128),
    "stage2": (64, 14, 14, 1024, 256),
    "stage3": (64, 7, 7, 2048, 512),
    "stage2_b256": (256, 14, 14, 1024, 256),
    "stage3_b256": (256, 7, 7, 2048, 512),
}
RECIPS = (6.2, 4.0, 5.1)
PHASES = {1: "conv1 mainloops", 2: "conv1 epilogues", 3: "conv2 mainloops",
          4: "conv2 epilogues", 5: "conv3 mainloops", 6: "conv3 epilogues"}


def build(sources: dict, out_dir: pathlib.Path) -> dict:
    """name -> loaded library, every version (and, where it has phase
    hooks, its -DCHAIN_PHASES copy as name + "_dbg") compiled at once."""
    procs = []
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        flags = [("", name)]
        if "CHAIN_PHASES" in text:
            flags.append(("-DCHAIN_PHASES", name + "_dbg"))
        for flag, tag in flags:
            procs.append((tag, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, *([flag] if flag else []),
                 "-I", str(_build.CSRC), "-o", str(out_dir / f"{tag}.so"),
                 str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for tag, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {tag}: {out}")
        lib = ctypes.CDLL(str(out_dir / f"{tag}.so"))
        argtypes = _build.SIGNATURES["chain"]["slfp_bottleneck_chain"]
        # an older source's entry point (the wmma design's) takes neither
        # the split nor the route
        lib.current = "int split" in sources[tag.removesuffix("_dbg")]
        lib.slfp_bottleneck_chain.argtypes = (
            argtypes if lib.current
            else argtypes[:19] + argtypes[20:23] + argtypes[24:])
        lib.slfp_bottleneck_chain.restype = ctypes.c_int
        libs[tag] = lib
    return libs


def inputs(shape, gen, exact: bool):
    n, h, w, c, m = shape
    dev = "cuda"

    def u(*s):
        return torch.rand(*s, device=dev, generator=gen)

    def sign(*s):
        return torch.where(u(*s) < 0.5, -1.0, 1.0)

    if exact:
        every = torch.arange(0x7F80, dtype=torch.int32, device=dev).to(
            torch.int16).view(torch.bfloat16)
        vals = sfp.act_bf16_bits(every, 1.0, 8, True).float().unique()
        vals = vals[(vals >= 0.125) & (vals <= 4)]

        def pick(*s):
            return vals[torch.randint(len(vals), s, device=dev,
                                      generator=gen)]

        def wv(k, *s):
            return (torch.where(u(*s) < 0.5, 0.5, 1.0) * sign(*s)
                    * (u(*s) < 24.0 / k)).to(torch.bfloat16)

        def aff(k):
            return (torch.full((k,), 2.0**-7, device=dev),
                    torch.where(u(k) < 0.2, -40.0, 0.625))
        xq = pick(n, h, w, c).to(torch.bfloat16)
        idn = (pick(n, h, w, c) * sign(n, h, w, c) * 0.125).to(torch.bfloat16)
        return (xq, idn, wv(c, c, m), wv(9 * m, 3, 3, m, m), wv(m, m, c),
                *aff(m), *aff(m), *aff(c))

    def wq(*s):
        return sfp.quantize_weight(torch.randn(*s, device=dev, generator=gen)
                                   * 4, 8).to(torch.bfloat16)

    def aff(k):
        return u(k) * 0.02 + 1e-3, torch.randn(k, device=dev,
                                               generator=gen) * 0.5
    xq = k6.chain_quantize(torch.randn(n, h, w, c, device=dev,
                                       generator=gen).abs() * 3, 1.0)
    idn = (torch.randn(n, h, w, c, device=dev, generator=gen) * 2).to(
        torch.bfloat16)
    return (xq, idn, wq(c, m), wq(3, 3, m, m), wq(m, c), *aff(m), *aff(m),
            *aff(c))


def launcher(lib, args, shape, plan):
    """plan: (rows, split) for the current entry point, rows for the wmma
    design's."""
    n, h, w, c, m = shape
    raw, q = torch.empty_like(args[0]), torch.empty_like(args[0])
    if lib.current:
        head, tail = tuple(plan), (int(k6.ftz_route(args[5:], RECIPS)),)
    else:
        head, tail = (plan,), ()

    def call():
        rc = lib.slfp_bottleneck_chain(
            *(t.data_ptr() for t in args), raw.data_ptr(), q.data_ptr(),
            n, h, w, c, m, *head, *RECIPS, *tail,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")
    return call, raw, q


def ms_per_launch(call, reps=20):
    for _ in range(3):
        call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plan_of(cu: pathlib.Path):
    """The ``_plan`` of the checkout ``cu`` sits in, else this one's."""
    path = cu.resolve().parent.parent / "kernels" / "chain.py"
    if not path.exists():
        return k6._plan
    spec = importlib.util.spec_from_file_location("_other_chain", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._plan


def serve_turns(pairs: int) -> None:
    """Print images/s of the fused ResNet-50 executor with K6 off and
    under each chain policy, in turns."""
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    dev = torch.device("cuda")
    print(turns.FORWARD_NOTE, flush=True)
    for batch in (64, 256):
        x = torch.randn(batch, 224, 224, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))

        def ips(stages):
            eng = InferenceEngine("resnet", qbit=8, batch_size=batch, seed=0,
                                  policy={"chain": stages})
            return lambda: profiling.throughput(lambda: eng.forward(x),
                                                batch)
        off = ips(frozenset())
        for stages in ({2}, {3}, {2, 3}):
            runs = turns.alternate({"chain": ips(stages), "off": off}, pairs)
            print(f"fused resnet b{batch} chain={sorted(stages)}: "
                  + turns.compared(runs), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=pathlib.Path,
                    help="a second chain.cu to compare with")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--serve", type=int, default=0, metavar="PAIRS",
                    help="time fused ResNet-50 under each chain policy")
    a = ap.parse_args()
    card = turns.card()
    if card is None:
        return 2
    print(f"card: {card}", flush=True)
    sources = {"this": (_build.CSRC / "chain.cu").read_text()}
    plans = {"this": k6._plan}
    if a.against:
        sources["other"] = a.against.read_text()
        plans["other"] = plan_of(a.against)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, pathlib.Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        order = ["this", "other", "other", "this"] if a.against else ["this"]
        for key in filter(None, a.shapes.split(",")):
            shape = SHAPES[key]
            n, h = shape[:2]
            rows = {name: plan(*shape) for name, plan in plans.items()}
            args = inputs(shape, gen, exact=True)
            want = k6.bottleneck_chain_plain(
                *args, recip2=RECIPS[0], recip3=RECIPS[1],
                recip_next=RECIPS[2])
            for name in sources:
                call, raw, q = launcher(libs[name], args, shape, rows[name])
                call()
                torch.cuda.synchronize()
                same = all(torch.equal(g.view(torch.int16),
                                       w.view(torch.int16))
                           for g, w in zip((raw, q), want))
                print(f"{key} {shape} rows {rows[name]} {name}: exact inputs "
                      f"{'bit-equal' if same else 'DIFFER'}", flush=True)
            args = inputs(shape, gen, exact=False)
            times = {}
            for name in order:
                call, _, _ = launcher(libs[name], args, shape, rows[name])
                times.setdefault(name, []).append(ms_per_launch(call))
            print(f"{key}: ms per launch "
                  + ", ".join(f"{k} {v}" for k, v in times.items()),
                  flush=True)
            for name in sources:
                lib = libs.get(name + "_dbg")
                if lib is None:
                    continue
                call, _, _ = launcher(lib, args, shape, rows[name])
                call()
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 8)()
                lib.chain_phases(buf, 1)
                call()
                torch.cuda.synchronize()
                lib.chain_phases(buf, 0)
                r, split = rows[name]
                blocks = n * -(-h // r) * split
                total = sum(buf)
                print(f"  {name} cycles per block: " + ", ".join(
                    f"{label} {buf[i] / blocks:.0f} "
                    f"({buf[i] / max(total, 1):.0%})"
                    for i, label in PHASES.items()) + f"; total "
                    f"{total / blocks:.0f}", flush=True)
    if a.serve:
        serve_turns(a.serve)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
