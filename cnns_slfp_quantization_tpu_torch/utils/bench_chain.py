"""K6 (``csrc/chain.cu``) on the card: exactness, times and cycles per phase.

    python3 -m cnns_slfp_quantization_tpu_torch.utils.bench_chain \\
        [--against OTHER.cu] [--shapes stage2,stage3,...]

For each shape (ResNet-50's stage 1-3 bottlenecks at batch 64 and 256 by
default) it builds the kernel from the checkout's ``csrc/chain.cu`` and, with
``--against``, a second version of that source with the same C interface,
then for each version:

- checks the outputs against the plain version bit for bit on inputs whose
  sums are exact in float32 (sparse weights of +-1 and +-0.5, quantizer
  values, power-of-two scales);
- times 20 back-to-back launches between CUDA events after 3 warm-up ones,
  in turns (this, other, other, this) on random inputs;
- counts clock64 cycles per block in each phase (conv1, conv2 and conv3
  pipelines, and the epilogues between them) with a copy of the source
  that thread 0 of every block instruments.

It prints the card's name and power limit first.  Needs a CUDA device and
nvcc; it is a measuring tool, not part of the serving path.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import tempfile

import torch

from cnns_slfp_quantization_tpu_torch.kernels import _build
from cnns_slfp_quantization_tpu_torch.kernels import chain as k6
from cnns_slfp_quantization_tpu_torch.ops import sfp

SHAPES = {
    "stage1": (64, 28, 28, 512, 128),
    "stage2": (64, 14, 14, 1024, 256),
    "stage3": (64, 7, 7, 2048, 512),
    "stage2_b256": (256, 14, 14, 1024, 256),
    "stage3_b256": (256, 7, 7, 2048, 512),
}
RECIPS = (6.2, 4.0, 5.1)
PHASES = {1: "conv1 pipelines", 2: "conv1 epilogues", 3: "conv2 pipelines",
          4: "last conv1 + conv2 epilogues", 5: "conv3 pipelines",
          6: "last conv2 + conv3 epilogues", 8: "last conv3 epilogue"}
_DBG = '''
__device__ unsigned long long g_dbg[16];
extern "C" int dbg_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_dbg, sizeof(g_dbg));
}
extern "C" int dbg_zero() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_dbg, z, sizeof(z));
}
#define MARK(k) if (threadIdx.x == 0) { const long long t_ = clock64(); \\
  atomicAdd(&g_dbg[k], (unsigned long long)(t_ - t_mark)); t_mark = t_; }
'''


def instrument(src: str) -> str:
    """The source with cycle markers: after each chunk's accumulators are
    zeroed (even slots: the epilogues since the last marker) and after each
    pipeline (odd slots), and at the end of the kernel (slot 8)."""
    s = src.replace("namespace {\n", _DBG + "namespace {\n", 1)
    s = s.replace("  FragC acc[kHalf][2];\n",
                  "  long long t_mark = clock64();\n  FragC acc[kHalf][2];\n",
                  1)
    n = iter(range(1, 8, 2))
    s = re.sub(r"          \}\);(?=\n#pragma unroll)",
               lambda m: m.group(0) + f"\n      MARK({next(n)})", s)
    n = iter(range(2, 8, 2))
    s = re.sub(r"      zero_acc\(acc\);",
               lambda m: m.group(0) + f"\n      MARK({next(n)})", s)
    end = s.index("}  // namespace")
    body_end = s.rindex("}", 0, s.rindex("}", 0, end))
    return s[:body_end] + "  MARK(8)\n" + s[body_end:]


def build(sources: dict, out_dir: pathlib.Path) -> dict:
    """name -> loaded library, every version and its instrumented copy
    compiled at once."""
    procs = []
    for name, text in sources.items():
        for tag, body in ((name, text), (name + "_dbg", instrument(text))):
            cu = out_dir / f"{tag}.cu"
            cu.write_text(body)
            procs.append((tag, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 "-o", str(out_dir / f"{tag}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for tag, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {tag}: {out}")
        lib = ctypes.CDLL(str(out_dir / f"{tag}.so"))
        lib.slfp_bottleneck_chain.argtypes = \
            _build.SIGNATURES["chain"]["slfp_bottleneck_chain"]
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


def launcher(lib, args, shape, rows):
    n, h, w, c, m = shape
    raw, q = torch.empty_like(args[0]), torch.empty_like(args[0])

    def call():
        rc = lib.slfp_bottleneck_chain(
            *(t.data_ptr() for t in args), raw.data_ptr(), q.data_ptr(),
            n, h, w, c, m, rows, *RECIPS,
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=pathlib.Path,
                    help="a second chain.cu to compare with")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_chain: no CUDA device")
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    sources = {"this": (_build.CSRC / "chain.cu").read_text()}
    if a.against:
        sources["other"] = a.against.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, pathlib.Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        order = ["this", "other", "other", "this"] if a.against else ["this"]
        for key in a.shapes.split(","):
            shape = SHAPES[key]
            n, h = shape[:2]
            rows = k6._plan(*shape)
            args = inputs(shape, gen, exact=True)
            want = k6.bottleneck_chain_plain(
                *args, recip2=RECIPS[0], recip3=RECIPS[1],
                recip_next=RECIPS[2])
            for name in sources:
                call, raw, q = launcher(libs[name], args, shape, rows)
                call()
                torch.cuda.synchronize()
                same = all(torch.equal(g.view(torch.int16),
                                       w.view(torch.int16))
                           for g, w in zip((raw, q), want))
                print(f"{key} {shape} rows {rows} {name}: exact inputs "
                      f"{'bit-equal' if same else 'DIFFER'}", flush=True)
            args = inputs(shape, gen, exact=False)
            times = {}
            for name in order:
                call, _, _ = launcher(libs[name], args, shape, rows)
                times.setdefault(name, []).append(ms_per_launch(call))
            print(f"{key}: ms per launch "
                  + ", ".join(f"{k} {v}" for k, v in times.items()),
                  flush=True)
            for name in sources:
                lib = libs[name + "_dbg"]
                call, _, _ = launcher(lib, args, shape, rows)
                call()
                torch.cuda.synchronize()
                lib.dbg_zero()
                call()
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 16)()
                lib.dbg_read(buf)
                blocks = n * -(-h // rows)
                print(f"  {name} cycles per block: " + ", ".join(
                    f"{label} {buf[i] / blocks:.0f}"
                    for i, label in PHASES.items()) + f"; total "
                    f"{sum(buf) / blocks:.0f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
