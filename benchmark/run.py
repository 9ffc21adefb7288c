"""One run of one cell of the port's benchmark.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Set-up (imports, inputs and weights from the
seed, the program's build and warm-up) is timed as ``setup_s``; then the
module of the cell's traffic kind (``runners/<kind>.py``) runs its
traffic for ``--seconds`` seconds; then, with ``--trace 1``, a short
traced stretch; then the program's state is freed and the plain
reference recomputes what the window's timed path produced.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared beside its limit, which the
last lines of standard error repeat).  Without as many CUDA devices as the cell asks for, or with JAX or
the JAX package loaded once the window has closed, it prints no result and
exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cnns_slfp_quantization_tpu")
GIB = 2.0 ** 30


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Run:
    """What a per-layer metric's reader reads: the cell, the window's
    end-to-end numbers and host spans, and the traced stretch (None
    without ``--trace 1``)."""

    def __init__(self, cell, window: dict, traced):
        self.kind = cell.traffic["kind"]
        self.config = cell.config
        self.batch = cell.traffic["batch"]
        self.end_to_end = window["end_to_end"]
        self.spans = window["spans"]
        self.trace = traced


def _caches(root: pathlib.Path) -> None:
    """The program's build and kernel caches at fixed paths in the
    checkout (the port builds its kernels into ``build/kernels`` itself)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def execute(cell, seed: int, seconds: float, traced_run: bool, dev):
    """Set-up, window, traced stretch, check: (the result object, or None
    where JAX or the JAX package got loaded)."""
    import torch

    from benchmark import manifest, trace

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    cell.reference = manifest.reference(cell.root, cell.config["reference"])
    mix = manifest.runner(cell.root, cell.traffic["kind"])
    tmpdir = pathlib.Path(tempfile.mkdtemp(prefix="benchmark-"))
    try:
        state = mix.setup(cell, seed, tmpdir, dev)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T0
        window = mix.window(state, seconds)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if forbidden_modules():
            return None
        traced = None
        if traced_run:
            traced = trace.stretch(mix.traced_call(state),
                                   cell.traffic["trace_calls"],
                                   mix.launches(state))
        mix.release(state)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        verdict = mix.check(cell, state, seed, dev)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    measured = dict(window["end_to_end"], peak_mem_gib=peak / GIB,
                    setup_s=setup_s)
    metrics = {}
    if not traced_run:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
    else:
        run = Run(cell, window, traced)
        for m in cell.per_layer:
            v = manifest.reader(cell.root, m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": verdict["correct"],
              "attempted": verdict["attempted"],
              "failed": verdict["failed"], "metrics": metrics,
              "device": device}
    if traced is not None:
        device.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    if "readings" in verdict:
        result["readings"] = verdict["readings"]
    result["checks"] = verdict["checks"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = pathlib.Path.cwd()
    _caches(root)

    import torch

    from benchmark import manifest

    cell = manifest.cell(root, args.workload)
    found = (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    if found < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{found}: no run", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    if result is None or forbidden_modules():
        print(f"JAX or the JAX package is loaded: {forbidden_modules()}: "
              f"no result", file=sys.stderr)
        return 3
    for name, v in result.pop("readings", {}).items():
        print(f"reading {name} {v!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
