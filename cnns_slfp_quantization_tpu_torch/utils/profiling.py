"""Device timing with CUDA events and torch.profiler (counterpart of the
JAX ``utils/profiling.py``).

Every number here is measured on the card: a function given CPU work, or
run where there is no card, raises instead of timing the host.
"""

from __future__ import annotations

import statistics
from typing import Callable


def _require_cuda():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device")
    return torch


def cuda_times_ms(fn: Callable[[], object], *, iters: int = 20,
                  inner: int = 5, warmup: int = 3) -> list:
    """Milliseconds per call of ``fn`` in each of ``iters`` runs, after
    ``warmup`` untimed calls.  A run is ``inner`` back-to-back calls between
    two CUDA events on the current stream, so that the time of one short
    kernel is not the gap between two event records."""
    torch = _require_cuda()
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        for _ in range(inner):
            fn()
        end.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) / inner for s, e in events]


def median_ms(fn: Callable[[], object], *, iters: int = 20, inner: int = 5,
              warmup: int = 3) -> float:
    """Median over ``iters`` runs of the milliseconds per call."""
    return statistics.median(cuda_times_ms(fn, iters=iters, inner=inner,
                                           warmup=warmup))


def throughput(fn: Callable[[], object], batch: int, *, iters: int = 16,
               warmup: int = 3) -> float:
    """Items per second of ``fn`` processing ``batch`` items per call, from
    CUDA events around ``iters`` back-to-back calls."""
    torch = _require_cuda()
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return batch * iters / (start.elapsed_time(end) / 1e3)


def _hand_launches() -> int:
    from cnns_slfp_quantization_tpu_torch import kernels

    return sum(fn.launches for fn in kernels.WRAPPERS.values())


def whole_runs(seen: list, floor: int) -> list:
    """The device times of the profiled runs that recorded every kernel of
    their calls, from ``seen``, each run's (kernel events, device time):
    those with as many events as the fullest run (losing events never adds
    any), and at least ``floor``, the kernels the calls are known to
    launch.  None qualifies where no run recorded a kernel."""
    full = max([floor] + [n for n, _ in seen])
    return [t for n, t in seen if n == full] if full else []


def kernel_ms(fn: Callable[[], object], *, reps: int = 5, runs: int = 3,
              tries: int = 8) -> float:
    """Device milliseconds per call of the kernels ``fn`` launches, from
    torch.profiler (the host's share excluded): the median of ``runs``
    profiled runs of ``reps`` calls.  Events around back-to-back calls of
    a kernel of a few microseconds would time the host instead.

    The profiler can lose kernel events, and a run that lost some reads
    low.  So only runs that recorded every kernel count
    (:func:`whole_runs`), the hand kernels known from the wrappers' launch
    counts around an unprofiled call; the others are run again, up to
    ``tries * runs`` runs in all, and then it raises."""
    torch = _require_cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    before = _hand_launches()
    fn()
    torch.cuda.synchronize()
    floor = reps * (_hand_launches() - before)
    seen = []           # (kernel events, device us) of each run
    for _ in range(tries * runs):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        seen.append((sum(e.count for e in events),
                     sum(e.self_device_time_total for e in events)))
        whole = whole_runs(seen, floor)
        if len(whole) >= runs:
            return statistics.median(whole[:runs]) / 1e3 / reps
    raise RuntimeError(
        f"torch.profiler recorded every kernel of {reps} calls in only "
        f"{len(whole_runs(seen, floor))} of {len(seen)} runs (kernel events "
        f"per run: {[n for n, _ in seen]}; hand kernels per call: "
        f"{floor // reps})")


def is_f32_copy(name: str) -> bool:
    """A device kernel that widens to float32 (``.to(torch.float32)`` of a
    bf16 tensor): PyTorch's casting copy, ``direct_copy_kernel_cuda`` on a
    float result with a casting load, as its kernel name says."""
    return ("direct_copy_kernel" in name and "LoadWithCast" in name
            and "lambda(float)" in name)


def print_forward_profile(fn: Callable[[], object], batch: int,
                          calls: int = 3, top: int = 14) -> None:
    """Print a forward ``fn`` under torch.profiler, per call after one
    untimed call: wall time between CUDA events, kernel time, the share of
    the wall with no kernel running, the bf16 -> float32 copies
    (:func:`is_f32_copy`) and the ``top`` kernels.  A measurement, not a
    check: a profile with no device time, or whose kernels outlast the
    wall, is reported as not measured."""
    torch = _require_cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / calls
    # kernel events only: operator events repeat their kernels' time
    evs = sorted(((e.key, getattr(e, "self_device_time_total", getattr(
        e, "self_cuda_time_total", 0)) / 1e3 / calls, e.count / calls)
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda e: -e[1])
    evs = [e for e in evs if e[1] > 0]
    if not evs:
        print("  profiler: no device time recorded (not measured)",
              flush=True)
        return
    busy = sum(ms for _, ms, _ in evs)
    idle = 1 - busy / wall
    if idle < -0.01:  # one stream: kernels cannot outlast the wall
        print(f"  profile miscounted: kernels {busy:.3f} ms exceed wall "
              f"{wall:.3f} ms per forward; idle share not measured",
              flush=True)
        return
    copies = [(k, ms, n) for k, ms, n in evs if is_f32_copy(k)]
    print(f"  per forward at batch {batch}: wall {wall:.3f} ms, kernels "
          f"{busy:.3f} ms, idle share {idle:.3f}; bf16 -> f32 copies "
          f"{sum(n for *_, n in copies):.1f} launches, "
          f"{sum(ms for _, ms, _ in copies):.3f} ms", flush=True)
    for key, ms, n in evs[:top]:
        print(f"    {ms:8.3f} ms  x{n:5.1f}  {key[:100]}", flush=True)


# kernel class -> substrings of the kernel names it takes, tried in order
KERNEL_CLASSES = (
    ("K1", ("quantize_kernel", "f32form_kernel")),
    ("K4", ("FusedEpi",)),
    ("cuDNN conv", ("cudnn", "conv", "implicit", "dgrad", "wgrad", "fprop",
                    "Winograd")),
    ("cuBLAS", ("gemm", "cutlass", "cublas", "Kernel2", "splitKreduce")),
)


def kernel_class(name: str) -> str:
    for label, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return label
    return "elementwise"


def phase_profile(phases, calls: int = 3, top: int = 12) -> dict:
    """Where a step's device time goes: ``phases`` is a list of (label, fn)
    run in turn per call.  CUDA events between the phases give each
    phase's span on the device (its kernels and the gaps between them, in
    stream order); torch.profiler over the same calls gives the kernel
    time by class (:func:`kernel_class`) and the ``top`` kernels.
    Returns {"wall": ms, "phases": {label: ms}, "classes": {class: ms},
    "top": [(name, ms, launches)]}, all per call."""
    torch = _require_cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(marks=None):
        for i, (_, fn) in enumerate(phases):
            if marks is not None:
                marks[i].record()
            fn()
        if marks is not None:
            marks[-1].record()

    run()
    torch.cuda.synchronize()
    marks = [[torch.cuda.Event(enable_timing=True)
              for _ in range(len(phases) + 1)] for _ in range(calls)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for m in marks:
            run(m)
        torch.cuda.synchronize()
    out = {"wall": sum(m[0].elapsed_time(m[-1]) for m in marks) / calls,
           "phases": {label: sum(m[i].elapsed_time(m[i + 1])
                                 for m in marks) / calls
                      for i, (label, _) in enumerate(phases)},
           "classes": {}}
    evs = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3 / calls,
            e.count / calls) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    for key, ms, _ in evs:
        c = kernel_class(key)
        out["classes"][c] = out["classes"].get(c, 0.0) + ms
    out["top"] = sorted(evs, key=lambda e: -e[1])[:top]
    return out
