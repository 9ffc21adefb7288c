"""Device timing with CUDA events (counterpart of the JAX
``utils/profiling.py``).

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
