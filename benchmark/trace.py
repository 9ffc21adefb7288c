"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a few
calls of the cell's timed path after the window, read into the device's
busy time, the stretch's length, time by kernel class and the longest idle
gaps by what the host was doing.

A trace can lose its first records (seen on the H100 in long-lived
processes), so the stretch starts with one untraced-for-counting call and
a marker kernel, and only what follows the marker counts.  The hand
kernels' launches that follow it are held against the launches the
program counted at its capture times the calls traced: a trace that lost
events is taken again (at most :data:`TRIES` times), and then fails the
run rather than read low.
"""

from __future__ import annotations

import re

import torch

from benchmark.kernel_class import HAND_KERNELS, device_op_class

MARKER = "spin_kernel"      # torch.cuda._sleep's kernel, as traces name it
TRIES = 3
TOP = 10


class LostEvents(RuntimeError):
    """Every try of the traced stretch lost device records."""


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _take(call, calls: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with record_function("bench.stretch"):
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
    events = prof.events()
    # the host spans' annotations are mirrored onto the device's timeline
    # under their own names: they are no device operation
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("bench.")),
                 key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(dev) if MARKER in e.name]
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("bench.")]
    return (dev[marks[-1] + 1:] if marks else None), host


def stretch(call, calls: int, launches: dict) -> dict:
    """Trace ``calls`` calls of ``call`` (each ends on the host, or the
    stretch ends in a synchronise) and read the trace; ``launches``: the
    hand kernels' launches of one call, by wrapper."""
    want = {w: n * calls for w, n in launches.items()
            if w in HAND_KERNELS and n}
    seen = None
    for _ in range(TRIES):
        dev, host = _take(call, calls)
        if dev is None:
            seen = "the marker kernel"
            continue
        got = {w: sum(bool(re.search(HAND_KERNELS[w], e.name)) for e in dev)
               for w in want}
        if got == want:
            return _read(dev, host, calls)
        seen = f"hand kernels {got}, launched {want}"
    raise LostEvents(f"the trace lost device records in {TRIES} tries: "
                     f"{seen}")


def _read(dev, host, calls: int) -> dict:
    span = next(e for e in host if e.name == "bench.stretch")
    t0 = span.time_range.start
    t1 = max([span.time_range.end] + [e.time_range.end for e in dev])
    busy = _union((max(e.time_range.start, t0), min(e.time_range.end, t1))
                  for e in dev if e.time_range.end > t0)
    busy_us = sum(e - s for s, e in busy)
    classes = {}
    for e in dev:
        c = device_op_class(e.name)
        classes[c] = classes.get(c, 0.0) + e.time_range.elapsed_us()
    gaps, prev = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    spans = [e for e in host if e.name != "bench.stretch"]

    def doing(t):
        inner = [e for e in spans
                 if e.time_range.start <= t < e.time_range.end]
        if not inner:
            return "host, between calls"
        return min(inner, key=lambda e: e.time_range.elapsed_us()).name
    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (t1 - t0) / 1e6,
        "calls": calls,
        "device_ops": sorted(([c, us / 1e6] for c, us in classes.items()),
                             key=lambda r: -r[1])[:TOP],
        "idle_gaps": [[doing(s), (e - s) / 1e6] for s, e in gaps[:TOP]],
    }
