"""Device timing with CUDA events and torch.profiler (counterpart of the
JAX ``utils/profiling.py``), and the program's own spans and counters.

- :class:`StepTimer`: wall-clock seconds per item with percentile
  summaries, JAX's keys.
- :func:`span`, :func:`count`, :func:`spans`, :func:`counters`,
  :func:`reset`: spans and counters kept in host memory (:class:`SpanStore`),
  stamped on torch.profiler's clock.  Set-up spans (an engine's build, a
  graph's capture, the kernels' build) always record; the spans of each
  request or step record only while a torch.profiler session records or
  inside :func:`recording`, and cost one flag read otherwise.
- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome / TensorBoard trace for offline analysis, with the program's spans
  of its session merged in.

Every number here is measured on the card: a function given CPU work, or
run where there is no card, raises instead of timing the host.  The two
``scan_*`` functions (``parallel/scaling_bench.py``) are the exception:
given CPU tensors they loop eager calls and time the host clock, which the
CPU tests read as a count of images per second and nothing else.  Given
CUDA tensors they do what JAX's one jitted ``lax.scan`` does: the forward
or the train step runs as one CUDA graph (:class:`GraphedForward`,
``train.loop.GraphedTrainStep``) replayed per step, so that the host does
not set the pace, timed by CUDA events.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import pathlib
import re
import socket
import statistics
import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class StepTimer:
    """Wall-clock samples, in seconds per item, of the steps between
    :meth:`start` and :meth:`stop` (JAX's ``StepTimer``)."""

    def __init__(self):
        self.samples: list[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, items: int = 1):
        dt = time.perf_counter() - self._t0
        self.samples.append(dt / max(items, 1))
        return dt

    def summary(self) -> dict:
        if not self.samples:
            return {}
        a = np.asarray(self.samples)
        return {
            "mean_s": float(a.mean()),
            "p50_s": float(np.percentile(a, 50)),
            "p95_s": float(np.percentile(a, 95)),
            "best_s": float(a.min()),
            "items_per_sec": float(1.0 / a.min()),
        }


# ------------------------------------------------------------------ spans

RING = 4096        # spans kept of each name (count, total and max cover all)

clock_ns = time.time_ns
"""The spans' clock: torch.profiler's own, on which a session's
``kineto_results.trace_start_ns()`` lies and from which its records'
``time_range`` (microseconds after that start) are counted; so program
spans and profiler records share one axis.  Unix time in nanoseconds, for
host records and, on the H100, for the device's."""

_profiler_enabled = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """A finished span.  ``start_ns`` / ``end_ns`` on :data:`clock_ns`;
    ``parent``: the name of the span it ran inside (None at the top);
    ``call``: the id every span of one request, step or build shares;
    ``self_ns``: its length less the part its child spans cover.  A
    ``device`` span was timed between two CUDA events: its length is the
    device's, and it is placed at the host time it was registered."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    call: int
    self_ns: int
    device: bool = False

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class SpanStats:
    """The spans of one name: how many, their total and longest length in
    ns, and the last ``RING`` of them (``samples``)."""

    __slots__ = ("count", "total_ns", "max_ns", "samples")

    def __init__(self, ring: int = RING):
        self.count = self.total_ns = self.max_ns = 0
        self.samples = collections.deque(maxlen=ring)

    def add(self, s: tuple, ns: int) -> None:
        self.count += 1
        self.total_ns += ns
        if ns > self.max_ns:
            self.max_ns = ns
        self.samples.append(s)

    @property
    def mean_ns(self) -> Optional[float]:
        return self.total_ns / self.count if self.count else None


class SpanStore:
    """Spans and counters in host memory, bounded: per name a count, a
    total, a maximum and the last ``ring`` spans; at most ``ring`` device
    spans awaiting their events.  Thread-safe; each thread nests its own
    spans."""

    def __init__(self, ring: int = RING):
        self.ring = ring
        self.forced = 0          # depth of recording()
        # bumped where a recording stretch starts (recording(), trace(),
        # reset()): a device span between two requests needs both in one
        self.epoch = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._stats: dict[str, SpanStats] = {}
        self._counters: dict[str, int] = {}
        # key -> (names, events, anchor ns, parent, call), oldest first
        self._pending: dict = {}

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            stack = self._local.stack = []
            return stack

    def _top(self):
        """(the open span's name, its call id), or a new call id."""
        stack = self._stack()
        if stack:
            return stack[-1][0], stack[-1][3]
        return None, next(self._ids)

    def _add(self, name: str, start: int, end: int, parent, call: int,
             self_ns: int, device: bool = False) -> None:
        # a plain tuple per span (a Span on read): the recording path is
        # the hot one
        lock = self._lock
        lock.acquire()
        try:
            stats = self._stats.get(name)
            if stats is None:
                stats = self._stats[name] = SpanStats(self.ring)
            stats.add((name, start, end, parent, call, self_ns, device),
                      end - start)
        finally:
            lock.release()

    def open(self, name: str) -> list:
        """Start a span: the frame to give :meth:`close`."""
        stack = self._stack()
        # name, start, the children's ns, call id
        frame = [name, clock_ns(), 0,
                 stack[-1][3] if stack else next(self._ids)]
        stack.append(frame)
        return frame

    def close(self, frame: list) -> None:
        end = clock_ns()
        stack = self._stack()
        if stack[-1] is frame:
            stack.pop()
        else:       # by identity: two frames may hold equal values
            del stack[next(i for i in range(len(stack) - 1, -1, -1)
                           if stack[i] is frame)]
        self.host_span(frame[0], frame[1], end, frame[2], call=frame[3])

    def host_span(self, name: str, start: int, end: int, children: int = 0,
                  call: Optional[int] = None) -> None:
        """Record a host span that ran from ``start`` to ``end`` inside the
        span now open (its parent)."""
        stack = self._stack()
        ns = end - start
        if stack:
            parent = stack[-1]
            parent[2] += ns
            self._add(name, start, end, parent[0],
                      parent[3] if call is None else call, ns - children)
        else:
            self._add(name, start, end, None,
                      next(self._ids) if call is None else call,
                      ns - children)

    def device(self, names, events, key=None) -> None:
        """Register the device spans ``names[i]``, from ``events[i]`` to
        ``events[i + 1]`` (recorded already, in stream order), inside the
        span now open; resolved by :meth:`poll`.  An unresolved earlier
        registration under the same ``key`` is dropped: its events were
        recorded again."""
        parent, call = self._top()
        item = (tuple(names), tuple(events), clock_ns(), parent, call)
        key = object() if key is None else key
        with self._lock:
            self._pending.pop(key, None)
            self._pending[key] = item
            while len(self._pending) > self.ring:
                del self._pending[next(iter(self._pending))]

    def poll(self, wait: bool = False) -> None:
        """Record the registered device spans whose last event the device
        has passed (``Event.query``, no synchronise); with ``wait``, all of
        them, synchronising on each."""
        with self._lock:
            items = list(self._pending.items())
        for key, item in items:
            names, events, anchor, parent, call = item
            if wait:
                events[-1].synchronize()
            elif not events[-1].query():
                continue
            with self._lock:
                if self._pending.get(key) is not item:
                    continue
                del self._pending[key]
            start = anchor
            for name, a, b in zip(names, events, events[1:]):
                ns = round(a.elapsed_time(b) * 1e6)
                self._add(name, start, start + ns, parent, call, ns, True)
                start += ns

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def stats(self, name: str) -> SpanStats:
        """A copy of ``name``'s spans, the device spans registered so far
        resolved first."""
        self.poll(wait=True)
        out = SpanStats(self.ring)
        with self._lock:
            got = self._stats.get(name)
            if got is not None:
                out.count, out.total_ns, out.max_ns = (
                    got.count, got.total_ns, got.max_ns)
                out.samples.extend(map(Span._make, got.samples))
        return out

    def since(self, start_ns: int) -> list:
        """Every kept span that started at ``start_ns`` or later, device
        spans resolved first."""
        self.poll(wait=True)
        with self._lock:
            return sorted((Span._make(s) for st in self._stats.values()
                           for s in st.samples if s[1] >= start_ns),
                          key=lambda s: s.start_ns)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            self.epoch += 1
            self._stats.clear()
            self._counters.clear()
            self._pending.clear()


STORE = SpanStore()
"""The process's spans and counters."""


def on() -> bool:
    """Whether the spans of each request or step record: inside
    :func:`recording`, or while a torch.profiler session records."""
    return STORE.forced > 0 or _profiler_enabled()


@contextlib.contextmanager
def recording():
    """Record the spans of each request and step inside the block, without
    a profiler."""
    with STORE._lock:
        STORE.forced += 1
        STORE.epoch += 1
    try:
        yield STORE
    finally:
        with STORE._lock:
            STORE.forced -= 1


class span:
    """``with span(name):`` records a span of the enclosed block, a child of
    the span open around it.  It records whenever it runs: a per-call path
    takes :func:`span_if` instead."""

    __slots__ = ("name", "_frame")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._frame = STORE.open(self.name)
        return self

    def __exit__(self, *exc):
        STORE.close(self._frame)
        return False


NULL = contextlib.nullcontext()


def span_if(rec: bool, name: str):
    """``span(name)`` where ``rec`` (the call's one read of :func:`on`),
    else a shared context that does nothing: a per-call path's span."""
    return span(name) if rec else NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    STORE.count(name, n)


def device_span(name: str, start, end) -> None:
    """The device span ``name`` between two recorded timing CUDA events,
    inside the span now open; resolved without a synchronise
    (:func:`poll`), or when the store is read."""
    STORE.device((name,), (start, end))


def poll() -> None:
    """Record the device spans whose events the device has passed."""
    STORE.poll()


def spans(name: str) -> SpanStats:
    """The spans of ``name`` recorded so far (count 0 where none)."""
    return STORE.stats(name)


def counters() -> dict:
    return STORE.counters()


def reset() -> None:
    """Forget every span, counter and unresolved device span."""
    STORE.reset()


class StepPhases:
    """The marks between the phases ``names`` of a step: ``mark(i)`` at the
    start of phase i and ``mark(len(names))`` after the last.  On the card
    they record timing CUDA events, made once with ``external=True`` so that
    a CUDA graph's capture keeps them as event-record nodes and each replay
    times its own phases (:meth:`pend` registers a replay's); an eager step
    on the card records them while :func:`on` and registers them itself.
    On the CPU they stamp host spans while :func:`on`."""

    def __init__(self, names):
        self.names = tuple(names)
        self.events = None

    def marker(self, cuda: bool):
        """The ``mark`` of one step, or None where nothing is timed
        (recording off and no capture running).  ``mark.step_span``: the
        step records its own span around its phases."""
        if cuda and torch.cuda.is_current_stream_capturing():
            return _EventMarks(self, False)
        if not on():
            return None
        return _EventMarks(self, True) if cuda else _HostMarks(self.names)

    def pend(self) -> None:
        """Register the device spans of the replay just enqueued."""
        if self.events is not None:
            STORE.device(self.names, self.events, key=self)


class _EventMarks:
    def __init__(self, phases: StepPhases, eager: bool):
        self.phases, self.step_span = phases, eager
        if phases.events is None:
            phases.events = [torch.cuda.Event(enable_timing=True,
                                              external=True)
                             for _ in range(len(phases.names) + 1)]

    def __call__(self, i: int) -> None:
        if i == 0 and self.step_span:
            STORE.poll()         # the last step's, before it is recorded over
        self.phases.events[i].record()
        if i == len(self.phases.names) and self.step_span:
            self.phases.pend()


class _HostMarks:
    step_span = True

    def __init__(self, names):
        self.names, self.last = names, None

    def __call__(self, i: int) -> None:
        now = clock_ns()
        if i:
            STORE.host_span(self.names[i - 1], self.last, now)
        self.last = now


@contextlib.contextmanager
def trace(log_dir):
    """torch.profiler around the enclosed block, written as a Chrome /
    TensorBoard trace (``<host>_<pid>.<ns>.pt.trace.json``) under
    ``log_dir`` when the block ends, with the program's spans of the
    session merged in on the trace's own time axis (host spans on one row,
    device spans on another).  Activities: the CPU, and CUDA where a card
    is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    start = clock_ns()
    with STORE._lock:
        STORE.epoch += 1

    def ready(prof):
        out = pathlib.Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / (f"{socket.gethostname()}_{os.getpid()}."
                      f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(str(path))
        merge_spans(path, STORE.since(start))

    with profile(activities=activities, on_trace_ready=ready):
        yield log_dir


SPAN_ROWS = {False: ("program spans", 1 << 30),
             True: ("program device spans (placed at registration)",
                    (1 << 30) + 1)}


def merge_spans(path, kept) -> None:
    """Add the spans ``kept`` to the Chrome trace at ``path``, on its time
    axis: microseconds after the file's ``baseTimeNanoseconds``."""
    path = pathlib.Path(path)
    doc = json.loads(path.read_text())
    base = doc.get("baseTimeNanoseconds", 0)
    events = doc.setdefault("traceEvents", [])
    pid = os.getpid()
    for label, tid in SPAN_ROWS.values():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": label}})
    for s in kept:
        events.append({"ph": "X", "cat": "program_span", "name": s.name,
                       "pid": pid, "tid": SPAN_ROWS[s.device][1],
                       "ts": (s.start_ns - base) / 1e3, "dur": s.ns / 1e3,
                       "args": {"call": s.call, "parent": s.parent,
                                "self_us": s.self_ns / 1e3}})
    path.write_text(json.dumps(doc))


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


def _best_of_3(run, device) -> float:
    """Seconds of the fastest of three calls of ``run`` after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    import time

    import torch

    run()
    best = float("inf")
    for _ in range(3):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
    return best


def _perturbed(x0, i: int):
    """JAX's per-step input ``x0 * (1 + i * 1e-6)`` in x0's type: the
    factor ``1 + f32(i) * f32(1e-6)`` rounded once to float32, as XLA
    computes it (one fused multiply-add; the float64 sum is exact)."""
    factor = np.float32(1.0 + i * float(np.float32(1e-6)))
    return (x0.float() * factor).to(x0.dtype)


def capture(fn: Callable[[], object], device, before=None, generator=None):
    """``fn`` captured in a CUDA graph, torch's whole-network recipe: one
    eager call on a side stream first (it builds the kernels and what an
    executor or optimizer lays out at its first call), then ``before()``,
    then the capture, with ``generator`` registered where given.  Returns
    (the graph, ``fn``'s output tensors from the capture, which each
    replay overwrites, the hand kernels' launches of one replay: the
    wrappers count a captured launch once, a replay runs it without
    Python).  Recorded as the span ``graph.capture`` (the eager call and
    the capture; a kernel library first loaded in the eager call records
    its ``kernels.load``, nvcc's build included, inside it) and the counter
    ``graph.captures``; a step's :class:`StepPhases` record their events
    in the capture."""
    from cnns_slfp_quantization_tpu_torch import kernels

    with span("graph.capture"):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        if before is not None:
            before()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        counts = kernels.launches()
        with torch.cuda.graph(graph):
            out = fn()
        after = kernels.launches()
    count("graph.captures")
    return graph, out, {k: after[k] - counts[k] for k in after}


def graph_ms(fn: Callable[[], object], calls: int, *, reps: int = 5,
             device=None) -> float:
    """Milliseconds per call of ``fn``, ``calls`` calls of it captured in
    one CUDA graph (:func:`capture`) and replayed between CUDA events: the
    median of 3 timings of ``reps`` replays after one.  The time runs from
    the first kernel to the last, with the graph's gaps between kernels
    (under a microsecond each) but no host time; unlike the profiler's
    kernel records it cannot be lost or misread in a long-lived process."""
    torch = _require_cuda()

    def run():
        for _ in range(calls):
            fn()

    graph, out, _ = capture(run, device or torch.device("cuda"))
    graph.replay()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (reps * calls))
    del graph, out
    return statistics.median(times)


class GraphedForward:
    """``forward`` captured once in a CUDA graph on ``x``'s shape, under
    ``torch.inference_mode`` (:func:`capture`); each call copies its input
    into the graph's and replays it, returning the graph's output tensor
    (overwritten by the next call), and while spans record (:func:`on`)
    records the two as ``<spans>.copy_in`` and ``<spans>.replay``.
    ``launches``: the hand kernels' launches of one replay."""

    def __init__(self, forward: Callable, x, spans: str = "graph"):
        if not x.is_cuda:
            raise ValueError("a CUDA graph needs the input on the card")
        self.x = x.clone()

        def run():
            with torch.inference_mode():
                return forward(self.x)

        self.graph, self.out, self.launches = capture(run, x.device)
        self.spans = (f"{spans}.copy_in", f"{spans}.replay")

    def __call__(self, x):
        rec = on()
        with span_if(rec, self.spans[0]):
            self.x.copy_(x)
        with span_if(rec, self.spans[1]):
            self.graph.replay()
        return self.out


def _graph_mode(graph, x0) -> bool:
    """The scans' mode: a CUDA graph on the card unless ``graph=False``;
    never on the CPU."""
    if graph is None:
        return x0.is_cuda
    if graph and not x0.is_cuda:
        raise ValueError("graph=True needs CUDA tensors")
    return bool(graph)


def scan_throughput(forward: Callable, x0, *, steps: int = 8,
                    graph=None) -> float:
    """Images per second of ``forward`` over ``steps`` calls on ``x0``
    perturbed per call as JAX's ``scan_throughput`` perturbs it (so no call
    repeats another's input); the fastest of three timed runs after one
    untimed run.  On the card the forward is one CUDA graph replayed per
    call (:class:`GraphedForward`); ``graph=False`` calls ``forward`` as it
    is: eager calls, as on the CPU, or the replays of a graph the caller
    captured (``InferenceEngine.throughput``)."""
    import torch

    xs = [_perturbed(x0, i) for i in range(steps)]
    if _graph_mode(graph, x0):
        graphed = GraphedForward(forward, x0)

        def run():
            for x in xs:
                graphed(x)
    else:
        def run():
            with torch.inference_mode():
                for x in xs:
                    forward(x)

    return x0.shape[0] * steps / _best_of_3(run, x0.device)


def scan_train_throughput(train_step: Callable, state, x0, y0, *,
                          steps: int = 8, generator=None,
                          graph=None) -> float:
    """Images per second of ``steps`` full train steps (forward, backward,
    optimizer) of ``train_step`` on ``x0`` perturbed per step as in JAX's
    ``scan_train_throughput``; the fastest of three timed runs after one
    untimed run.  The state advances through every step of all four runs.
    On the card the step is one CUDA graph replayed per step
    (``train.loop.GraphedTrainStep``, which refuses what it cannot
    capture; ``graph=False``: eager steps, as on the CPU and under a
    mesh)."""
    from cnns_slfp_quantization_tpu_torch.train.loop import GraphedTrainStep

    xs = [_perturbed(x0, i) for i in range(steps)]
    if _graph_mode(graph, x0):
        graphed = GraphedTrainStep(train_step, state, x0, y0, generator)

        def run():
            for x in xs:
                graphed(x, y0)
    else:
        def run():
            for x in xs:
                train_step(state, x, y0, generator)

    return x0.shape[0] * steps / _best_of_3(run, x0.device)


MARKER = "spin_kernel"     # torch.cuda._sleep's kernel, as traces name it


class MarkerLost(RuntimeError):
    """A trace lost its marker kernel with its first records."""


def after_marker(events) -> list:
    """The device records of a trace that follow its last marker kernel
    (:data:`MARKER`), in start order.

    A trace can lose its first records: on the H100, after other traces in
    one process, from a few to a few hundred, the same in trace after
    trace.  So a traced window starts with one call of the work and then
    the marker (:func:`marked_trace`), and only what follows the marker
    counts; a trace that lost the marker too raises."""
    evs = sorted(events, key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(evs) if MARKER in e.name]
    if not marks:
        raise MarkerLost(f"the trace lost its marker kernel ({len(evs)} "
                         f"device records kept): not measured")
    return evs[marks[-1] + 1:]


def by_name(events, calls: int) -> list:
    """[(kernel name, device ms per call, launches per call)] of device
    records, the longest first."""
    out = {}
    for e in events:
        ms, n = out.get(e.name, (0.0, 0))
        out[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / calls, n + 1)
    return sorted(((k, ms, n / calls) for k, (ms, n) in out.items()),
                  key=lambda e: -e[1])


@contextlib.contextmanager
def marked_trace(lead_in: Callable[[], object]):
    """torch.profiler around the enclosed block, after one untimed call of
    ``lead_in`` and a marker kernel inside the trace; yields a list that
    holds, when the block ends (synchronised), the device records that
    follow the marker (:func:`after_marker`)."""
    torch = _require_cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kept: list = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead_in()
        torch.cuda._sleep(1)
        yield kept
        torch.cuda.synchronize()
    kept += after_marker(e for e in prof.events()
                         if e.device_type == DeviceType.CUDA)


def busy_ms(fn: Callable[[], object], calls: int = 3):
    """(wall ms, kernel ms, {kernel class: ms}, {wrapper: launches}): CUDA
    events around ``calls`` calls after one untimed call, and
    torch.profiler's device time of their kernels over the same calls, by
    :func:`kernel_class` (kernel ms None where it recorded none), all per
    call; and the hand kernels the trace holds over all ``calls`` calls,
    counted by name (:data:`HAND_KERNELS`): a CUDA graph's replay launches
    them without Python, where no wrapper counts.  The idle share is
    ``1 - kernel / wall``.  The trace starts with a lead-in call and a
    marker kernel (:func:`marked_trace`)."""
    torch = _require_cuda()

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with marked_trace(fn) as evs:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
    classes, launches = {}, dict.fromkeys(HAND_KERNELS, 0)
    for e in evs:
        c = kernel_class(e.name)
        classes[c] = (classes.get(c, 0.0)
                      + e.time_range.elapsed_us() / 1e3 / calls)
        for name, pattern in HAND_KERNELS.items():
            launches[name] += bool(re.search(pattern, e.name))
    busy = sum(classes.values())
    return start.elapsed_time(end) / calls, (busy or None), classes, launches


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
    profiled runs of ``reps`` calls that recorded every kernel
    (:func:`kernel_profile`).  Events around back-to-back calls of a
    kernel of a few microseconds would time the host instead."""
    return kernel_profile(fn, reps, runs=runs, tries=tries)["ms"]


LEAD_DOUBLINGS = 4


def kernel_profile(fn: Callable[[], object], calls: int, *, runs: int = 3,
                   tries: int = 8, lead: int = 16) -> dict:
    """{"ms", "classes", "launches", "kernels"}: the device milliseconds
    per call of the kernels ``fn`` launches, in all and by
    :func:`kernel_class`, the hand kernels per call counted by name
    (:data:`HAND_KERNELS`) and the device kernels per call, from the run
    whose time is the median of ``runs`` profiled runs of ``calls`` calls,
    each after ``lead`` lead-in calls and a marker kernel
    (:func:`marked_trace`); a trace that lost its first records, the
    marker with them, is run again with twice the lead-in, at most
    :data:`LEAD_DOUBLINGS` times, and then :class:`MarkerLost` is raised.
    The profiler can lose kernel events, and a run that lost some reads
    low: only runs that recorded every kernel count (:func:`whole_runs`:
    the fullest runs, and at least the hand kernels the wrappers count
    around an unprofiled call); the others are run again, up to ``tries *
    runs`` runs in all, and then it raises."""
    torch = _require_cuda()

    fn()
    before = _hand_launches()
    fn()
    torch.cuda.synchronize()
    floor = calls * (_hand_launches() - before)
    seen, kept_runs, doublings = [], [], 0
    for _ in range(tries * runs):
        try:
            with marked_trace(lambda: [fn() for _ in range(lead)]) as kept:
                for _ in range(calls):
                    fn()
        except MarkerLost:
            if doublings == LEAD_DOUBLINGS:
                raise
            lead, doublings = lead * 2, doublings + 1
            continue
        seen.append((len(kept), sum(e.time_range.elapsed_us()
                                    for e in kept)))
        kept_runs.append(kept)
        if len(whole_runs(seen, floor)) >= runs:
            break
    else:
        raise RuntimeError(
            f"torch.profiler recorded every kernel of {calls} calls in only "
            f"{len(whole_runs(seen, floor))} of {len(seen)} traced runs "
            f"(kernel records per run: {[n for n, _ in seen]}; hand kernels "
            f"per call: {floor // calls})")
    full = max(n for n, _ in seen)
    whole = sorted((t, i) for i, (n, t) in enumerate(seen) if n == full)
    kept = kept_runs[whole[len(whole) // 2][1]]
    classes, launches = {}, dict.fromkeys(HAND_KERNELS, 0.0)
    for e in kept:
        c = kernel_class(e.name)
        classes[c] = (classes.get(c, 0.0)
                      + e.time_range.elapsed_us() / 1e3 / calls)
        for name, pattern in HAND_KERNELS.items():
            launches[name] += bool(re.search(pattern, e.name)) / calls
    return {"ms": sum(classes.values()), "classes": classes,
            "launches": launches, "kernels": len(kept) / calls}


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
    (:func:`is_f32_copy`) and the ``top`` kernels.  The trace starts with a
    lead-in call and a marker kernel (:func:`marked_trace`).  A
    measurement, not a check: a profile with no device time, or whose
    kernels outlast the wall, is reported as not measured."""
    torch = _require_cuda()

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with marked_trace(fn) as kept:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
    wall = start.elapsed_time(end) / calls
    evs = [e for e in by_name(kept, calls) if e[1] > 0]
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


# kernel wrapper -> the name of the device kernel one call launches, as the
# trace spells it (split-K's second pass, ``splitk_reduce``, not counted)
HAND_KERNELS = {
    "act_quantize": r"\bquantize_kernel<",
    "slfp34_act_quantize": r"\bf32form_kernel<",
    "qmm_fused": r"\bgemm_kernel<.*\bQmmEpi\b",
    "bn_epilogue": r"\bepilogue_(slab|any)\b",
    "fused_quant_matmul": r"\bgemm_kernel<.*\bFusedEpi\b",
    "dw3x3": r"\bdw3x3_kernel<",
    "bottleneck_chain": r"\bchain_kernel<",
    "qsgd_update": r"\bqsgd_update_kernel<",
}

# kernel class of each hand kernel's launches, by wrapper; split-K's second
# pass goes with the GEMM whose epilogue type it carries
HAND_CLASSES = {
    "act_quantize": "K1", "slfp34_act_quantize": "K1", "qmm_fused": "K2",
    "bn_epilogue": "K3", "fused_quant_matmul": "K4", "dw3x3": "K5",
    "bottleneck_chain": "K6", "qsgd_update": "K7",
}
SPLITK_CLASSES = ((r"\bsplitk_reduce<.*\bQmmEpi\b", "K2"),
                  (r"\bsplitk_reduce<.*\bFusedEpi\b", "K4"))

# library class -> substrings of the kernel names it takes, tried in order
# after the hand kernels
LIBRARY_CLASSES = (
    ("cuDNN conv", ("cudnn", "conv", "implicit", "dgrad", "wgrad", "fprop",
                    "Winograd")),
    ("cuBLAS", ("gemm", "cutlass", "cublas", "Kernel2", "splitKreduce")),
)


def kernel_class(name: str) -> str:
    """A device kernel's class by its trace name: its hand kernel (K1-K7,
    :data:`HAND_KERNELS`, split-K's second pass with its GEMM) before any
    library substring, else cuDNN, cuBLAS or elementwise."""
    for wrapper, pattern in HAND_KERNELS.items():
        if re.search(pattern, name):
            return HAND_CLASSES[wrapper]
    for pattern, label in SPLITK_CLASSES:
        if re.search(pattern, name):
            return label
    for label, keys in LIBRARY_CLASSES:
        if any(k in name for k in keys):
            return label
    return "elementwise"
