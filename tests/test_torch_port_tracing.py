"""The port's own spans and counters (``utils/profiling.py``): nesting,
self time and one id per call; a bounded store; nothing recorded and no
CUDA event made while recording is off; recording under a torch.profiler
session and inside ``recording()``; the engine's, the train step's and the
set-up spans; the kernel build's counter; the exporter.

The ``card`` tests need a CUDA device and skip without one.  On the card
(this file imports no JAX, and the tests' conftest does):

    python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_tracing.py -m card
"""

import gc
import json
import time

import pytest
import torch

from cnns_slfp_quantization_tpu_torch import models
from cnns_slfp_quantization_tpu_torch.kernels import _build
from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
from cnns_slfp_quantization_tpu_torch.train import loop, optimizers
from cnns_slfp_quantization_tpu_torch.utils import profiling

# the suite runs in several processes at once: one intra-op thread each
torch.set_num_threads(1)

ENGINE_SPANS = ("engine.forward", "engine.copy_in", "engine.replay",
                "engine.clone", "engine.eager", "engine.wait")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # an earlier test's engine is a reference cycle holding a CUDA graph;
    # collected inside this test's capture it would invalidate it
    gc.collect()
    return torch.device("cuda", 0)


def _engine(device="cpu", batch=2, **kw):
    """CIFAR MobileNetV1's fused executor, 32x32."""
    return InferenceEngine("mobilenet", qbit=8, batch_size=batch,
                           image_size=32, device=device, **kw)


@pytest.fixture(scope="module")
def engine():
    return _engine()


def _tiny_step(device="cpu"):
    """A two-layer classifier's DSGD train step, its state and a batch."""
    g = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(12, 16),
                                torch.nn.ReLU(), torch.nn.Linear(16, 5))
    model.to(device)
    opt = optimizers.dsgd(model.parameters(), 1e-2, 8)
    x = torch.randn(4, 2, 2, 3, generator=g).to(device)
    y = torch.randint(0, 5, (4,), generator=g).to(device)
    return (loop.make_train_step(model, opt), loop.TrainState(model, opt),
            x, y)


class _FakeEvent:
    """A timing event whose device time and completion the test sets."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_spans_nest_share_one_id_and_give_self_time():
    profiling.reset()
    with profiling.span("outer"):
        with profiling.span("inner"):
            time.sleep(0.002)
        with profiling.span("inner"):
            pass
        time.sleep(0.001)
    with profiling.span("outer"):
        pass
    (o1, o2), (i1, i2) = (profiling.spans("outer").samples,
                          profiling.spans("inner").samples)
    assert o1.parent is None and i1.parent == i2.parent == "outer"
    assert i1.call == i2.call == o1.call != o2.call
    assert o1.start_ns <= i1.start_ns <= i1.end_ns <= i2.start_ns
    assert i2.end_ns <= o1.end_ns
    assert o1.self_ns == o1.ns - i1.ns - i2.ns >= 1_000_000
    assert i1.self_ns == i1.ns >= 2_000_000
    st = profiling.spans("outer")
    assert (st.count, st.total_ns, st.max_ns) == (2, o1.ns + o2.ns, o1.ns)
    assert st.mean_ns == (o1.ns + o2.ns) / 2
    assert profiling.spans("never").count == 0
    assert profiling.spans("never").mean_ns is None


def test_store_stays_bounded():
    """Per name a count, a total and a maximum over every span, and the
    last ``ring`` spans; at most ``ring`` device spans awaiting events."""
    store = profiling.SpanStore(ring=4)
    for _ in range(10):
        store.close(store.open("s"))
    st = store.stats("s")
    assert st.count == 10 and len(st.samples) == 4
    assert st.total_ns >= sum(s.ns for s in st.samples)
    assert st.max_ns >= max(s.ns for s in st.samples)
    for i in range(10):
        store.device(("d",), (_FakeEvent(0, False), _FakeEvent(i, False)))
    assert len(store._pending) == 4
    store.reset()
    assert store.stats("s").count == 0 and not store._pending


def test_device_spans_resolve_by_query_then_on_read():
    """A registered device span is recorded once the device has passed its
    last event (``query``), inside the span open at registration; one
    still running is recorded when the store is read; a registration under
    a key still pending replaces the earlier one."""
    store = profiling.SpanStore()
    frame = store.open("step")
    ev = [_FakeEvent(1.0), _FakeEvent(1.5), _FakeEvent(3.5, done=False)]
    store.device(("a", "b"), ev, key="k")
    store.poll()
    assert store._pending                      # b's end not reached
    store.device(("a", "b"), ev, key="k")      # recorded over: replaced
    assert len(store._pending) == 1
    ev[2].done = True
    store.poll()
    assert not store._pending
    store.close(frame)
    (a,), (b,) = store.stats("a").samples, store.stats("b").samples
    assert (a.ns, b.ns) == (500_000, 2_000_000)
    assert a.device and b.device and a.end_ns == b.start_ns
    assert a.parent == b.parent == "step"
    assert a.call == b.call == store.stats("step").samples[0].call
    store.device(("c",), (_FakeEvent(0.0), _FakeEvent(0.25, done=False)))
    assert store.stats("c").count == 1 and not store._pending


@pytest.mark.parametrize(
    "where", ["cpu", pytest.param("cuda", marks=pytest.mark.card)])
def test_off_path_records_nothing_and_makes_no_event(where, monkeypatch,
                                                     request):
    """With no profiler and no ``recording()``, a served request and a train
    step (graphed on the card) record no span, count nothing and make no
    CUDA event."""
    if where == "cuda":
        device = request.getfixturevalue("card")
        eng = _engine(device, batch=8)
        step, state, x, y = _tiny_step(device)
        step = loop.GraphedTrainStep(step, state, x, y)
    else:
        eng = request.getfixturevalue("engine")
        step, state, x, y = _tiny_step()
        step = (lambda st, f: lambda a, b: f(st, a, b))(state, step)
    xs = torch.randn(eng.input_shape, device=eng.device)
    eng.forward(xs)                          # a graph's capture: set-up
    made = []
    real = torch.cuda.Event

    def counted(*a, **k):
        made.append(k)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", counted)
    profiling.reset()
    assert not profiling.on()
    for _ in range(3):
        eng.forward(xs)
        step(x, y)
    if where == "cuda":
        torch.cuda.synchronize()
    assert made == [] and profiling.counters() == {}
    for name in ENGINE_SPANS + ("train.step",) + loop.PHASES:
        assert profiling.spans(name).count == 0, name


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_recording_turns_on_under_a_profiler_and_inside_recording(engine,
                                                                  how):
    x = torch.randn(engine.input_shape)
    profiling.reset()
    if how == "profiler":
        ctx = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
    else:
        ctx = profiling.recording()
    with ctx:
        assert profiling.on()
        engine.forward(x)
    assert not profiling.on()
    engine.forward(x)
    assert profiling.spans("engine.forward").count == 1
    assert profiling.counters() == {"engine.requests": 1}


def test_cpu_engine_records_forward_and_its_eager_child(engine):
    x = torch.randn(engine.input_shape)
    profiling.reset()
    with profiling.recording():
        y = engine.forward(x)
        engine.forward(x)
    assert y.shape == (2, 100)
    fwd, eager = (profiling.spans("engine.forward").samples,
                  profiling.spans("engine.eager").samples)
    assert len(fwd) == len(eager) == 2
    for f, e in zip(fwd, eager):
        assert e.parent == "engine.forward" and e.call == f.call
        assert f.start_ns <= e.start_ns <= e.end_ns <= f.end_ns
        assert f.self_ns == f.ns - e.ns
    assert fwd[0].call != fwd[1].call
    for name in ("engine.replay", "engine.copy_in", "engine.wait"):
        assert profiling.spans(name).count == 0     # graphed / card only


def test_cpu_train_step_records_three_phases_inside_train_step():
    step, state, x, y = _tiny_step()
    step(state, x, y)
    profiling.reset()
    with profiling.recording():
        step(state, x, y)
    (outer,) = profiling.spans("train.step").samples
    phases = [profiling.spans(n).samples for n in loop.PHASES]
    assert [len(p) for p in phases] == [1, 1, 1]
    last = outer.start_ns
    for (p,) in phases:
        assert p.parent == "train.step" and p.call == outer.call
        assert not p.device and last <= p.start_ns <= p.end_ns
        last = p.end_ns
    assert last <= outer.end_ns
    assert outer.self_ns == outer.ns - sum(p.ns for (p,) in phases)
    assert state.step == 2


def test_engine_build_records_its_set_up_spans(tmp_path):
    """The build always records (no profiler, no ``recording()``): one
    ``engine.build`` whose children are the model's creation, the weights'
    load, the freeze and the executor's layout."""
    ckpt = tmp_path / "weights.pt"
    torch.save(models.create_model(
        "mobilenet", 8, image_size=32,
        generator=torch.Generator().manual_seed(1)).state_dict(), ckpt)
    profiling.reset()
    _engine(checkpoint=str(ckpt))
    (build,) = profiling.spans("engine.build").samples
    kids = ("model.create", "engine.load", "engine.freeze", "engine.prepare")
    got = [profiling.spans(n).samples for n in kids]
    assert [len(s) for s in got] == [1, 1, 1, 1]
    for (s,) in got:
        assert s.parent == "engine.build" and s.call == build.call
    assert build.parent is None
    assert build.self_ns == build.ns - sum(s.ns for (s,) in got)


@pytest.mark.parametrize("missing", [0, 1])
def test_kernel_build_counts_nvcc_only_for_missing_libraries(
        missing, tmp_path, monkeypatch):
    """``kernels.nvcc`` counts the libraries compiled (none where every one
    exists), inside a ``kernels.build`` span."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "true")
    for name in _build.SOURCES[missing:]:
        _build.library_path(name).touch()
    profiling.reset()
    _build.build()
    assert profiling.counters().get("kernels.nvcc", 0) == missing
    assert profiling.spans("kernels.build").count == missing
    assert all(_build.library_path(n).exists() for n in _build.SOURCES)


def test_spans_lie_on_the_profilers_clock():
    """A span around an operator holds the operator's profiler record,
    placed by the session's ``trace_start_ns``."""
    profiling.reset()
    a = torch.randn(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("around"):
            a @ a
    (s,) = profiling.spans("around").samples
    t0 = prof.profiler.kineto_results.trace_start_ns()
    (mm,) = [e for e in prof.events() if e.name == "aten::mm"]
    assert s.start_ns <= t0 + mm.time_range.start * 1e3
    assert t0 + mm.time_range.end * 1e3 <= s.end_ns


def test_trace_merges_the_sessions_spans_into_its_file(tmp_path):
    profiling.reset()
    with profiling.span("before"):
        pass
    a = torch.randn(64, 64)
    with profiling.trace(tmp_path):
        with profiling.span("around"):
            a @ a
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in ours] == ["around"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert ours[0]["ts"] <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= ours[0]["ts"] + ours[0]["dur"]
    names = {e["args"]["name"] for e in events
             if e.get("name") == "thread_name" and e.get("ph") == "M"}
    assert {label for label, _ in profiling.SPAN_ROWS.values()} <= names


# ------------------------------------------------------------------ card
@pytest.mark.card
def test_card_span_holds_the_spin_kernel_on_the_traces_axis(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    profiling.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with profiling.span("spin"):
            torch.cuda._sleep(5_000_000)
            torch.cuda.synchronize()
    (s,) = profiling.spans("spin").samples
    t0 = prof.profiler.kineto_results.trace_start_ns()
    spins = sorted((e for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and profiling.MARKER in e.name),
                   key=lambda e: e.time_range.start)
    k = spins[-1]
    assert s.start_ns <= t0 + k.time_range.start * 1e3, (s, t0, k.time_range)
    assert t0 + k.time_range.end * 1e3 <= s.end_ns, (s, t0, k.time_range)


@pytest.mark.card
def test_card_trace_file_holds_the_spin_kernel_inside_its_span(card,
                                                                 tmp_path):
    profiling.reset()
    with profiling.trace(tmp_path):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with profiling.span("spin"):
            torch.cuda._sleep(5_000_000)
            torch.cuda.synchronize()
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    (ours,) = [e for e in events if e.get("cat") == "program_span"]
    spin = max((e for e in events if e.get("ph") == "X"
                and profiling.MARKER in str(e.get("name"))),
               key=lambda e: e["ts"])
    assert ours["ts"] <= spin["ts"], (ours, spin)
    assert spin["ts"] + spin["dur"] <= ours["ts"] + ours["dur"], (ours, spin)


@pytest.mark.card
def test_card_graphed_engine_resolves_every_wait_after_the_first(card):
    """Every recorded request after a stretch's first closes an
    ``engine.wait``, and its copy in, replay and clone lie inside its
    ``engine.forward``."""
    eng = _engine(card, batch=8)
    x = torch.randn(eng.input_shape, device=card)
    eng.forward(x).cpu()
    n = 6
    profiling.reset()
    with profiling.recording():
        for _ in range(n):
            eng.forward(x).cpu()
    fwd = {s.call: s for s in profiling.spans("engine.forward").samples}
    assert len(fwd) == n and profiling.counters()["engine.requests"] == n
    waits = profiling.spans("engine.wait").samples
    assert len(waits) == n - 1
    calls = sorted(fwd)
    assert [w.call for w in waits] == calls[1:]
    assert all(w.device and w.parent == "engine.forward" and w.ns > 0
               for w in waits)
    parts = {}
    for name in ("engine.copy_in", "engine.replay", "engine.clone"):
        for s in profiling.spans(name).samples:
            assert s.parent == "engine.forward"
            parts[s.call] = parts.get(s.call, 0) + s.ns
    assert all(parts[c] <= fwd[c].ns for c in calls)
    # a new recording stretch measures no wait across the pause before it
    with profiling.recording():
        eng.forward(x).cpu()
    assert profiling.spans("engine.wait").count == n - 1


@pytest.mark.card
def test_card_graphed_qat_phases_sum_to_the_replay(card):
    model = models.create_model(
        "mobilenet", 8, compute_dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0)).to(card)
    opt = optimizers.dsgd(model.parameters(), 1e-3, model.qbit)
    state = loop.TrainState(model, opt)
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(128, 32, 32, 3, device=card, generator=g)
    y = torch.randint(0, 100, (128,), device=card, generator=g)
    step = loop.GraphedTrainStep(loop.make_train_step(model, opt), state,
                                 x, y)
    step(x, y)
    torch.cuda.synchronize()
    n, pairs = 5, []
    profiling.reset()
    with profiling.recording():
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            # the device spins while the host launches the graph, so the
            # pair holds the device's time alone, not the launch's
            torch.cuda._sleep(10_000_000)
            a.record()
            step(x, y)
            b.record()
            b.synchronize()
            pairs.append(a.elapsed_time(b))
    phases = [profiling.spans(p) for p in loop.PHASES]
    assert [p.count for p in phases] == [n] * 3
    assert all(s.device and s.parent == "train.step"
               for p in phases for s in p.samples)
    total_ms = sum(p.mean_ns for p in phases) / 1e6
    replay_ms = sum(pairs) / n
    assert abs(total_ms - replay_ms) <= 0.03 * replay_ms, (
        [p.mean_ns / 1e6 for p in phases], pairs)
    assert profiling.spans("train.replay").count == n
