"""The port's engine dispatch and profiling utilities on the CPU: the
``StepTimer`` summary against JAX's, ``trace`` writing a trace file,
``InferenceEngine.throughput()`` timing JAX's scan (inputs perturbed per
forward), ``forward`` results that no later call overwrites, and the
engine refusing a missing card and a capture it cannot make.  The CUDA
graph itself runs on the card only (``chip_smoke.py``)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnns_slfp_quantization_tpu.utils import profiling as jax_profiling
from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
from cnns_slfp_quantization_tpu_torch.utils import profiling

# the suite runs in several processes at once: one intra-op thread each
torch.set_num_threads(1)


def _engine(**kw):
    """CIFAR MobileNetV1's fused executor at batch 2, 32x32, on the CPU."""
    return InferenceEngine("mobilenet", qbit=8, batch_size=2, image_size=32,
                           device="cpu", **kw)


@pytest.mark.parametrize("script", [
    # (items per stop) of each step; the clock advances by these seconds
    [(1, 0.5), (4, 2.0), (2, 0.25)],
    [(8, 0.125)],
    [(1, 1.0), (1, 3.0), (3, 0.75), (16, 4.0), (0, 0.5)],
])
def test_step_timer_summary_matches_jax(monkeypatch, script):
    """The same scripted ``time.perf_counter`` readings through the port's
    ``StepTimer`` and JAX's give the same summary, key for key."""
    readings = []
    t = 100.0
    for _, dt in script:
        readings += [t, t + dt]
        t += dt + 1.0

    def run(module):
        it = iter(readings)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))
        timer = module.StepTimer()
        assert timer.summary() == {}
        for items, _ in script:
            timer.start()
            timer.stop(items)
        return timer.summary()

    got, want = run(profiling), run(jax_profiling)
    assert set(got) == {"mean_s", "p50_s", "p95_s", "best_s",
                        "items_per_sec"}
    assert got == want


def test_trace_writes_a_trace_file_on_the_cpu(tmp_path):
    """``trace(log_dir)`` writes a Chrome / TensorBoard trace of the block
    under ``log_dir``, holding the block's operators."""
    log_dir = tmp_path / "trace"
    with profiling.trace(log_dir) as where:
        assert where == log_dir
        x = torch.randn(8, 8)
        (x @ x).relu().sum()
    files = list(log_dir.rglob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)


@pytest.mark.parametrize("i", [0, 1, 2, 15, 1185, 6329, 13053, 18987])
def test_perturbed_input_is_jax_scans(i):
    """The scans' per-step input is JAX's jitted ``x0 * (1 + i * 1e-6)``
    bit for bit (the factor ``1 + float64(i * 1e-6)`` rounded to float32
    differs at i = 6329, 13053, 18987; two float32 roundings at 1185)."""
    x0 = np.random.default_rng(i).standard_normal((3, 5)).astype(np.float32)
    want = jax.jit(lambda x, k: (x.astype(jnp.float32) * (
        1.0 + k.astype(jnp.float32) * 1e-6)).astype(x.dtype))(
        x0, jnp.int32(i))
    got = profiling._perturbed(torch.from_numpy(x0), i)
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(want).view(np.uint32))


def test_cpu_engine_throughput_runs_the_scan(monkeypatch):
    """A CPU engine's ``throughput(iters)`` forwards ``iters`` inputs
    ``x0 * (1 + i * 1e-6)``, i = 0 .. iters-1, on zeros of its fixed input
    (JAX's ``scan_throughput``), in one untimed and three timed runs, all
    under inference mode, and returns images per second."""
    eng = _engine()
    assert not eng.graphed and eng.input_shape == (2, 32, 32, 3)
    steps, seen = [], []
    perturbed = profiling._perturbed

    def spy(x0, i):
        steps.append(i)
        return perturbed(x0, i)

    monkeypatch.setattr(profiling, "_perturbed", spy)
    eager = eng._eager

    def forward(x):
        seen.append((x.clone(), torch.is_inference_mode_enabled()))
        return eager(x)

    monkeypatch.setattr(eng, "_eager", forward)
    ips = eng.throughput(iters=3)
    assert ips > 0
    assert steps == [0, 1, 2]
    assert len(seen) == 4 * 3 and all(mode for _, mode in seen)
    x0 = torch.zeros(eng.input_shape)
    for k, (x, _) in enumerate(seen):
        assert x.shape == eng.input_shape and x.dtype == torch.float32
        assert torch.equal(x, perturbed(x0, k % 3))


def test_cpu_engine_forward_results_are_its_own():
    """Two ``forward`` results of an engine share no storage, and the
    second call leaves the first result as it was."""
    eng = _engine()
    g = torch.Generator().manual_seed(0)
    x1, x2 = (torch.randn(eng.input_shape, generator=g) for _ in range(2))
    y1 = eng.forward(x1)
    kept = y1.clone()
    y2 = eng.forward(x2)
    assert y1.untyped_storage().data_ptr() != y2.untyped_storage().data_ptr()
    assert torch.equal(y1, kept) and not torch.equal(y1, y2)


def test_engine_without_a_card_raises(monkeypatch):
    """The engine runs on the card unless the caller asks for the CPU:
    without a card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        InferenceEngine("mobilenet", qbit=8, batch_size=2, image_size=32)


def test_graph_dispatch_raises_instead_of_falling_back():
    """The graph dispatch takes the engine's fixed input only, and a
    capture it cannot make raises: nothing drops to the eager forward
    (here the capture is refused for CPU tensors)."""
    eng = _engine()
    eng.graphed = True
    with pytest.raises(ValueError, match="fixed batch"):
        eng.forward(torch.zeros(3, 32, 32, 3))
    with pytest.raises(ValueError, match="CUDA graph"):
        eng.forward(torch.zeros(eng.input_shape))
    assert eng._graph is None


def test_predict_pads_to_the_fixed_batch(monkeypatch):
    """``predict`` hands every chunk to the dispatch at the fixed batch, a
    short last chunk padded with zeros, and returns the rows asked for."""
    eng = _engine()
    shapes = []
    dispatch = eng._dispatch

    def spy(x):
        shapes.append(tuple(x.shape))
        return dispatch(x)

    monkeypatch.setattr(eng, "_dispatch", spy)
    images = np.random.default_rng(0).standard_normal(
        (5, 32, 32, 3)).astype(np.float32)
    out = eng.predict(images)
    assert out.shape == (5, 100) and out.dtype == np.float32
    assert shapes == [eng.input_shape] * 3
    assert np.array_equal(out[:2], eng.predict(images[:2]))

