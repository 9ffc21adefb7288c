"""The readers of the program's spans (``source: program_span``): None
where the store holds no sample of their span, or where the program keeps
no store at all; else the median (per call) or the total (set-up) of the
spans the test puts in the store, in the metric's unit; the capture's
total less the kernel loads nested in it."""

import json

import pytest

from benchmark import manifest
from benchmark.conftest import ROOT

# metric -> (span, the reading of spans of 1,000, 2,000 and 30,000 ns: the
# median per call, the total for set-up)
READS = {
    "engine_replay_us.serve": ("engine.replay", 2.0),
    "engine_wait_us.serve": ("engine.wait", 2.0),
    "engine_build_s.serve": ("engine.build", 33e-6),
    "graph_capture_s": ("graph.capture", 33e-6),
    "train_replay_us.train": ("train.replay", 2.0),
    "qat_forward_ms.train": ("train.forward", 2e-3),
    "qat_backward_ms.train": ("train.backward", 2e-3),
    "qat_optimizer_ms.train": ("train.optimizer", 2e-3),
}


def test_every_program_span_metric_has_a_case():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert {m["name"] for m in man["per_layer"]
            if m["source"] == "program_span"} == set(READS)


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_reads_the_programs_spans(metric, monkeypatch):
    from cnns_slfp_quantization_tpu_torch.utils import profiling

    span, want = READS[metric]
    read = manifest.reader(ROOT, metric)
    profiling.reset()
    assert read(None) is None
    profiling.STORE.host_span("other", 0, 9_000)
    assert read(None) is None
    for start, ns in ((10, 1_000), (20_000, 30_000), (60_000, 2_000)):
        profiling.STORE.host_span(span, start, start + ns)
    assert read(None) == pytest.approx(want, rel=1e-12)
    monkeypatch.delattr(profiling, "spans")      # a program with no store
    assert read(None) is None
    profiling.reset()


def test_graph_capture_leaves_out_the_kernel_loads_inside_it():
    """A library loaded (and built) in the capture's warm call records
    ``kernels.load`` inside ``graph.capture``: the reader takes it off; a
    load outside any capture is no part of it."""
    from cnns_slfp_quantization_tpu_torch.utils import profiling

    read = manifest.reader(ROOT, "graph_capture_s")
    store = profiling.STORE
    profiling.reset()
    store.host_span("kernels.load", 0, 5_000_000)
    cap = store.open("graph.capture")
    load = store.open("kernels.load")
    store.close(store.open("kernels.build"))
    store.close(load)
    store.close(cap)
    (c,), (inner, _) = (profiling.spans("graph.capture").samples,
                        sorted(profiling.spans("kernels.load").samples,
                               key=lambda s: -s.start_ns))
    assert inner.parent == "graph.capture" and inner.call == c.call
    assert read(None) == pytest.approx((c.ns - inner.ns) / 1e9, rel=1e-12)
    profiling.reset()
