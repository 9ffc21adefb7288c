"""Host microseconds of ``InferenceEngine.forward`` a request, from its
call until it returns (the enqueue: copy in, graph replay, clone), the
mean over the window's requests: the benchmark's own host-clock span."""

import statistics


def read(run):
    spans = run.spans.get("engine.forward")
    return statistics.fmean(spans) * 1e6 if spans else None
