"""Host microseconds of ``GraphedTrainStep.__call__`` a step, until it
returns, the mean over the window's steps: the benchmark's own host-clock
span."""

import statistics


def read(run):
    spans = run.spans.get("train.step")
    return statistics.fmean(spans) * 1e6 if spans else None
