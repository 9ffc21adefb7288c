"""Host microseconds of ``train.replay`` a step, the median over the steps
the program recorded (the traced stretch, so under the profiler's CUPTI
tracing, which lengthens a launch many times over): the launch of the
captured QAT step, ``CUDAGraph.replay()``, a child of ``train.step``."""

import statistics


def read(run):
    from cnns_slfp_quantization_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)    # a program with no store
    got = spans("train.replay") if spans is not None else None
    if not got or not got.count:
        return None
    return statistics.median(s.ns for s in got.samples) / 1e3
