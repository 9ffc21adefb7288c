"""Host microseconds of ``engine.replay`` a request, the median over the
requests the program recorded (the traced stretch, so under the
profiler's CUPTI tracing, which lengthens a launch many times over): the
launch of the engine's captured forward, ``CUDAGraph.replay()``, a child
of ``engine.forward``."""

import statistics


def read(run):
    from cnns_slfp_quantization_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)    # a program with no store
    got = spans("engine.replay") if spans is not None else None
    if not got or not got.count:
        return None
    return statistics.median(s.ns for s in got.samples) / 1e3
