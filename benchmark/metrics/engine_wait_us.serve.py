"""Device microseconds of ``engine.wait`` a request, the median over the
requests the program recorded (the traced stretch): from the engine's
last stream operation of one request to its first of the next, between
CUDA events, so the caller's copy of the logits to the host and its
turn-around lie inside.  The median, because a wait that spans a pause
between two profiler sessions (a trace taken again) is one long
outlier."""

import statistics


def read(run):
    from cnns_slfp_quantization_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)    # a program with no store
    got = spans("engine.wait") if spans is not None else None
    if not got or not got.count:
        return None
    return statistics.median(s.ns for s in got.samples) / 1e3
