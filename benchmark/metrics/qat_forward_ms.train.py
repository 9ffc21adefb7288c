"""Device milliseconds of ``train.forward`` a step, the median over the
replays the program read (the traced stretch): the QAT step's forward
and loss, between the timing CUDA events the captured step records."""

import statistics


def read(run):
    from cnns_slfp_quantization_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)    # a program with no store
    got = spans("train.forward") if spans is not None else None
    if not got or not got.count:
        return None
    return statistics.median(s.ns for s in got.samples) / 1e6
