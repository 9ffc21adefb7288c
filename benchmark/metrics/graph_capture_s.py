"""Seconds of ``graph.capture`` in all, the program's set-up span around
each CUDA graph it captures (``utils.profiling.capture``: the eager warm
call and the capture): the engine's forward or the QAT step.  Less the
``kernels.load`` spans of the same call: a kernel library first loaded in
the warm call (nvcc's build on a checkout's first run) is no part of the
capture's own time."""


def read(run):
    from cnns_slfp_quantization_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)    # a program with no store
    got = spans("graph.capture") if spans is not None else None
    if not got or not got.count:
        return None
    calls = {s.call for s in got.samples}
    loads = sum(s.ns for s in spans("kernels.load").samples
                if s.call in calls)
    return (got.total_ns - loads) / 1e9
