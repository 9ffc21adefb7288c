"""Seconds of ``engine.build``, the program's set-up span around building
the engine: the model from its weights (``model.create``,
``engine.load``), frozen (``engine.freeze``) and laid out for the
executor (``engine.prepare``); the graph's capture is not inside."""


def read(run):
    from cnns_slfp_quantization_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)    # a program with no store
    got = spans("engine.build") if spans is not None else None
    if not got or not got.count:
        return None
    return got.total_ns / 1e9
