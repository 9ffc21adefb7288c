"""Closed-loop serving: one caller hands ``InferenceEngine.forward`` one
batch at a time from a device-resident pool of images and waits for its
logits on the host before it sends the next.

Traffic keys: ``batch``, ``pool_batches`` (the pool of distinct batches,
rotated; larger than the L2), ``warmup_requests``, ``check_requests`` (the
requests of the window whose logits the reference recomputes: the
window's last, and a sample of the others drawn from the seed as the
window runs, by reservoir sampling, so that the caller keeps those logits
alone, as a client that reads its answers and lets them go) and
``trace_calls`` (the requests of the traced stretch).

A request starts when its batch is handed to ``forward`` and ends when its
logits are on the host (``.cpu()``).  ``images_per_s`` is every image of
every request of the window over the window; ``latency_p95_ms`` the 95th
percentile of all its requests.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import checks, inputs


def setup(cell, seed: int, tmpdir, dev) -> dict:
    """The engine, the pool and what the check needs, from the seed."""
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    cfg, tr = cell.config, cell.traffic
    size, batch = cfg["image_size"], tr["batch"]
    p, scales = inputs.model(cell, seed, dev)
    ckpt, scales_path = tmpdir / "weights.pt", tmpdir / "scales.json"
    inputs.save(p, scales, ckpt, scales_path)
    del p
    pool = inputs.images(batch * tr["pool_batches"], size, seed, 3,
                         dev).view(tr["pool_batches"], batch, size, size, 3)
    serve = cfg["serve"]
    policy = serve["policy"]
    if policy and "chain" in policy:
        policy = dict(policy, chain=frozenset(policy["chain"]))
    engine = InferenceEngine(serve["net"], qbit=serve["qbit"],
                             batch_size=batch, image_size=size,
                             checkpoint=str(ckpt), scales=str(scales_path),
                             policy=policy, device=str(dev))
    for i in range(tr["warmup_requests"]):
        engine.forward(pool[i % len(pool)]).cpu()
    return {"engine": engine, "pool": pool, "ckpt": ckpt, "scales": scales,
            "seed": seed, "check_requests": tr["check_requests"]}


def window(state: dict, seconds: float) -> dict:
    engine, pool = state["engine"], state["pool"]
    keep = max(state["check_requests"] - 1, 0)
    rng = np.random.default_rng(inputs.sub_seed(state["seed"], 4))
    lat, enq, kept = [], [], []
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        y = engine.forward(pool[i % len(pool)])
        t1 = time.perf_counter()
        last = (i, y.cpu())
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        enq.append(t1 - t0)
        if i < keep:
            kept.append(last)
        elif keep:
            j = int(rng.integers(i + 1))
            if j < keep:
                kept[j] = last
        i += 1
        if t2 - t_start >= seconds:
            break
    span = t2 - t_start
    # the last request is always checked; the sample holds the others
    state["out"] = [r for r in kept if r[0] != last[0]] + [last]
    state["requests"] = i
    batch = pool.shape[1]
    return {
        "end_to_end": {
            "images_per_s": i * batch / span,
            "latency_p95_ms": float(np.percentile(lat, 95)) * 1e3,
        },
        "spans": {"engine.forward": enq},
    }


def traced_call(state: dict):
    """One request, its host spans named for the trace."""
    from torch.profiler import record_function

    engine, pool = state["engine"], state["pool"]

    def call():
        with record_function("bench.forward"):
            y = engine.forward(pool[0])
        with record_function("bench.to_host"):
            y.cpu()
    return call


def launches(state: dict) -> dict:
    """The hand kernels' launches of one replay, as the engine counted
    them at its capture."""
    graph = state["engine"]._graph
    return dict(graph.launches) if graph is not None else {}


def release(state: dict) -> None:
    state.pop("engine", None)


def check(cell, state: dict, seed: int, dev) -> dict:
    """Recompute the sampled requests with the plain reference; the
    numbers compared, each with its limit."""
    cfg, ref = cell.config, cell.reference
    pool, rows = state["pool"], cfg["check_rows"]
    ka, kw = inputs.scale_arrays(state["scales"])
    p = inputs.load(state["ckpt"], dev)
    gaps = []
    with torch.no_grad():
        for i, y in state["out"]:
            x = pool[i % len(pool)]
            r = torch.cat([
                ref.serve_forward(p, x[j:j + rows], ka, kw,
                                  policy=cfg["serve"]["policy"]).float()
                for j in range(0, x.shape[0], rows)])
            gaps.append(checks.logit_gaps(y.float().to(dev), r))
    limit = cfg["limits"]["serve"]["logit_gap"]
    return checks.verdict(
        {"logit_gap": max(max(g) for g in gaps)}, cfg["limits"]["serve"],
        attempted=state["requests"], failed=sum(max(g) >= limit
                                                for g in gaps))
