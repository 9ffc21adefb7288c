"""QAT steps back to back: the configuration's training step (model,
optimizer, loss) captured by the port's ``GraphedTrainStep``, fed from a
device-resident pool of distinct batches of images and labels.

Traffic keys: ``batch``, ``pool_batches`` (rotated; each batch's rows
differ from every other's), ``checked_steps`` (the first steps, taken in
set-up through the window's own call, that the reference follows) and
``trace_calls`` (the steps of the traced stretch).

``train_images_per_s`` is every image of every step of the window over
the window, which ends in a synchronise.  The host runs at most one step
ahead of the device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import checks, inputs


def _params(model) -> dict:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.named_parameters()}


def setup(cell, seed: int, tmpdir, dev) -> dict:
    from cnns_slfp_quantization_tpu_torch import calib, models
    from cnns_slfp_quantization_tpu_torch.train import loop, optimizers

    cfg, tr, t = cell.config, cell.traffic, cell.config["train"]
    size, batch, n = cfg["image_size"], tr["batch"], tr["pool_batches"]
    p, scales = inputs.model(cell, seed, dev)
    ckpt, scales_path = tmpdir / "weights.pt", tmpdir / "scales.json"
    inputs.save(p, scales, ckpt, scales_path)
    del p
    xs = inputs.images(batch * n, size, seed, 5, dev).view(
        n, batch, size, size, 3)
    ys = inputs.labels(batch * n, cfg["num_classes"], seed, 6, dev).view(
        n, batch)
    model = models.create_model(
        t["net"], t["qbit"], compute_dtype=getattr(torch, t["compute_dtype"]),
        image_size=size, scales=calib.load_scales_path(scales_path))
    model.load_state_dict(torch.load(ckpt, map_location="cpu",
                                     weights_only=True))
    model.to(dev)
    opt = optimizers.create_optimizer(
        t["optimizer"], model.parameters(), t["lr"], qbit=t["qbit"],
        momentum=t["momentum"], weight_decay=t["weight_decay"])
    state = loop.TrainState(model, opt)
    train_step = loop.make_train_step(model, opt)
    if dev.type == "cuda":
        step = loop.GraphedTrainStep(train_step, state, xs[0], ys[0])
    else:       # the benchmark's own CPU tests: the same step, eager
        def step(x, y):
            return train_step(state, x, y)
        step.launches = {}
    p0 = _params(model)
    losses = []
    for i in range(tr["checked_steps"]):
        losses.append(float(step(xs[i], ys[i])["loss"]))
        if i == 0:
            buf1 = {k: opt.state[v]["momentum"].detach().to("cpu",
                                                            copy=True)
                    for k, v in model.named_parameters()}
    pend = _params(model)
    wd = np.float32(t["weight_decay"])
    prog = {"loss": losses,
            "grad1": {k: buf1[k].double() - wd * p0[k].double()
                      for k in p0},
            "change": {k: pend[k] - p0[k] for k in p0}}
    _sync(dev)
    return {"step": step, "xs": xs, "ys": ys, "ckpt": ckpt, "dev": dev,
            "scales": scales, "prog": prog, "next": tr["checked_steps"]}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def window(state: dict, seconds: float) -> dict:
    step, xs, ys = state["step"], state["xs"], state["ys"]
    batch, cuda = xs.shape[1], state["dev"].type == "cuda"
    done = [torch.cuda.Event(), torch.cuda.Event()] if cuda else None
    spans = []
    i, n = state["next"], 0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        step(xs[i % len(xs)], ys[i % len(ys)])
        spans.append(time.perf_counter() - t0)
        if cuda:
            done[n % 2].record()
            if n:
                done[(n - 1) % 2].synchronize()
        i, n = i + 1, n + 1
        if time.perf_counter() - t_start >= seconds:
            break
    _sync(state["dev"])
    span = time.perf_counter() - t_start
    state["next"], state["window_steps"] = i, n
    return {"end_to_end": {"train_images_per_s": n * batch / span},
            "spans": {"train.step": spans}}


def traced_call(state: dict):
    from torch.profiler import record_function

    step, xs, ys = state["step"], state["xs"], state["ys"]

    def call():
        with record_function("bench.step"):
            step(xs[0], ys[0])
    return call


def launches(state: dict) -> dict:
    return dict(state["step"].launches)


def release(state: dict) -> None:
    state.pop("step", None)


def reference_steps(cell, state: dict, dev) -> dict:
    """The reference's own steps from the same weights, batches and
    scales."""
    from benchmark.reference import train as ref_train

    t, n = cell.config["train"], cell.traffic["checked_steps"]
    ka, kw = inputs.scale_arrays(state["scales"])
    p0 = inputs.load(state["ckpt"], dev)
    r = ref_train.qat_steps(
        cell.reference, p0, [(state["xs"][i], state["ys"][i])
                             for i in range(n)], ka, kw, lr=t["lr"],
        momentum=t["momentum"], weight_decay=t["weight_decay"],
        tol=t["tol"])
    return {"loss": r["loss"],
            "grad1": {k: v.cpu() for k, v in r["grad1"].items()},
            "change": {k: v.cpu() for k, v in r["change"].items()}}


def check(cell, state: dict, seed: int, dev) -> dict:
    ref = reference_steps(cell, state, dev)
    out = checks.verdict(checks.train_numbers(state["prog"], ref),
                         cell.config["limits"]["train"],
                         attempted=state["window_steps"], failed=0)
    out["readings"] = checks.train_readings(state["prog"], ref)
    return out
