"""Data-parallel scaling benchmark: images/s at 1..N ranks (counterpart of
the JAX ``parallel/scaling_bench.py``).

For each rank count n of ``--devices`` the first n ranks of the world form
a ``(n // model_axis, model_axis)`` mesh and measure the global batch's
images/s (``per_device_batch`` rows per data rank): **inference** through
``InferenceEngine(..., mesh=)`` (the fused executor with ``--fused``) and
**QAT training** (forward, backward, DSGD, the gradient all-reduce of
``parallel.steps``).  The ranks beyond n wait.  A rate is the global batch
over the slowest rank's time.  Each row's ``timing`` says how its rate
was timed: ``"graph"``, replays of the engine's own CUDA graph
(``InferenceEngine.graphed``, timed by ``utils/profiling.py::
scan_throughput``), where the mesh has no model axis and the ranks run on
the card; ``"eager"`` otherwise, and always for
training, whose step reduces over the mesh's groups (gloo or NCCL, which a
graph does not capture).  Run it in every rank:

    torchrun --nproc_per_node 4 -m \\
        cnns_slfp_quantization_tpu_torch.parallel.scaling_bench \\
        --net mobilenet --devices 1 2 4 --per_device_batch 32 --mode both

Scaling is a multi-card measurement: ranks that share one card measure
the mechanism and the collectives' cost, not scaling.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from cnns_slfp_quantization_tpu_torch import models
from cnns_slfp_quantization_tpu_torch.parallel import (
    comm,
    make_mesh,
    multihost,
)
from cnns_slfp_quantization_tpu_torch.parallel import steps
from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
from cnns_slfp_quantization_tpu_torch.train import loop, optimizers
from cnns_slfp_quantization_tpu_torch.utils.profiling import (
    scan_throughput,
    scan_train_throughput,
)

INFER_STEPS = 8   # forwards of each timed inference run (JAX's)
TRAIN_STEPS = 4   # train steps of each timed training run (JAX's)


def _infer_ips(net, qbit, mesh, x, fused, device):
    eng = InferenceEngine(net, qbit=qbit, batch_size=x.shape[0],
                          image_size=x.shape[1], fused=fused, device=device,
                          mesh=mesh)
    xs = steps.place_rows(mesh, x)
    # the engine's own dispatch: replays of its graph where it serves
    # through one, eager calls on the CPU and over a model axis
    ips = scan_throughput(eng._dispatch, xs, steps=INFER_STEPS, graph=False)
    return (comm.global_rate(xs.shape[0], ips, x.shape[0], mesh),
            "graph" if eng.graphed else "eager")


def _train_ips(net, qbit, mesh, x, device, optimizer="DSGD"):
    model = models.create_model(net, qbit, image_size=x.shape[1],
                                generator=torch.Generator().manual_seed(0))
    model.to(device)
    opt = optimizers.create_optimizer(optimizer, model.parameters(), 1e-3,
                                      qbit)
    state = steps.shard_state(loop.TrainState(model, opt), mesh)
    y = torch.zeros((x.shape[0],), dtype=torch.int64, device=device)
    xs, ys = steps.place_batch(mesh, x, y)
    step = steps.jit_train_step(loop.make_train_step(model, opt))
    ips = scan_train_throughput(step, state, xs, ys, steps=TRAIN_STEPS,
                                graph=False)
    return comm.global_rate(xs.shape[0], ips, x.shape[0], mesh), "eager"


def run(net: str, device_counts, per_device_batch: int, image_size: int,
        qbit: int = 8, model_axis: int = 1, fused: bool = False,
        mode: str = "infer", device: str = "cuda"):
    """The rows (``mode``, ``devices``, ``images_per_sec``,
    ``scaling_efficiency``, ``timing``) of every count up to the world
    size, the same list on every rank."""
    world = dist.get_world_size()
    results = {}
    for n in device_counts:
        if n > world:
            break
        mesh = make_mesh(data=n // model_axis, model=model_axis,
                         device_type=torch.device(device).type,
                         ranks=range(n))
        row = {}
        if mesh.get_coordinate() is not None:
            batch = per_device_batch * (n // model_axis)
            gen = torch.Generator().manual_seed(0)
            x = torch.randn((batch, image_size, image_size, 3),
                            generator=gen).to(device)
            if mode in ("infer", "both"):
                row["infer"] = _infer_ips(net, qbit, mesh, x, fused, device)
            if mode in ("train", "both"):
                row["train"] = _train_ips(net, qbit, mesh, x, device)
        got = [None] * world
        dist.all_gather_object(got, row)
        results[n] = got[0]
    report = []
    n0 = device_counts[0]
    for kind in ("infer", "train"):
        base = results.get(n0, {}).get(kind)
        if base is None:
            continue
        for n, row in results.items():
            ips, timing = row[kind]
            eff = ips / (base[0] * n / n0) if base[0] else float("nan")
            report.append({"mode": kind, "devices": n,
                           "images_per_sec": round(ips, 1),
                           "scaling_efficiency": round(eff, 3),
                           "timing": timing})
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--net", default="mobilenet")
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--per_device_batch", type=int, default=32)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--Qbits", type=int, default=8)
    p.add_argument("--model_axis", type=int, default=1)
    p.add_argument("--mode", choices=["infer", "train", "both"],
                   default="both")
    p.add_argument("--fused", action="store_true", default=False,
                   help="use the fused serving executor (resnet/mobilenet)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    cfg = p.parse_args(argv)
    if cfg.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not multihost.initialize(device_type=cfg.device):
        # one process: a group of one, in memory
        dist.init_process_group("nccl" if cfg.device == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)
    rows = run(cfg.net, cfg.devices, cfg.per_device_batch, cfg.image_size,
               cfg.Qbits, cfg.model_axis, fused=cfg.fused, mode=cfg.mode,
               device=cfg.device)
    if dist.get_rank() == 0:
        for row in rows:
            print(json.dumps(row))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
