"""Rank process of ``tests/test_torch_port_parallel_fused.py``: one gloo
group of two ranks on the CPU, a ``1x2`` mesh, the fused CIFAR
``mobilenet`` and ``shufflenetv2`` engines over it; each rank's logits
pickled to ``<out>/rank<r>.pkl``.  Imports only the port.  ``<out>``
holds ``inputs.npz``: the images and each net's scales."""

from __future__ import annotations

import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist

from cnns_slfp_quantization_tpu_torch import calib
from cnns_slfp_quantization_tpu_torch.parallel import make_mesh
from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

NETS = ("mobilenet", "shufflenetv2")


def run(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    res = {}
    try:
        with np.load(os.path.join(out, "inputs.npz")) as f:
            inp = {k: f[k] for k in f.files}
        mesh = make_mesh(data=1, model=world, device_type="cpu")
        for net in NETS:
            try:
                scales = calib.ScaleSet(inp[f"{net}_ka"], inp[f"{net}_kw"],
                                        15.5)
                eng = InferenceEngine(net, qbit=8, batch_size=4, seed=0,
                                      scales=scales, device="cpu", mesh=mesh)
                res[net] = {"got": eng.predict(inp["x"]),
                            "sharded": eng.executor.mesh is not None}
            except Exception:
                res[net] = {"error": traceback.format_exc()}
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
