"""Rank process of ``tests/test_torch_port_parallel.py``: one gloo group on
the CPU, every check of a group run in turn, each rank's results pickled to
``<out>/rank<r>.pkl`` for the test process.  Imports only the port.

The inputs come from the test process, in the parent of ``<out>``:
``inputs.npz`` holds the images and labels, and ``mobilenet.npz`` the
weights as flax
variables (``params/<module>/<leaf>``), read by
``checkpoint.load_jax_variables``.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from cnns_slfp_quantization_tpu_torch import models
from cnns_slfp_quantization_tpu_torch.parallel import (
    comm,
    make_mesh,
    multihost,
    spatial,
    steps,
)
from cnns_slfp_quantization_tpu_torch.parallel import mesh as mesh_lib
from cnns_slfp_quantization_tpu_torch.train import loop, optimizers
from cnns_slfp_quantization_tpu_torch.train.checkpoint import (
    load_jax_variables,
)


def _variables(path):
    tree = {}
    with np.load(path) as f:
        for key in f.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = f[key]
    return tree


def _mobilenet(out):
    m = models.create_model("mobilenet", 32)
    return load_jax_variables(m, _variables(os.path.join(
        os.path.dirname(out), "mobilenet.npz")))


def _inputs(out):
    with np.load(os.path.join(os.path.dirname(out), "inputs.npz")) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def step(out, tracked=False):
    """One DSGD step of float32 CIFAR mobilenet on a 2x2 mesh: the loss and
    the parameters gathered whole (or the counters), and the same step on
    one device."""
    inp = _inputs(out)
    m = _mobilenet(out)
    if not tracked:
        one = _mobilenet(out)
        opt1 = optimizers.dsgd(one.parameters(), 1e-3, 8)
        single = loop.make_train_step(one, opt1)(
            loop.TrainState(one, opt1), inp["x"], inp["y"].long())
    opt = optimizers.dsgd(m.parameters(), 1e-3, 8, track_stats=tracked)
    state = loop.TrainState(m, opt)
    mesh = make_mesh(data=2, model=2, device_type="cpu")
    steps.shard_state(state, mesh)
    xs, ys = steps.place_batch(mesh, inp["x"], inp["y"].long())
    metrics = steps.jit_train_step(loop.make_train_step(m, opt))(
        state, xs, ys)
    if tracked:
        full = steps.gathered({"model": dict(m.named_parameters())}, m,
                              mesh)["model"]
        return {"stats": {k: int(v) for k, v in opt.stats.items()},
                "n_params": sum(t.numel() for t in full.values())}
    full = steps.gathered({"model": m.state_dict()}, m, mesh)["model"]
    names = {n for n, _ in m.named_parameters()}
    return {"loss": float(metrics["loss"]),
            "params": {k: v.numpy() for k, v in full.items() if k in names},
            "single_loss": float(single["loss"]),
            "single": {k: v.detach().numpy()
                       for k, v in one.named_parameters()}}


def stats(out):
    return step(out, tracked=True)


def specs(out):
    m = models.create_model("mobilenet", 32)
    sh = mesh_lib.param_shardings(m, make_mesh(data=2, model=2,
                                               device_type="cpu"))
    return {k: sh[k] for k in ("conv2.weight", "bn2.weight", "bn2.bias",
                               "bn2.running_var", "conv1.rkw32")}


def evaluate(out):
    """Top-1 / top-5 counts of a data-parallel eval (mesh 4x1)."""
    inp = _inputs(out)
    m = _mobilenet(out)
    mesh = make_mesh(model=1, device_type="cpu")
    xs, ys = steps.place_batch(mesh, inp["x2"], inp["y2"].long())
    got = steps.jit_eval_step(loop.make_eval_step(m), mesh)(xs, ys)
    return {k: int(got[k]) for k in ("correct1", "correct5", "count")}


def halo(out):
    """spatial_conv2d over an H-sharded input (mesh 4x1), each output
    gathered whole."""
    inp = _inputs(out)
    mesh = make_mesh(model=1, device_type="cpu")
    res = {}
    for key in ("3x3", "5x5"):
        x, w = inp[f"sx{key}"], inp[f"sw{key}"]
        n = mesh_lib.axis_size(mesh, "data")
        i = mesh_lib.axis_rank(mesh, "data")
        h = x.shape[1] // n
        y = spatial.spatial_conv2d(x[:, i * h:(i + 1) * h].contiguous(), w,
                                   mesh)
        res[key] = comm.all_gather_cat(y, 1, mesh.get_group("data")).numpy()
    return res


def fused(out):
    """The fused ResNet-50 engine at 32x32: on a 2x2 mesh over the 4-rank
    group, on a data-only mesh (one row a rank) over the 2-rank one; and
    an unsharded engine at batch 1 on the same rows."""
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    x = _inputs(out)["rx"].numpy()[:2]
    kw = dict(qbit=8, image_size=32, device="cpu", seed=0)
    world = dist.get_world_size()
    mesh = make_mesh(data=2, model=world // 2, device_type="cpu")
    got = InferenceEngine("resnet", batch_size=2, mesh=mesh, **kw).predict(x)
    one = InferenceEngine("resnet", batch_size=1, **kw)
    i = mesh_lib.axis_rank(mesh, "data")
    return {"mesh": (2, world // 2), "got": got, "want": one.predict(x),
            "i": i, "one": one.predict(x[i:i + 1])}


def global_batch(out):
    """Two nodes of two ranks (LOCAL_WORLD_SIZE=2) on a 4x1 mesh: each rank
    keeps its rows of its node's batch; all rows in rank order are the
    nodes' batches in node order."""
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        mesh = make_mesh(model=1, device_type="cpu")
        node = multihost.process_index()
        imgs = torch.arange(16 * 4 * 4 * 3, dtype=torch.float32).reshape(
            16, 4, 4, 3) + 1000 * node
        labels = torch.arange(16) + 100 * node
        gi, gl = multihost.global_batch(mesh, imgs, labels)
        group = mesh.get_group("data")
        return {"nodes": multihost.process_count(), "local": tuple(gi.shape),
                "images": comm.all_gather_cat(gi, 0, group).numpy(),
                "labels": comm.all_gather_cat(gl, 0, group).numpy()}
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]


def _cli(args):
    from cnns_slfp_quantization_tpu_torch.cli import cifar100_train_eval

    return cifar100_train_eval.main(["--device", "cpu", "--synthetic",
                                     "--retrain", "--net", "mobilenet",
                                     *args])


def cli_mesh(out):
    """JAX's CLI trajectory check: the same float32 SGD run on one device
    and on a 2x2 mesh."""
    args = ["--optimizer", "SGD", "--Qbits", "32", "--train_batch_size",
            "8", "--eval_batch_size", "8", "--synthetic_batches", "3",
            "--max_epochs", "1"]
    r = dist.get_rank()
    ref, acc_ref = _cli(args + ["--root_dir", f"{out}/single{r}"])
    sh, acc_sh = _cli(args + ["--mesh_data", "2", "--mesh_model", "2",
                              "--root_dir", f"{out}/mesh"])
    full = steps.gathered({"model": sh.model.state_dict()}, sh.model,
                          sh.mesh)["model"]
    names = [n for n, _ in ref.model.named_parameters()]
    return {"acc_ref": acc_ref, "acc_sh": acc_sh,
            "ref": {n: ref.model.state_dict()[n].numpy() for n in names},
            "sh": {n: full[n].numpy() for n in names}}


def divisible(out):
    try:
        _cli(["--train_batch_size", "6", "--eval_batch_size", "6",
              "--synthetic_batches", "1", "--mesh_data", "4",
              "--root_dir", f"{out}/div"])
    except ValueError as e:
        return str(e)
    return None


def scaling(out):
    from cnns_slfp_quantization_tpu_torch.parallel import scaling_bench

    # fewer timed steps than JAX's 8 and 4: the rows' form is what counts
    scaling_bench.INFER_STEPS, scaling_bench.TRAIN_STEPS = 2, 1
    return scaling_bench.run("mobilenet", [1, 2], per_device_batch=4,
                             image_size=32, qbit=32, mode="both",
                             device="cpu")


def two_nodes(out):
    """JAX's two-process run: two nodes of one rank each (round-robin
    stream), SLFP8 DSGD through the CLI with gathered checkpoints."""
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        state, accs = _cli([
            "--Qbits", "8", "--optimizer", "DSGD", "--mesh_data", "2",
            "--mesh_model", "1", "--train_batch_size", "8",
            "--eval_batch_size", "8", "--synthetic_batches", "5",
            "--max_epochs", "2", "--save_state", "--save_model",
            "--root_dir", f"{out}/shared"])
        return {"step": state.step, "accs": [round(a, 6) for a in accs]}
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]


GROUPS = {4: (step, stats, specs, evaluate, halo, fused, global_batch,
              cli_mesh, divisible),
          2: (fused, scaling, two_nodes)}


def run(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    res = {}
    try:
        for fn in GROUPS[world]:
            t0 = time.perf_counter()
            try:
                res[fn.__name__] = fn(out)
            except Exception:
                res[fn.__name__] = {"error": traceback.format_exc()}
            res.setdefault("seconds", {})[fn.__name__] = \
                time.perf_counter() - t0
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
