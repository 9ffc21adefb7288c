"""Sharded train / eval steps over a ``("data", "model")`` mesh
(counterpart of the JAX ``parallel/steps.py``).

Usage: build the state as on one device, :func:`shard_state` it onto the
mesh (every rank from the same full weights), then run the steps that
:func:`jit_train_step` / :func:`jit_eval_step` wrap around the ordinary
``train.loop.make_train_step`` / ``make_eval_step`` steps, on the batch
rows :func:`place_batch` gives the rank.  The wrappers add what GSPMD adds
in JAX: the gradient reduction before the optimizer step, and the global
batch's loss, accuracy and eval counts.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cnns_slfp_quantization_tpu_torch.parallel import comm
from cnns_slfp_quantization_tpu_torch.parallel import mesh as mesh_lib
from cnns_slfp_quantization_tpu_torch.train.loop import TrainState


def state_shardings(state: TrainState, mesh) -> dict:
    """Specs of the model's tensors and of the optimizer's per-parameter
    state (each follows its parameter); the step count replicates."""
    specs = mesh_lib.param_shardings(state.model, mesh)
    params = [specs[n] for n, _ in state.model.named_parameters()]
    return {"model": specs, "optimizer": params, "step": ()}


def shard_state(state: TrainState, mesh) -> TrainState:
    """Put the state's model under ``mesh`` (``mesh.shard_module``) and cut
    the optimizer's momentum buffers as their parameters; QSGD's counters
    learn which parameters are sharded.  In place; returns ``state``."""
    params = list(state.model.parameters())
    index = {id(p): i for i, p in enumerate(params)}
    opt_specs = state_shardings(state, mesh)["optimizer"]
    mesh_lib.shard_module(state.model, mesh)
    opt = state.optimizer
    for p, st in opt.state.items():
        spec = opt_specs[index[id(p)]]
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and v.dim() and spec:
                st[k] = mesh_lib.local_shard(v, spec, mesh)
    if mesh_lib.axis_size(mesh, "model") > 1 and hasattr(opt, "sharded"):
        opt.model_group = mesh.get_group("model")
        opt.sharded = frozenset(
            i for i, p in enumerate(opt.param_groups[0]["params"])
            if opt_specs[index[id(p)]])
    state.mesh = mesh
    return state


def gathered(sd: dict, model, mesh) -> dict:
    """A state dict of a sharded ``model`` (``"model"``, and optionally
    ``"optimizer"`` over its parameters in order) with every shard gathered
    whole over the model group: what a single-device run saves."""
    specs = model._shardings
    group = mesh.get_group("model")

    def full(t, spec):
        if spec and isinstance(t, torch.Tensor):
            return comm.all_gather_cat(t, 0, group)
        return t

    out = dict(sd, model={k: full(v, specs.get(k, ()))
                          for k, v in sd["model"].items()})
    if "optimizer" in sd:
        pspecs = [specs[n] for n, _ in model.named_parameters()]
        opt = dict(sd["optimizer"])
        opt["state"] = {i: {k: full(v, pspecs[i]) for k, v in st.items()}
                        for i, st in opt["state"].items()}
        out["optimizer"] = opt
    return out


def place_rows(mesh, t):
    """This data rank's rows of a global batch tensor."""
    d = mesh_lib.axis_size(mesh, "data")
    if t.shape[0] % d:
        raise ValueError(
            f"batch size {t.shape[0]} not divisible by the "
            f"data-parallel mesh axis ({d})")
    b = t.shape[0] // d
    r = mesh_lib.axis_rank(mesh, "data")
    return t[r * b:(r + 1) * b]


def place_batch(mesh, images, labels):
    """This data rank's rows of a global batch (images and labels)."""
    return place_rows(mesh, images), place_rows(mesh, labels)


def jit_train_step(train_step):
    """Wrap a ``loop.make_train_step`` step for a state :func:`shard_state`
    put under a mesh: the gradients are reduced over the mesh
    (``comm.reduce_gradients``) just before the optimizer steps, and the
    metrics are the global batch's."""

    def step(state: TrainState, images, labels, generator=None):
        mesh = state.mesh
        handle = state.optimizer.register_step_pre_hook(
            lambda *_: comm.reduce_gradients(state.model, mesh))
        try:
            metrics = train_step(state, images, labels, generator)
        finally:
            handle.remove()
        group = mesh.get_group("data")
        both = comm.all_reduce_sum(torch.stack(
            [metrics["loss"], metrics["accuracy"]]), group)
        both = both / dist.get_world_size(group)
        return {"loss": both[0], "accuracy": both[1]}

    return step


def jit_eval_step(eval_step, mesh):
    """Wrap a ``loop.make_eval_step`` step: the correct counts and the
    image count summed over the data group (the global batch's)."""

    def step(images, labels):
        m = eval_step(images, labels)
        counts = torch.stack([m["correct1"], m["correct5"],
                              torch.as_tensor(m["count"],
                                              device=images.device)])
        c1, c5, n = comm.all_reduce_sum(counts, mesh.get_group(
            "data")).tolist()
        return {"correct1": c1, "correct5": c5, "count": n}

    return step
