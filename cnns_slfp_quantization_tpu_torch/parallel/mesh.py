"""Device mesh and sharding policy of the port (counterpart of the JAX
``parallel/mesh.py``), over ``torch.distributed``.

One process per rank; the ranks form a ``("data", "model")`` mesh
(:func:`make_mesh`, a ``DeviceMesh``):

- ``data`` axis: each rank runs its rows of the batch (data parallel);
  gradients are averaged over the data group after the backward
  (:func:`..parallel.comm.reduce_gradients`) and BatchNorm reduces its
  training statistics over it.
- ``model`` axis: tensor parallelism for CNNs, out-channel sharding.  A
  conv weight (OIHW) or dense weight (``[features, in_features]``) keeps
  its rank's rows of dim 0 where the model size divides it, and so do 1-D
  biases and BatchNorm's weight, bias and running statistics (JAX's
  ``scale`` / ``mean`` / ``var``); everything else, the per-layer
  constants included, replicates.

A spec is a tuple in JAX's ``PartitionSpec`` vocabulary: one axis name or
None per dim, ``()`` for replicated.  Where XLA's GSPMD inserts the
collectives in JAX, the port's layers do it themselves once
:func:`shard_module` has put them under the mesh: a sharded layer takes the
full activation, computes its out-channel shard and gathers the channels
(column parallel); a depthwise conv and BatchNorm take their channel shard
of the input.  Off a mesh (the default) every layer runs as before, to the
bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

AXES = ("data", "model")


def make_mesh(data: Optional[int] = None, model: int = 1, *,
              device_type: str = "cuda",
              ranks: Optional[Sequence[int]] = None):
    """A ``("data", "model")`` DeviceMesh over ``ranks`` (default: every
    rank of the initialized process group), ``data`` defaulting to all of
    them over ``model``.  ``data * model`` must equal their count.  Every
    rank of the world calls it, members or not (the groups are created
    collectively); a rank outside ``ranks`` gets a mesh whose
    ``get_coordinate()`` is None."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    n = len(ranks) if ranks is not None else dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device_type='cuda'): no CUDA "
                               "device; pass device_type='cpu'")
        # the caller's device stands: DeviceMesh sets one only where CUDA
        # is not initialized yet
        torch.cuda.current_device()
    if ranks is None:
        return init_device_mesh(device_type, (data, model),
                                mesh_dim_names=AXES)
    return DeviceMesh(device_type, torch.tensor(list(ranks)).reshape(
        data, model), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def replicated(mesh) -> tuple:
    return ()


def batch_sharding(mesh, ndim: int = 4) -> tuple:
    """Shard the leading (batch) dim over 'data'."""
    return ("data",) + (None,) * (ndim - 1)


def _spec_for(name: str, t: torch.Tensor, model_size: int) -> tuple:
    """Tensor-parallel spec of one parameter or buffer, by its dotted name:
    conv and dense weights shard dim 0 (their out-features) over 'model'
    when divisible; 1-D biases and BatchNorm's weight, bias and running
    statistics shard dim 0 when divisible; the rest replicates."""
    leaf = name.rsplit(".", 1)[-1]
    if model_size == 1:
        return ()
    if leaf == "weight" and t.dim() in (2, 4) \
            and t.shape[0] % model_size == 0:
        return ("model",) + (None,) * (t.dim() - 1)
    if t.dim() == 1 and t.shape[0] % model_size == 0 and leaf in (
            "weight", "bias", "running_mean", "running_var"):
        return ("model",)
    return ()


def _named_tensors(model: nn.Module):
    yield from model.named_parameters()
    yield from model.named_buffers()


def param_shardings(tree, mesh) -> dict:
    """Spec of every parameter and buffer of a module (or of every entry of
    a ``{name: tensor}`` dict) under the tensor-parallel policy."""
    items = (_named_tensors(tree) if isinstance(tree, nn.Module)
             else tree.items())
    m = axis_size(mesh, "model")
    return {name: _spec_for(name, t, m) for name, t in items}


def local_shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: each dim named by an
    axis is cut into that axis' size and keeps the rank's piece."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            t = t.chunk(axis_size(mesh, axis), dim)[axis_rank(mesh, axis)]
    return t.contiguous()


def shard_tree(tree: dict, shardings: dict, mesh) -> dict:
    """``{name: tensor}`` -> ``{name: this rank's shard}``."""
    return {k: local_shard(v, shardings.get(k, ()), mesh)
            for k, v in tree.items()}


def sharded_names(model: nn.Module) -> set:
    """The parameters and buffers :func:`shard_module` cut."""
    return {n for n, spec in getattr(model, "_shardings", {}).items()
            if spec}


def shard_module(model: nn.Module, mesh) -> nn.Module:
    """Put ``model`` under ``mesh`` in place: keep this rank's shard of
    every tensor :func:`param_shardings` shards (the Parameter objects stay,
    so an optimizer built on them keeps working), make each layer that
    holds a sharded weight column parallel, let BatchNorm reduce its
    training statistics over the data group and Dropout draw the global
    batch's mask.  Every rank starts from the same full weights."""
    from cnns_slfp_quantization_tpu_torch.ops.layers import (
        BatchNorm2d,
        Dropout,
    )
    from cnns_slfp_quantization_tpu_torch.parallel import comm

    if getattr(model, "_mesh", None) is not None:
        raise ValueError("the module is already under a mesh")
    specs = param_shardings(model, mesh)
    with torch.no_grad():
        for name, t in _named_tensors(model):
            if specs[name]:
                t.data = local_shard(t.data, specs[name], mesh)
    model._mesh, model._shardings = mesh, specs
    data = axis_size(mesh, "data")
    for name, mod in model.named_modules():
        w = getattr(mod, "weight", None)
        if isinstance(w, torch.Tensor) and specs.get(
                f"{name}.weight" if name else "weight"):
            comm.column_parallel(mod, mesh)
        if isinstance(mod, BatchNorm2d) and data > 1:
            mod.data_group = mesh.get_group("data")
        if isinstance(mod, Dropout) and data > 1:
            mod.data_shard = (axis_rank(mesh, "data"), data)
    return model
