"""The collectives of the port's mesh (XLA's GSPMD inserts these in JAX).

- :func:`gather`: all-gather of a channel-sharded activation along its
  channel dim; its backward reduce-scatters (sums) the cotangent over the
  model group.  Off the last layer every rank's cotangent of a replicated
  activation is a partial sum (each rank back-propagates through its own
  out-channels only), and the sum is the gradient.  The loss is the one
  replicated value whose cotangent every model rank holds whole, which
  makes every gradient ``model`` times the true one:
  :func:`reduce_gradients` divides it out.
- :func:`all_reduce_mean`: a mean over a group whose backward is the same
  mean (BatchNorm's statistics over the data group).
- :func:`reduce_gradients`: sums the gradients of the parameters that
  replicate over the model group, then averages every gradient over the
  data group.
- :func:`all_reduce_sum`, :func:`gather_rows`: counters, eval counts, the
  engine's logits.

Every collective goes through ``all_gather_into_tensor``,
``reduce_scatter_tensor`` or ``all_reduce`` with ``group=
mesh.get_group(axis)``.  The backend follows the device (NCCL on the card,
gloo on the CPU) unless the caller joined a group itself; gloo takes CUDA
tensors in these three (PyTorch 2.11), so nothing is staged through the
host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn


def all_gather_flat(t: torch.Tensor, group) -> torch.Tensor:
    """``[world, *t.shape]``: every group rank's ``t``, in rank order.  A
    gather only copies, so it moves bytes, which every backend takes (gloo
    has no bf16 or int16)."""
    n = dist.get_world_size(group)
    src = t.contiguous().reshape(-1).view(torch.uint8)
    out = torch.empty((n * src.numel(),), dtype=torch.uint8, device=t.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view(t.dtype).view(n, *t.shape)


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of ``t`` concatenated along ``dim`` (no
    gradient)."""
    if dist.get_world_size(group) == 1:
        return t
    return torch.cat(all_gather_flat(t, group).unbind(0), dim=dim)


def reduce_scatter_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``t``, this rank's piece along ``dim``."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = torch.stack(t.chunk(n, dim)).contiguous()
    shape = src.shape[1:]
    out = torch.empty(shape.numel(), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, src.reshape(-1), group=group)
    return out.view(shape)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group (a new tensor)."""
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_cat(g.contiguous(), ctx.dim, ctx.group), \
            None, None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim``; backward: reduce-scatter (sum)."""
    return _Gather.apply(x, dim, group)


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group) / dist.get_world_size(
            ctx.group), None


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over the group; the backward averages the cotangents the same
    way (each rank holds its own loss's share)."""
    return _AllReduceMean.apply(x, group)


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's rows of ``x``, in rank order (the global batch)."""
    return all_gather_cat(x, 0, mesh.get_group("data"))


def global_rate(local_images: int, local_ips: float, global_images: int,
                mesh) -> float:
    """Images/s of the global batch from each rank's own rate: the global
    batch over the slowest rank's seconds per batch."""
    sec = torch.tensor([local_images / local_ips], dtype=torch.float64,
                       device=mesh.device_type)
    for axis in ("data", "model"):
        dist.all_reduce(sec, op=dist.ReduceOp.MAX,
                        group=mesh.get_group(axis))
    return global_images / float(sec)


def column_parallel(module: nn.Module, mesh) -> nn.Module:
    """Make a layer whose weight holds its out-channel shard (dim 0) take
    the full activation and return it whole: the layer computes its shard
    of the output channels (dim 1, NCHW or ``[N, features]``) and gathers
    them over the model group.  A grouped conv (depthwise) and BatchNorm
    act per channel, so they first take their channel shard of the input;
    a grouped conv keeps ``groups / model`` groups."""
    from cnns_slfp_quantization_tpu_torch.parallel.mesh import (
        axis_rank,
        axis_size,
    )

    m, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    group = mesh.get_group("model")
    groups = getattr(module, "groups", 1)
    per_channel = isinstance(module, nn.BatchNorm2d) or groups > 1
    if groups > 1:
        if groups % m:
            raise ValueError(f"a conv of {groups} groups cannot shard over "
                             f"a model axis of {m}")
        module.groups = groups // m

    def pre(mod, args):
        x = args[0]
        c = x.shape[1] // m
        return (x.narrow(1, r * c, c),) + tuple(args[1:])

    if per_channel:
        module.register_forward_pre_hook(pre)
    module.register_forward_hook(lambda mod, args, out: gather(out, 1, group))
    return module


def reduce_gradients(model: nn.Module, mesh) -> None:
    """Turn the rank's gradients into the global batch's mean gradient, in
    place: the replicated parameters' gradients summed over the model
    group, then every gradient summed over the data group, then divided by
    ``data * model`` (see :func:`gather` for the model factor).  One flat
    collective per group."""
    from cnns_slfp_quantization_tpu_torch.parallel.mesh import (
        axis_size,
        sharded_names,
    )

    sharded = sharded_names(model)
    named = [(n, p) for n, p in model.named_parameters()
             if p.grad is not None]
    if not named:
        return
    d, m = axis_size(mesh, "data"), axis_size(mesh, "model")
    if m > 1:
        rep = [p.grad for n, p in named if n not in sharded]
        if rep:
            _flat_all_reduce(rep, mesh.get_group("model"))
    grads = [p.grad for _, p in named]
    _flat_all_reduce(grads, mesh.get_group("data"), scale=d * m)


def _flat_all_reduce(grads, group, scale: int = 1) -> None:
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if scale != 1:
        flat.div_(scale)
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
        flat.split([g.numel() for g in grads]), grads)])
