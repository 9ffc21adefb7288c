"""Spatial partitioning of convolutions with a halo exchange (counterpart
of the JAX ``parallel/spatial.py``).

Feature maps are sharded over H across the ranks of one mesh axis; each
rank convolves its slab after taking ``k // 2`` boundary rows from each
H-neighbour, zero rows at the outer edges (what JAX's non-circular
``ppermute`` gives, and SAME zero padding).  The exchange is one
all-gather of every rank's edge rows, which runs under NCCL and gloo
alike (gloo has no point-to-point for CUDA tensors); each rank keeps its
neighbours' pieces.

Use when activations are too large for one card (early high-resolution
layers); the 32- and 224-pixel workloads of the zoo do not need it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cnns_slfp_quantization_tpu_torch.parallel import comm
from cnns_slfp_quantization_tpu_torch.parallel import mesh as mesh_lib


def _halo_exchange(x_local: torch.Tensor, halo: int, mesh,
                   axis_name: str) -> torch.Tensor:
    """``x_local`` [N, h, W, C] with ``halo`` rows of the previous and the
    next rank's slab above and below it (zeros at the edges)."""
    n = mesh_lib.axis_size(mesh, axis_name)
    i = mesh_lib.axis_rank(mesh, axis_name)
    edges = torch.stack([x_local[:, :halo], x_local[:, -halo:]])
    every = comm.all_gather_flat(edges, mesh.get_group(axis_name))
    zeros = torch.zeros_like(x_local[:, :halo])
    from_prev = every[i - 1, 1] if i > 0 else zeros
    from_next = every[i + 1, 0] if i < n - 1 else zeros
    return torch.cat([from_prev, x_local, from_next], dim=1)


def spatial_conv2d(x: torch.Tensor, w: torch.Tensor, mesh, *,
                   axis_name: str = "data",
                   feature_group_count: int = 1) -> torch.Tensor:
    """SAME, stride-1 NHWC conv of an H-sharded input.

    ``x``: this rank's slab [N, H / size, W, C] (the rows of its index on
    ``axis_name``); ``w``: [kh, kw, I, O] (JAX's HWIO) with odd ``kh``.
    Returns the rank's slab of the output, in ``x``'s type (float32 sums)."""
    kh, kw = w.shape[0], w.shape[1]
    halo = kh // 2
    x_ext = _halo_exchange(x, halo, mesh, axis_name) if halo else x
    y = F.conv2d(x_ext.to(torch.float32).permute(0, 3, 1, 2),
                 w.to(torch.float32).permute(3, 2, 0, 1),
                 padding=(0, kw // 2), groups=feature_group_count)
    return y.permute(0, 2, 3, 1).to(x.dtype)
