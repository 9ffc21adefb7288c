"""Weight bridge from the JAX package's variables to the port's modules.

:func:`load_jax_variables` fills a port model from a dict of numpy arrays
shaped like flax's ``{"params": ..., "batch_stats": ...}``, matching by
name: flax module ``name`` is the port's submodule ``name``.  Kernels are
transposed (HWIO -> OIHW, [in, out] -> [out, in]); BatchNorm ``scale`` /
``bias`` / ``mean`` / ``var`` go to ``weight`` / ``bias`` / ``running_mean``
/ ``running_var``.  Any leaf left over on either side, and any shape that
differs, raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# (flax collection, flax leaf) -> torch attribute, per module kind
_CONV = {("params", "kernel"): "weight", ("params", "bias"): "bias"}
_BN = {("params", "scale"): "weight", ("params", "bias"): "bias",
       ("batch_stats", "mean"): "running_mean",
       ("batch_stats", "var"): "running_var"}


def _transpose(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
    if arr.ndim == 2:
        return np.transpose(arr, (1, 0))        # [in, out] -> [out, in]
    return arr


def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Copy flax-shaped numpy ``variables`` into ``model`` in place."""
    leaves = {}
    for coll in ("params", "batch_stats"):
        for mod_name, mod_leaves in variables.get(coll, {}).items():
            for leaf, arr in mod_leaves.items():
                leaves[(coll, mod_name, leaf)] = arr
    targets = {}
    for mod_name, mod in model.named_children():
        table = _BN if isinstance(mod, nn.BatchNorm2d) else _CONV
        for (coll, leaf), attr in table.items():
            t = getattr(mod, attr, None)
            if t is not None:
                targets[(coll, mod_name, leaf)] = t
    missing = sorted(set(targets) - set(leaves))
    extra = sorted(set(leaves) - set(targets))
    if missing or extra:
        raise ValueError(f"load_jax_variables: missing {missing[:5]} "
                         f"({len(missing)}), left over {extra[:5]} "
                         f"({len(extra)})")
    with torch.no_grad():
        for key, t in targets.items():
            arr = np.asarray(leaves[key])
            if not np.issubdtype(arr.dtype, np.floating) and \
                    arr.dtype.name != "bfloat16":
                raise ValueError(f"{'/'.join(key)}: float weights expected, "
                                 f"got {arr.dtype}")
            arr = _transpose(arr.astype(np.float32))
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch at {'/'.join(key)}: "
                                 f"{arr.shape} vs {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return model
