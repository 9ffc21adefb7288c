"""Checkpoints of the port and weight bridges into its modules
(counterpart of the JAX ``train/checkpoint.py``).

:func:`save` / :func:`restore` write and read the port's own checkpoints
with ``torch.save`` / ``torch.load``, where JAX writes orbax trees: a dict
of a model's ``state_dict`` (the best-accuracy checkpoint of
``--save_model``), plus the optimizer's and the step (the full train state
of ``--save_state``).

:func:`load_jax_variables` fills a port model from a dict of numpy arrays
shaped like flax's ``{"params": ..., "batch_stats": ...}``, matching by
name: the flax module path (``stage2_u0/res_conv1``) is the port's dotted
submodule name (``stage2_u0.res_conv1``).  Kernels are transposed (HWIO ->
OIHW, [in, out] -> [out, in]); BatchNorm ``scale`` / ``bias`` / ``mean`` /
``var`` go to ``weight`` / ``bias`` / ``running_mean`` / ``running_var``.
Any leaf left over on either side, and any shape that differs, raises.

:func:`import_torch_state_dict` and :func:`load_pth` read a reference
PyTorch ``state_dict`` (a ``.pth`` file) as JAX does: by position, not by
name, within four streams (4-D weights, 2-D weights, 1-D weights with the
biases, BatchNorm statistics), in flax's init order, which each model of
the port lists itself (``flax_order``).  They return flax-shaped numpy
variables for :func:`load_jax_variables`.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch
from torch import nn

from cnns_slfp_quantization_tpu_torch.ops.layers import QuantConv, QuantDense

def save(path, state: dict) -> None:
    """``torch.save`` of ``state`` (tensors moved to the CPU first, so a
    checkpoint written on the card loads anywhere), through a temporary
    file renamed into place."""
    path = pathlib.Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(_to_cpu(state), tmp)
    tmp.replace(path)


def restore(path, map_location="cpu") -> dict:
    """The dict :func:`save` wrote."""
    return torch.load(path, map_location=map_location, weights_only=True)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


# (flax collection, flax leaf) -> torch attribute, per module kind
_CONV = {("params", "kernel"): "weight", ("params", "bias"): "bias"}
_BN = {("params", "scale"): "weight", ("params", "bias"): "bias",
       ("batch_stats", "mean"): "running_mean",
       ("batch_stats", "var"): "running_var"}
_WEIGHTED = (QuantConv, QuantDense, nn.Conv2d, nn.Linear)


def _transpose(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
    if arr.ndim == 2:
        return np.transpose(arr, (1, 0))        # [in, out] -> [out, in]
    return arr


def _flat_leaves(tree, prefix=()):
    """(module path, leaf name, array) of a nested flax collection."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat_leaves(val, prefix + (key,))
        else:
            yield prefix, key, val


def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Copy flax-shaped numpy ``variables`` into ``model`` in place."""
    leaves = {}
    for coll in ("params", "batch_stats"):
        for path, leaf, arr in _flat_leaves(variables.get(coll, {})):
            leaves[(coll, ".".join(path), leaf)] = arr
    targets = {}
    for mod_name, mod in model.named_modules():
        if isinstance(mod, nn.BatchNorm2d):
            table = _BN
        elif isinstance(mod, _WEIGHTED):
            table = _CONV
        else:
            continue
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


def flax_template(model: nn.Module):
    """[(collection, module path, leaf, flax shape)] of ``model``'s
    variables in flax's init order: the modules in the order
    ``model.flax_order()`` lists them, each module's leaves in the order
    flax creates them (kernel then bias; scale, bias, then mean, var)."""
    mods = dict(model.named_modules())
    out = []
    for name in model.flax_order():
        mod = mods[name]
        path = tuple(name.split("."))
        if isinstance(mod, nn.BatchNorm2d):
            c = (mod.num_features,)
            out += [("params", path, "scale", c), ("params", path, "bias", c),
                    ("batch_stats", path, "mean", c),
                    ("batch_stats", path, "var", c)]
            continue
        if not isinstance(mod, _WEIGHTED):
            raise ValueError(f"{name}: no flax variables for "
                             f"{type(mod).__name__}")
        w = tuple(mod.weight.shape)
        kernel = ((w[2], w[3], w[1], w[0]) if len(w) == 4  # OIHW -> HWIO
                  else (w[1], w[0]))                       # [out, in]
        out.append(("params", path, "kernel", kernel))
        if mod.bias is not None:
            out.append(("params", path, "bias", (w[0],)))
    return out


def _torch_entries(state_dict):
    """(name, leaf, array) of a torch state_dict in its order, without the
    BatchNorm batch counters."""
    entries = []
    for name, t in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        arr = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                         else t)
        entries.append((name, name.rsplit(".", 1)[-1], arr))
    return entries


def import_torch_state_dict(state_dict, model: nn.Module, *,
                            strict: bool = True):
    """Map a reference torch state_dict onto flax-shaped numpy variables
    ``{"params": ..., "batch_stats": ...}`` for ``model`` (JAX
    ``import_torch_state_dict``, :85-181).

    Matching is positional within four streams: conv kernels (4-D
    weights), dense kernels (2-D weights), 1-D weights (BatchNorm scales)
    and biases (each matched in order), and BatchNorm running statistics,
    against ``model``'s variables in flax's init order.  ``strict`` also
    raises when torch tensors are left over; a stream that runs out raises
    always.
    """
    entries = _torch_entries(state_dict)
    weights = {nd: [a for _, leaf, a in entries
                    if leaf == "weight" and a.ndim == nd] for nd in (4, 2, 1)}
    streams = {
        "conv": weights[4], "dense": weights[2], "scale": weights[1],
        "bias": [a for _, leaf, a in entries if leaf == "bias"],
        "mean": [a for _, leaf, a in entries if leaf == "running_mean"],
        "var": [a for _, leaf, a in entries if leaf == "running_var"],
    }
    consumed = dict.fromkeys(streams, 0)
    out = {"params": {}, "batch_stats": {}}
    for coll, path, leaf, shape in flax_template(model):
        kind = ("conv" if len(shape) == 4 else "dense") \
            if leaf == "kernel" else leaf
        if consumed[kind] == len(streams[kind]):
            raise ValueError(f"{kind}: flax wants more than the "
                             f"{len(streams[kind])} torch tensors (at "
                             f"{'/'.join(path)}/{leaf})")
        arr = streams[kind][consumed[kind]]
        consumed[kind] += 1
        if kind == "conv":
            arr = np.transpose(arr, (2, 3, 1, 0))       # OIHW -> HWIO
        elif kind == "dense":
            arr = np.transpose(arr, (1, 0))             # [out,in] -> [in,out]
        if arr.shape != shape:
            raise ValueError(
                f"shape mismatch at {'/'.join(path)}/{leaf}: torch "
                f"{arr.shape} vs flax {shape}")
        node = out[coll]
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.asarray(arr, np.float32)
    if strict:
        for kind in ("conv", "dense", "scale", "bias"):
            if consumed[kind] != len(streams[kind]):
                raise ValueError(f"{kind}: consumed {consumed[kind]} of "
                                 f"{len(streams[kind])} torch tensors")
        if (consumed["mean"], consumed["var"]) != (len(streams["mean"]),
                                                   len(streams["var"])):
            raise ValueError(
                f"bn stats: consumed {consumed['mean']}/"
                f"{len(streams['mean'])} means, {consumed['var']}/"
                f"{len(streams['var'])} vars")
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


def load_pth(path, model: nn.Module, *, strict: bool = True):
    """``torch.load`` a reference ``.pth`` file on the CPU and import it for
    ``model``: flax-shaped numpy variables for :func:`load_jax_variables`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return import_torch_state_dict(sd, model, strict=strict)
