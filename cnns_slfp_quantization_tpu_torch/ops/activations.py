"""Activation library (counterpart of the JAX ``ops/activations.py``;
reference utils/activation_func.py).

- ``stl``: "Soft-Tanh-Log" ``x -> x if |x| <= 1 else sign(x)*(ln|x| + 1)``
  with the reference's backward (activation_func.py:14-17), which is a
  function of the incoming cotangent only, ``where(|g| <= 1, 1, 1/|g|) *
  g``, and not of ``x``: kept as it is, for training parity.
- ``swish`` / ``sigmoid`` (activation_func.py:30-36).
- ``gelu``: the exact (erf) form, ``torch.nn.GELU()``'s default, computed
  as JAX does.
- ``relu`` yields +0.0 for -0.0, as JAX's ``jax.nn.relu``.
"""

from __future__ import annotations

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch.ops.layers import relu


class _STL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ax = torch.abs(x)
        return torch.where(ax <= 1.0, x, torch.sign(x) * (torch.log(ax) + 1.0))

    @staticmethod
    def backward(ctx, g):
        ag = torch.abs(g)
        return torch.where(ag <= 1.0, 1.0, 1.0 / ag) * g


def stl(x: torch.Tensor) -> torch.Tensor:
    return _STL.apply(x)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # the erfc form, as jax.nn.gelu: 1 + erf(x/sqrt 2) cancels for x << 0
    return x * torch.special.erfc(-x * _SQRT_HALF) / 2


_SQRT_HALF = float(np.sqrt(0.5))


ACTIVATIONS = {
    "relu": relu,
    "swish": swish,
    "gelu": gelu,
    "sigmoid": sigmoid,
    "stl": stl,
    "identity": lambda x: x,
}


def get(name: str):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None
