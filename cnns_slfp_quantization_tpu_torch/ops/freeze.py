"""Inference-time weight freezing (counterpart of the JAX ``ops/freeze.py``).

The QAT forward re-quantizes every weight on every call; serving does it
once.  :func:`prequantize` stores ``Q(w/Kw)`` into each quantized layer, as
float32 or bf16 values (SFP<3,3> at qbit 7, SLFP<3,4> at qbit 8), and
:func:`pack` stores it as uint8 SLFP<3,4> codes (1 byte per weight; qbit 8
only, as in JAX).  Both act on the module in place and mark its layers
``frozen_weights``; the forward is unchanged bit for bit.  No capture run is
needed: each layer knows its own Kw.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cnns_slfp_quantization_tpu_torch.ops import sfp
from cnns_slfp_quantization_tpu_torch.ops.layers import QuantConv, QuantDense


def quant_layers(model: nn.Module):
    """(name, layer) of every quantized conv / dense layer, in order."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, (QuantConv, QuantDense))]


def _replace(model, fn):
    with torch.no_grad():
        for _, layer in quant_layers(model):
            if layer.frozen_weights:
                raise ValueError("weights are frozen already")
            wq = layer.weight_frozen()
            layer.weight = nn.Parameter(fn(wq), requires_grad=False)
            layer.frozen_weights = True
    return model


def prequantize(model: nn.Module, dtype: Optional[torch.dtype] = None):
    """Store ``Q(w/Kw)`` in every quant layer (dtype: float32 or bf16)."""
    return _replace(model, lambda wq: wq.to(dtype or torch.float32))


def pack(model: nn.Module):
    """Store every quant layer's weight as uint8 SLFP<3,4> codes."""
    for _, layer in quant_layers(model):
        if layer.qbit != 8:
            raise ValueError("pack needs SLFP8 layers (qbit=8)")
    return _replace(model, sfp.pack_slfp34)
