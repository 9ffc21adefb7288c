"""InceptionV3, float32 only (counterpart of the JAX
``models/inception_v3.py``; reference nets_imgnet/inception_v3.py).

The reference ships it unquantized: padding-1 stem convs with no stem
pooling, ``BasicConv2d`` = conv (no bias) + BN (eps 1e-5) + ReLU, mixed
blocks A-E, the mean over H and W, dropout (0.5 in training, the identity
at inference) and
a dense classifier.  Submodules carry the flax names (``conv_1a.conv``,
``conv_1a.bn``, ``mixed_5b_b1``, ..., ``linear``) in flax's call order.
Inputs are NHWC float32, as in JAX; the layers run NCHW.  The smallest
input it takes is 9x9.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cnns_slfp_quantization_tpu_torch.ops.layers import (
    Dropout,
    BatchNorm2d,
    he_normal_,
    relu,
)


# each mixed block's convs, in flax's call order (JAX inception_v3.py:51-107)
BLOCK_CONVS = {
    "a": ["b1", "b5_1", "b5_2", "b3_1", "b3_2", "b3_3", "bp"],
    "b": ["b3", "bs_1", "bs_2", "bs_3"],
    "c": ["b1", "b7_1", "b7_2", "b7_3", "bs_1", "bs_2", "bs_3", "bs_4",
          "bs_5", "bp"],
    "d": ["b3_1", "b3_2", "b7_1", "b7_2", "b7_3", "b7_4"],
    "e": ["b1", "b3_1", "b3_2a", "b3_2b", "bs_1", "bs_2", "bs_3a", "bs_3b",
          "bp"],
}


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=1, padding=1) with torch's count_include_pad."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, features: int, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, _pair(kernel_size),
                              stride=_pair(stride), padding=_pair(padding),
                              bias=False)
        self.bn = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu(self.bn(self.conv(x)))


class InceptionV3(nn.Module):
    def __init__(self, num_classes: int = 1000,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.plan = []

        def add(name, cin, features, k, s=1, p=0):
            self.plan.append(("conv", name))
            return self._conv(name, cin, features, k, s, p)

        def block(kind, name, cin, *args):
            out = getattr(self, f"_inception_{kind}")(name, cin, *args)
            self.plan.append((kind, name))
            return out

        c = add("conv_1a", 3, 32, 3, p=1)
        c = add("conv_2a", c, 32, 3, p=1)
        c = add("conv_2b", c, 64, 3, p=1)
        c = add("conv_3b", c, 80, 1)
        c = add("conv_4a", c, 192, 3)
        c = block("a", "mixed_5b", c, 32)
        c = block("a", "mixed_5c", c, 64)
        c = block("a", "mixed_5d", c, 64)
        c = block("b", "mixed_6a", c)
        c = block("c", "mixed_6b", c, 128)
        c = block("c", "mixed_6c", c, 160)
        c = block("c", "mixed_6d", c, 160)
        c = block("c", "mixed_6e", c, 192)
        c = block("d", "mixed_7a", c)
        c = block("e", "mixed_7b", c)
        c = block("e", "mixed_7c", c)
        self.linear = nn.Linear(c, num_classes)
        self.drop = Dropout(0.5)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: lecun_normal kernels, zero biases, unit BatchNorm."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    he_normal_(m.weight, m.weight[0].numel(), generator,
                               scale=1.0)
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()
            he_normal_(self.linear.weight, self.linear.in_features,
                       generator, scale=1.0)
            self.linear.bias.zero_()

    def flax_order(self):
        """Modules holding variables, in flax's init order: the reference
        ``.pth`` import's positional match follows it."""
        convs = []
        for kind, name in self.plan:
            convs += ([name] if kind == "conv" else
                      [f"{name}_{c}" for c in BLOCK_CONVS[kind]])
        return [f"{c}.{p}" for c in convs for p in ("conv", "bn")] + [
            "linear"]

    def _conv(self, name, cin, features, k, s=1, p=0):
        setattr(self, name, BasicConv2d(cin, features, k, s, p))
        return features

    # each block registers its convs in flax's call order and returns its
    # output width
    def _inception_a(self, n, cin, pool_features):
        self._conv(f"{n}_b1", cin, 64, 1)
        self._conv(f"{n}_b5_1", cin, 48, 1)
        self._conv(f"{n}_b5_2", 48, 64, 5, p=2)
        self._conv(f"{n}_b3_1", cin, 64, 1)
        self._conv(f"{n}_b3_2", 64, 96, 3, p=1)
        self._conv(f"{n}_b3_3", 96, 96, 3, p=1)
        self._conv(f"{n}_bp", cin, pool_features, 3, p=1)
        return 64 + 64 + 96 + pool_features

    def _inception_b(self, n, cin):
        self._conv(f"{n}_b3", cin, 384, 3, s=2)
        self._conv(f"{n}_bs_1", cin, 64, 1)
        self._conv(f"{n}_bs_2", 64, 96, 3, p=1)
        self._conv(f"{n}_bs_3", 96, 96, 3, s=2)
        return 384 + 96 + cin

    def _inception_c(self, n, cin, c7):
        self._conv(f"{n}_b1", cin, 192, 1)
        self._conv(f"{n}_b7_1", cin, c7, 1)
        self._conv(f"{n}_b7_2", c7, c7, (7, 1), p=(3, 0))
        self._conv(f"{n}_b7_3", c7, 192, (1, 7), p=(0, 3))
        self._conv(f"{n}_bs_1", cin, c7, 1)
        self._conv(f"{n}_bs_2", c7, c7, (7, 1), p=(3, 0))
        self._conv(f"{n}_bs_3", c7, c7, (1, 7), p=(0, 3))
        self._conv(f"{n}_bs_4", c7, c7, (7, 1), p=(3, 0))
        self._conv(f"{n}_bs_5", c7, 192, (1, 7), p=(0, 3))
        self._conv(f"{n}_bp", cin, 192, 1)
        return 4 * 192

    def _inception_d(self, n, cin):
        self._conv(f"{n}_b3_1", cin, 192, 1)
        self._conv(f"{n}_b3_2", 192, 320, 3, s=2)
        self._conv(f"{n}_b7_1", cin, 192, 1)
        self._conv(f"{n}_b7_2", 192, 192, (1, 7), p=(0, 3))
        self._conv(f"{n}_b7_3", 192, 192, (7, 1), p=(3, 0))
        self._conv(f"{n}_b7_4", 192, 192, 3, s=2)
        return 320 + 192 + cin

    def _inception_e(self, n, cin):
        self._conv(f"{n}_b1", cin, 320, 1)
        self._conv(f"{n}_b3_1", cin, 384, 1)
        self._conv(f"{n}_b3_2a", 384, 384, (1, 3), p=(0, 1))
        self._conv(f"{n}_b3_2b", 384, 384, (3, 1), p=(1, 0))
        self._conv(f"{n}_bs_1", cin, 448, 1)
        self._conv(f"{n}_bs_2", 448, 384, 3, p=1)
        self._conv(f"{n}_bs_3a", 384, 384, (1, 3), p=(0, 1))
        self._conv(f"{n}_bs_3b", 384, 384, (3, 1), p=(1, 0))
        self._conv(f"{n}_bp", cin, 192, 1)
        return 320 + 768 + 768 + 192

    def _run_a(self, n, x):
        g = lambda k, v: getattr(self, f"{n}_{k}")(v)  # noqa: E731
        b1 = g("b1", x)
        b5 = g("b5_2", g("b5_1", x))
        b3 = g("b3_3", g("b3_2", g("b3_1", x)))
        bp = g("bp", _avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], dim=1)

    def _run_b(self, n, x):
        g = lambda k, v: getattr(self, f"{n}_{k}")(v)  # noqa: E731
        b3 = g("b3", x)
        bs = g("bs_3", g("bs_2", g("bs_1", x)))
        return torch.cat([b3, bs, F.max_pool2d(x, 3, 2)], dim=1)

    def _run_c(self, n, x):
        g = lambda k, v: getattr(self, f"{n}_{k}")(v)  # noqa: E731
        b1 = g("b1", x)
        b7 = g("b7_3", g("b7_2", g("b7_1", x)))
        bs = x
        for k in ("bs_1", "bs_2", "bs_3", "bs_4", "bs_5"):
            bs = g(k, bs)
        bp = g("bp", _avg_pool_same(x))
        return torch.cat([b1, b7, bs, bp], dim=1)

    def _run_d(self, n, x):
        g = lambda k, v: getattr(self, f"{n}_{k}")(v)  # noqa: E731
        b3 = g("b3_2", g("b3_1", x))
        b7 = x
        for k in ("b7_1", "b7_2", "b7_3", "b7_4"):
            b7 = g(k, b7)
        return torch.cat([b3, b7, F.avg_pool2d(x, 3, 2)], dim=1)

    def _run_e(self, n, x):
        g = lambda k, v: getattr(self, f"{n}_{k}")(v)  # noqa: E731
        b1 = g("b1", x)
        b3 = g("b3_1", x)
        b3 = torch.cat([g("b3_2a", b3), g("b3_2b", b3)], dim=1)
        bs = g("bs_2", g("bs_1", x))
        bs = torch.cat([g("bs_3a", bs), g("bs_3b", bs)], dim=1)
        bp = g("bp", _avg_pool_same(x))
        return torch.cat([b1, b3, bs, bp], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for kind, name in self.plan:
            if kind == "conv":
                x = getattr(self, name)(x)
            else:
                x = getattr(self, f"_run_{kind}")(name, x)
        return self.linear(self.drop(torch.mean(x, dim=(2, 3))))
