"""Plain-PyTorch building blocks of the benchmark's reference models.

The configurations state the SLFP8 numerics of the reference repository
(``utils/conv2d_func.py``) as the port serves and trains them:

    input_q  = Q_act(x / Ka)          held as ``operand`` values (bf16)
    weight_q = Q_weight(w / Kw)       held as ``operand`` values (bf16)
    y        = (conv(input_q, weight_q) [+ b / (Ka Kw)]) * Ka Kw

with float32 sums.  Each configuration file names where a value is held
in bfloat16 between layers; BatchNorm's statistics and arithmetic are
float32.  Nothing here imports the port.

:class:`Numerics` names the operand type, ``torch.bfloat16`` as the
configurations state it (``torch.float8_e4m3fn`` for the serving
control), and how a layer's sums are taken:

- ``"exact"``: in float64, rounded to float32 once.  The inputs
  (``benchmark/inputs.py``) put every product of a forward on a grid that
  float32 holds exactly, so the exact sum is what any summation order
  gives, and the served comparison does not depend on the order a kernel
  or a library picks.
- ``"float32"``: cuDNN and float32 matmuls in full float32 (no TF32), as
  the training configuration states; its backward too.
- ``"tf32"``: the same in TF32, the training control.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import slfp

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class Numerics:
    operand: torch.dtype = torch.bfloat16
    sums: str = "exact"          # "exact", "float32" or "tf32"


def recip(k: float) -> float:
    """float32(1 / float64(float32(k)))."""
    return float(np.float32(1.0 / np.float64(np.float32(k))))


def kaw(ka: float, kw: float) -> float:
    """float32(ka) * float32(kw), rounded to float32."""
    return float(np.float32(ka) * np.float32(kw))


def quant(x: torch.Tensor, ka: float, num: Numerics) -> torch.Tensor:
    """Q_act(x / Ka) held in the operand type, as float32."""
    q = slfp.quantize_act(x.to(torch.float32) * recip(ka))
    return q.to(num.operand).to(torch.float32)


def quant_weight(w: torch.Tensor, kw: float, num: Numerics) -> torch.Tensor:
    rkw = float(np.float32(1) / np.float32(kw))
    return slfp.quantize_weight(w * rkw).to(num.operand).to(torch.float32)


def conv(xq, wq, num: Numerics, *, stride=1, pad=0, groups=1):
    """The float32 sums of a convolution of operand values, by
    ``num.sums``."""
    if num.sums == "exact":
        return F.conv2d(xq.double(), wq.double(), stride=stride,
                        padding=pad, groups=groups).to(torch.float32)
    with tf32(num.sums == "tf32"):
        return F.conv2d(xq, wq, stride=stride, padding=pad, groups=groups)


def matmul(xq, wq_t, num: Numerics):
    """``xq @ wq_t`` with float32 sums, as :func:`conv`."""
    if num.sums == "exact":
        return (xq.double() @ wq_t.double()).to(torch.float32)
    with tf32(num.sums == "tf32"):
        return xq @ wq_t


@contextlib.contextmanager
def tf32(on: bool):
    """cuDNN convolutions and float32 matmuls in TF32 (``on``) or in full
    float32, with deterministic cuDNN algorithms; restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=on):
        torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved


def batch_norm(x, p: dict, name: str, train: bool):
    """flax BatchNorm on NCHW, float32, output in x's type: in training the
    batch statistics (biased variance), else the running ones."""
    x32 = x.to(torch.float32)
    if train:
        mean = x32.mean(dim=(0, 2, 3))
        ex2 = x32.square().mean(dim=(0, 2, 3))
        var = torch.clamp(ex2 - mean.square(), min=0.0)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    mul = torch.rsqrt(var + BN_EPS) * p[f"{name}.weight"]
    y = (x32 - mean[:, None, None]) * mul[:, None, None] \
        + p[f"{name}.bias"][:, None, None]
    return y.to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with +0.0 for -0.0 and for 0."""
    return F.threshold(x, 0.0, 0.0)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """A value held in bfloat16, widened back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    ll = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - ll)


class Calibrator:
    """The set-up's float32 forward: records each quantized layer's input
    ``max|x|`` by scale index, and hands each BatchNorm's input to
    ``set_bn(name, x)``, which sets that layer's parameters before it is
    applied."""

    def __init__(self, set_bn):
        self.in_max: dict = {}
        self.set_bn = set_bn

    def seen(self, sid: int, x: torch.Tensor) -> None:
        m = float(x.detach().abs().max())
        self.in_max[sid] = max(m, self.in_max.get(sid, 0.0))

    def bn(self, p: dict, x: torch.Tensor, name: str) -> torch.Tensor:
        self.set_bn(name, x)
        return batch_norm(x, p, name, False)
