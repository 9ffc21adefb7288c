"""AlexNet for ImageNet-1k (counterpart of the JAX ``models/alexnet.py``;
reference nets_imgnet/alexnet.py).

5 biased quantized convs (``conv0..conv4``) and 3 quantized FC layers
(``fc1..fc3``), scale indices 0..7 in order; no BatchNorm.  The flatten
before ``fc1`` keeps the reference's CHW order, whatever the memory layout,
and ``fc1``'s input width follows the image size as flax infers it from the
input: 256*6*6 = 9216 at 224, 256 at 64.  Dropout (0.5) before ``fc1``
and ``fc2`` in training, as in JAX; the identity at inference.  Inputs
are NHWC float32, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cnns_slfp_quantization_tpu_torch.calib import ScaleSet
from cnns_slfp_quantization_tpu_torch.ops.layers import (
    Dropout,
    QuantConv,
    QuantDense,
    relu,
)

# (features, kernel, stride, padding, max pool after), JAX alexnet.py:53-61
CONVS = [(64, 11, 4, 2, True), (192, 5, 1, 2, True), (384, 3, 1, 1, False),
         (256, 3, 1, 1, False), (256, 3, 1, 1, True)]


def feature_size(image_size: int) -> int:
    """Spatial size of the last pooled feature map."""
    s = image_size
    for _, k, stride, pad, pool in CONVS:
        s = (s + 2 * pad - k) // stride + 1
        if pool:
            s = (s - 3) // 2 + 1
    return s


class AlexNet(nn.Module):
    def __init__(self, scales: ScaleSet, num_classes: int = 1000,
                 qbit: int = 32, frozen_weights: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_pallas: Optional[bool] = None, image_size: int = 224,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scales = scales
        self.qbit = qbit
        common = dict(qbit=qbit, frozen_weights=frozen_weights,
                      compute_dtype=compute_dtype, use_pallas=use_pallas)
        in_ch = 3
        for sid, (feat, k, stride, pad, _) in enumerate(CONVS):
            setattr(self, f"conv{sid}", QuantConv(
                in_ch, feat, k, stride=stride, padding=pad, use_bias=True,
                ka=scales.ka[sid], kw=scales.kw[sid], nonneg_input=sid > 0,
                layer_id=sid, **common))
            in_ch = feat
        width = in_ch * feature_size(image_size) ** 2
        # fc inputs are flattened ReLU outputs: nonneg
        for sid, name, cin, cout in ((5, "fc1", width, 4096),
                                     (6, "fc2", 4096, 4096),
                                     (7, "fc3", 4096, num_classes)):
            setattr(self, name, QuantDense(
                cin, cout, ka=scales.ka[sid], kw=scales.kw[sid],
                nonneg_input=True, layer_id=sid, **common))
        self.drop1, self.drop2 = Dropout(0.5), Dropout(0.5)
        for m in self.modules():
            if isinstance(m, (QuantConv, QuantDense)):
                m.reset_parameters(generator)

    def flax_order(self):
        """Modules holding variables, in flax's init order (JAX
        alexnet.py): the reference ``.pth`` import's positional match
        follows it."""
        return [f"conv{i}" for i in range(len(CONVS))] + ["fc1", "fc2", "fc3"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for sid, (*_, pool) in enumerate(CONVS):
            x = relu(getattr(self, f"conv{sid}")(x))
            if pool:
                x = F.max_pool2d(x, 3, 2)
        x = torch.flatten(x, 1)  # NCHW logical order: the reference's CHW
        x = relu(self.fc1(self.drop1(x)))
        x = relu(self.fc2(self.drop2(x)))
        return self.fc3(x)
