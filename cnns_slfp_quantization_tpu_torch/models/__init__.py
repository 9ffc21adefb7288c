"""Model registry of the port (counterpart of the JAX ``models/__init__.py``).

Only ResNet-50 is ported so far; the rest of the zoo is ROADMAP Queue 1
item 6.
"""

from __future__ import annotations

from typing import Optional

import torch

from cnns_slfp_quantization_tpu_torch import calib


def create_model(name: str, qbit: int = 32, *,
                 scales: Optional[calib.ScaleSet] = None,
                 num_classes: Optional[int] = None,
                 frozen_weights: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
    """Build a model by the reference CLI's ``--net`` name."""
    if name in ("resnet", "resnet50", "imgnet/resnet"):
        from cnns_slfp_quantization_tpu_torch.models import resnet50

        return resnet50.ResNet50(
            scales=scales or calib.load_scales("resnet50_imgnet"),
            num_classes=num_classes or 1000, qbit=qbit,
            frozen_weights=frozen_weights, compute_dtype=compute_dtype,
            generator=generator)
    raise NotImplementedError(
        f"model {name!r} is not ported yet (ROADMAP Queue 1 item 6: the rest "
        f"of the zoo, module path)")
