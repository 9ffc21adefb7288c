"""Max-abs calibration pass (counterpart of the JAX ``calib/calibrate.py``;
reference get_scale_factor, cifar100_train_eval.py:213-301).

Workflow (the reference's ``--pre_reference``): run the float32 model
(qbit 32) over about 1000 images, collect max|input|, max|weight| and
max|output| of each quantized layer through its ``capture="absmax"`` store
(``ops/layers.py``), divide by 15.5 (15.0 for ShuffleNetV2) and write the
JSON scale file the models read.  The maxima are reduced on the model's
device; one small tensor of them crosses to the host per batch.

The pass runs in eval mode, without gradients, with cuDNN and the matmuls
in full float32 (``ops.backend.exact_f32``): under TF32 a card's maxima
would follow its conv precision, and the constants are a model artifact.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch import calib
from cnns_slfp_quantization_tpu_torch.ops import layers
from cnns_slfp_quantization_tpu_torch.ops.backend import exact_f32

_TAG_RE = re.compile(r"^(in|w|out)(\d+)$")


@dataclasses.dataclass
class CalibResult:
    input_absmax: dict[int, float]
    weight_absmax: dict[int, float]
    output_absmax: dict[int, float]

    def ka_max(self) -> list[float]:
        n = max(self.input_absmax) + 1
        return [self.input_absmax.get(i, 1.0) for i in range(n)]

    def kw_max(self) -> list[float]:
        n = max(self.weight_absmax) + 1
        return [self.weight_absmax.get(i, 1.0) for i in range(n)]


def _device(model: torch.nn.Module) -> torch.device:
    for p in model.parameters():
        return p.device
    return torch.device("cpu")


def calibrate(model: torch.nn.Module, batches: Iterable, *,
              max_images: int = 1000) -> CalibResult:
    """Run forward passes and collect per-layer absmax statistics.

    ``model`` must be in ``capture="absmax"`` mode.  ``batches`` yields NHWC
    images (numpy or tensors; labels ignored if tuples).  Stops after the
    batch that reaches ``max_images`` (the reference uses 1000,
    cifar100_train_eval.py:280).
    """
    dev = _device(model)
    merged: dict[str, dict[int, float]] = {"in": {}, "w": {}, "out": {}}
    seen = 0
    model.eval()
    for batch in batches:
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                            dtype=torch.float32).to(dev)
        layers.reset_capture(model)
        with torch.no_grad(), exact_f32():
            model(x)
        tags, values = [], []
        for store in layers.captured(model).values():
            for tag, v in store.items():
                if _TAG_RE.match(tag):
                    tags.append(tag)
                    values.append(v)
        host = torch.stack(values).cpu().numpy() if values else []
        for tag, v in zip(tags, host):
            m = _TAG_RE.match(tag)
            kind, lid = m.group(1), int(m.group(2))
            v = float(v)
            cur = merged[kind].get(lid)
            merged[kind][lid] = v if cur is None else max(cur, v)
        seen += x.shape[0]
        if seen >= max_images:
            break
    return CalibResult(merged["in"], merged["w"], merged["out"])


def calibrate_and_save(model, batches, name: str, divisor: float = 15.5,
                       **kw):
    """The reference workflow: calibrate, then write
    ``calib/constants/<name>.json`` (the analog of the
    ``max_inout_<net>.txt`` / ``max_weight_<net>.txt`` dumps)."""
    result = calibrate(model, batches, **kw)
    path = calib.save_scales(name, result.ka_max(), result.kw_max(), divisor)
    return result, path
