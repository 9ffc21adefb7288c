"""Quantized-inference engine of the port (counterpart of the JAX
``serve.py::InferenceEngine``), for every net of the registry
(``models.MODEL_NAMES`` and the ResNet-50 STL / Swish variants).

    engine = InferenceEngine("resnet", qbit=8)        # on the card
    logits = engine.predict(images_nhwc)               # any batch size
    top1 = engine.classify(images_nhwc)

qbit 8 freezes the weights once (bf16 values, or uint8 SLFP<3,4> codes with
``pack_weights=True``) and serves them either through the fused executor
(``fused``; ResNet-50, the ReLU MobileNetV1 variants and ShuffleNetV2, the
default there) or through the module path
(``create_model(..., frozen_weights=True, use_pallas=...)``), where
``use_pallas`` routes the 1x1 convs and dense layers to K4 as in JAX.
qbit 7 (SFP<3,3>) freezes the weights as values and serves the module path
only.  qbit 32 runs the module path unquantized.  ShuffleNetV2's fused
executor, picked as JAX picks it, runs its 36 affine -> SFP<4,4> -> ReLU
posts as plain PyTorch ops (about 2,200 launches a forward); until they
become one kernel it is the slower SLFP8 route: on an H100 it served
0.92-0.98x the images/s of the packed module path (``fused=False,
pack_weights=True``) at batch 64 and 0.79-0.85x at 256 (``chip_smoke.py``,
in turns, two runs).  InceptionV3 is float32 only: it serves at qbit 32 and refuses
qbit 7 and 8, which JAX's engine cannot serve either.  A ``checkpoint``
ending in ``.pth`` is a reference PyTorch state_dict, matched by position
as JAX's ``load_pth`` matches it.  The engine runs on ``device="cuda"``
unless the caller asks for ``device="cpu"``; without a card the default
raises.
"""

from __future__ import annotations

import importlib
from typing import Optional

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch import calib, models
from cnns_slfp_quantization_tpu_torch.ops import freeze
from cnns_slfp_quantization_tpu_torch.ops.backend import backend_flags
from cnns_slfp_quantization_tpu_torch.train import checkpoint as ckpt_lib

# nets with a fused executor -> its module (JAX serve.py:63-70): CIFAR
# mobilenet has a quantized classifier, ImageNet mobilenetv1 a float32 one;
# mobilenet_swish and shufflenetv2_swish keep the module path
FUSABLE = {
    "resnet": "resnet50_fused", "resnet50": "resnet50_fused",
    "imgnet/resnet": "resnet50_fused",
    "mobilenet": "mobilenetv1_fused", "cifar/mobilenet": "mobilenetv1_fused",
    "mobilenetv1": "mobilenetv1_fused",
    "imgnet/mobilenetv1": "mobilenetv1_fused",
    "shufflenetv2": "shufflenetv2_fused",
    "cifar/shufflenetv2": "shufflenetv2_fused",
}
FLOAT_ONLY = ("inceptionv3", "imgnet/inceptionv3")


def default_image_size(net: str) -> int:
    """32 for a bare CIFAR name, 224 for any other: JAX's rule
    (``serve.py:85-86``) on the name as given, so ``"cifar/mobilenet"``
    gets 224."""
    return (models.INPUT_SIZE["cifar"] if net in models.MODEL_NAMES["cifar"]
            else models.INPUT_SIZE["imgnet"])


class InferenceEngine:
    def __init__(
        self,
        net: str,
        *,
        checkpoint: Optional[str] = None,
        qbit: int = 8,
        batch_size: int = 64,
        image_size: Optional[int] = None,
        pack_weights: bool = False,
        compute_dtype: Optional[torch.dtype] = torch.bfloat16,
        use_pallas: Optional[bool] = False,
        fused: Optional[bool] = None,
        policy: Optional[dict] = None,
        scales=None,
        device: str = "cuda",
        seed: int = 0,
        generator: Optional[torch.Generator] = None,
    ):
        """``checkpoint``: a reference PyTorch state_dict (a path ending in
        ``.pth``, read by :func:`train.checkpoint.load_pth`), or else a
        state_dict of the port's model saved with ``torch.save``; without
        one the weights are flax's initializers
        drawn from ``generator`` (or a CPU generator seeded with ``seed``),
        the same on every device.  ``scales``: a calib.ScaleSet or a path to
        a scale JSON; the shipped constants otherwise.

        ``fused=None`` picks the fused executor for SLFP8 ResNet-50,
        MobileNetV1 and ShuffleNetV2 unless the caller asks for K4
        (``use_pallas=True``) or float32 numerics (``compute_dtype=None``);
        ``fused=True`` on another net or qbit raises.  ``policy`` goes to
        the fused executor (keys ``conv1``/``conv3`` and ``chain`` for
        ResNet-50, ``dw`` for MobileNetV1, none for ShuffleNetV2); by
        default ResNet-50's stride-1 bottlenecks of stages 2 and 3 run
        through K6, one launch each, and ``policy={"chain": frozenset()}``
        runs them as JAX's default placement does.
        ``image_size`` defaults to :func:`default_image_size`."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngine runs on the card by default and found no "
                "CUDA device; pass device='cpu' to run on the CPU")
        if qbit not in (7, 8, 32):
            raise ValueError(f"qbit {qbit}: expected 7 (SFP<3,3>), 8 "
                             f"(SLFP<3,4>) or 32 (unquantized)")
        if net in FLOAT_ONLY and qbit != 32:
            raise ValueError(f"{net} is float32 only (no quantized layer to "
                             f"freeze): serve it at qbit=32")
        if isinstance(scales, (str, bytes)) or hasattr(scales, "read_text"):
            scales = calib.load_scales_path(scales)
        fusable = net in FUSABLE
        if fused is None:
            fused = (fusable and qbit == 8 and use_pallas is not True
                     and compute_dtype == torch.bfloat16)
        elif fused and not (fusable and qbit == 8):
            raise ValueError(
                f"fused=True requires net in {sorted(FUSABLE)} and qbit=8 (the "
                f"fused executor consumes SLFP<3,4> frozen weights, float "
                f"or packed uint8); got {net!r}, qbit {qbit}")
        self.fused = fused
        self.qbit = qbit
        self.batch_size = batch_size
        self.image_size = image_size or default_image_size(net)
        self.policy = policy
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        model = models.create_model(
            net, qbit, scales=scales, compute_dtype=compute_dtype,
            use_pallas=use_pallas, image_size=self.image_size,
            generator=generator)
        if checkpoint and str(checkpoint).endswith(".pth"):
            ckpt_lib.load_jax_variables(model,
                                        ckpt_lib.load_pth(checkpoint, model))
        elif checkpoint:
            model.load_state_dict(torch.load(checkpoint, map_location="cpu",
                                             weights_only=True))
        model.eval()
        if qbit in (7, 8):
            # packing targets the SLFP<3,4> codes: qbit 7 stores values
            if pack_weights and qbit == 8:
                freeze.pack(model)
            else:
                freeze.prequantize(
                    model, torch.bfloat16 if fused else
                    compute_dtype or torch.float32)
        if fused:
            executor = importlib.import_module(
                f"cnns_slfp_quantization_tpu_torch.models.{FUSABLE[net]}")
            self.executor = executor.prepare(model, device=self.device)
            self._forward = lambda x: executor.fused_apply(
                self.executor, x, policy=self.policy)
        else:
            self.model = model.to(self.device)
            self._forward = (self._quantized_module if qbit in (7, 8)
                             else self.model)

    def _quantized_module(self, x: torch.Tensor) -> torch.Tensor:
        """The qbit 7 / 8 module path (K4 where ``use_pallas`` routes an
        SLFP8 layer, K1 for the other layers' input quantize) under the
        fused executors' numerics flags: without deterministic cuDNN, packed
        and float-frozen weights would not give the same bits."""
        with backend_flags():
            return self.model(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits for an NHWC float32 batch already on the engine's device."""
        with torch.inference_mode():
            return self._forward(x)

    def predict(self, images) -> np.ndarray:
        """float32 logits for NHWC float32 images; any leading batch size,
        padded internally to the fixed batch."""
        x = np.asarray(images, np.float32)
        n = x.shape[0]
        out = []
        for s in range(0, n, self.batch_size):
            chunk = x[s:s + self.batch_size]
            pad = self.batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)])
            y = self.forward(torch.from_numpy(chunk).to(self.device))
            out.append(y[:self.batch_size - pad].float().cpu().numpy())
        return np.concatenate(out)[:n]

    def classify(self, images) -> np.ndarray:
        """Top-1 class ids."""
        return np.argmax(self.predict(images), axis=-1)

    def throughput(self, iters: int = 16) -> float:
        """Images per second at the fixed batch size, timed on the card."""
        from cnns_slfp_quantization_tpu_torch.utils.profiling import throughput

        x = torch.zeros((self.batch_size, self.image_size, self.image_size,
                         3), dtype=torch.float32, device=self.device)
        return throughput(lambda: self.forward(x), self.batch_size,
                          iters=iters)
