"""Model registry of the port (counterpart of the JAX ``models/__init__.py``).

Ported so far: MobileNetV1 (CIFAR ``mobilenet`` and ``mobilenet_swish``,
ImageNet ``mobilenetv1``), ResNet-50, SqueezeNet 1.0 and AlexNet; the rest
of the zoo is ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

from typing import Optional

import torch

from cnns_slfp_quantization_tpu_torch import calib

_MOBILENETS = ("mobilenet", "cifar/mobilenet", "mobilenet_swish",
               "cifar/mobilenet_swish", "mobilenetv1", "imgnet/mobilenetv1")
_RESNETS = ("resnet", "resnet50", "imgnet/resnet")
_SQUEEZENETS = ("squeezenet", "imgnet/squeezenet")
_ALEXNETS = ("alexnet", "imgnet/alexnet")
# every name create_model accepts
NAMES = _MOBILENETS + _RESNETS + _SQUEEZENETS + _ALEXNETS


def create_model(name: str, qbit: int = 32, *,
                 scales: Optional[calib.ScaleSet] = None,
                 num_classes: Optional[int] = None,
                 frozen_weights: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_pallas: Optional[bool] = None,
                 image_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
    """Build a model by the reference CLI's ``--net`` name.  ``image_size``
    fixes AlexNet's fc1 width, which flax infers from the first input
    (default: the dataset's ``INPUT_SIZE``)."""
    common = dict(qbit=qbit, frozen_weights=frozen_weights,
                  compute_dtype=compute_dtype, use_pallas=use_pallas,
                  generator=generator, num_classes=num_classes or 1000)
    if name in _MOBILENETS:
        from cnns_slfp_quantization_tpu_torch.models import mobilenetv1

        kind = name.split("/")[-1]
        if kind == "mobilenetv1":
            return mobilenetv1.MobileNetV1(
                scales=scales or calib.load_scales("mobilenetv1_imgnet"),
                quant_classifier=False, **common)
        common["num_classes"] = num_classes or 100
        if kind == "mobilenet_swish":
            return mobilenetv1.MobileNetV1(
                scales=scales or calib.load_scales("mobilenetv1_swish_cifar"),
                swish_tail=4, layerout_quant=True, **common)
        return mobilenetv1.MobileNetV1(
            scales=scales or calib.load_scales("mobilenetv1_cifar"), **common)
    if name in _RESNETS:
        from cnns_slfp_quantization_tpu_torch.models import resnet50

        return resnet50.ResNet50(
            scales=scales or calib.load_scales("resnet50_imgnet"), **common)
    if name in _SQUEEZENETS:
        from cnns_slfp_quantization_tpu_torch.models import squeezenet

        return squeezenet.SqueezeNet(
            scales=scales or calib.load_scales("squeezenet_imgnet"), **common)
    if name in _ALEXNETS:
        from cnns_slfp_quantization_tpu_torch.models import alexnet

        return alexnet.AlexNet(
            scales=scales or calib.load_scales("alexnet_imgnet"),
            image_size=image_size or INPUT_SIZE["imgnet"], **common)
    raise NotImplementedError(
        f"model {name!r} is not ported yet (ROADMAP Queue 1 item 6: the rest "
        f"of the zoo, module path)")


# the ported names, keyed by dataset as in the JAX registry
MODEL_NAMES = {
    "cifar": ["mobilenet", "mobilenet_swish"],
    "imgnet": ["mobilenetv1", "resnet", "alexnet", "squeezenet"],
}

INPUT_SIZE = {"cifar": 32, "imgnet": 224}
