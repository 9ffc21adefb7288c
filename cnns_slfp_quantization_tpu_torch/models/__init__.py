"""Model registry of the port (counterpart of the JAX ``models/__init__.py``).

Names mirror the reference drivers' ``--net`` values, keyed by dataset:

cifar:  mobilenet, mobilenet_swish, shufflenetv2, shufflenetv2_swish,
        vgg16, vgg16_gelu
imgnet: mobilenetv1, resnet, alexnet, squeezenet, inceptionv3

plus ``resnet_stl`` / ``resnet_swish`` (the activation-optimized ResNet-50
variants), the ``cifar/`` / ``imgnet/`` prefixed forms, and one name the
JAX registry does not have: ``imgnet/shufflenetv2``, ShuffleNet V2 1.0x in
its published ImageNet form (224x224, 1000 classes).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from cnns_slfp_quantization_tpu_torch import calib

_MOBILENETS = ("mobilenet", "cifar/mobilenet", "mobilenet_swish",
               "cifar/mobilenet_swish", "mobilenetv1", "imgnet/mobilenetv1")
# both driver names build the ReLU architecture; they differ only in which
# checkpoint the reference loads (JAX models/__init__.py:63-64)
_SHUFFLENETS = ("shufflenetv2", "shufflenetv2_swish", "cifar/shufflenetv2",
                "cifar/shufflenetv2_swish")
# the published ImageNet form, which the JAX registry does not have
_SHUFFLENET_IMGNET = ("imgnet/shufflenetv2",)
_VGGS = ("vgg16", "cifar/vgg16", "vgg16_gelu", "cifar/vgg16_gelu")
_RESNETS = ("resnet", "resnet50", "imgnet/resnet")
_RESNET_VARIANTS = ("resnet_stl", "resnet_swish", "imgnet/resnet_stl",
                    "imgnet/resnet_swish")
_SQUEEZENETS = ("squeezenet", "imgnet/squeezenet")
_ALEXNETS = ("alexnet", "imgnet/alexnet")
_INCEPTIONS = ("inceptionv3", "imgnet/inceptionv3")
# every name create_model accepts
NAMES = (_MOBILENETS + _SHUFFLENETS + _SHUFFLENET_IMGNET + _VGGS + _RESNETS
         + _RESNET_VARIANTS + _SQUEEZENETS + _ALEXNETS + _INCEPTIONS)


def _resnet_variant_scales(name: str, act: str, qbit: int):
    """The variant's own constants (swapping ReLU for STL / Swish changes
    every layer-input distribution), with JAX's warnings: loud when they
    are missing and the ReLU constants stand in, and when they come from a
    synthetic-data model (JAX models/__init__.py:107-129)."""
    try:
        scales = calib.load_scales(f"resnet50_{act}_imgnet")
    except FileNotFoundError:
        warnings.warn(
            f"calibration constants resnet50_{act}_imgnet.json not found; "
            f"falling back to the ReLU-calibrated resnet50_imgnet constants, "
            f"which are WRONG for the {act} variant: recalibrate",
            stacklevel=3)
        scales = calib.load_scales("resnet50_imgnet")
    if qbit < 32 and "synthetic" in scales.source:
        warnings.warn(
            f"{name}: shipped default constants are calibrated from a "
            f"synthetic-data model ({scales.source!r}); for real checkpoints "
            f"recalibrate before quantized inference", stacklevel=3)
    return scales


def create_model(name: str, qbit: int = 32, *,
                 capture: Optional[str] = None,
                 scales: Optional[calib.ScaleSet] = None,
                 num_classes: Optional[int] = None,
                 frozen_weights: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_pallas: Optional[bool] = None,
                 ratio: float = 1,
                 image_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
    """Build a model by the reference CLI's ``--net`` name.  ``capture``
    (``"absmax"`` or ``"full"``) puts every quantized layer in that
    calibration mode (``ops.layers.set_capture``).  ``ratio`` is the
    CIFAR ShuffleNetV2's width plan (0.5, 1, 1.5 or 2; any other net,
    ``imgnet/shufflenetv2`` among them, raises on a ratio other than 1).
    ``image_size`` fixes AlexNet's fc1 width, which flax infers from the
    first input (default: the dataset's ``INPUT_SIZE``).  InceptionV3 is
    float32 only and takes no quantization argument, as in JAX."""
    model = _create(name, qbit, scales=scales, num_classes=num_classes,
                    frozen_weights=frozen_weights,
                    compute_dtype=compute_dtype, use_pallas=use_pallas,
                    ratio=ratio, image_size=image_size, generator=generator)
    if capture is not None:
        from cnns_slfp_quantization_tpu_torch.ops.layers import set_capture

        set_capture(model, capture)
    return model


def _create(name, qbit, *, scales, num_classes, frozen_weights,
            compute_dtype, use_pallas, ratio, image_size, generator):
    if ratio != 1 and name not in _SHUFFLENETS:
        raise ValueError(
            f"ratio={ratio} is only supported by the CIFAR shufflenetv2 "
            f"(got {name!r})")
    if name in _INCEPTIONS:
        from cnns_slfp_quantization_tpu_torch.models import inception_v3

        return inception_v3.InceptionV3(num_classes=num_classes or 1000,
                                        generator=generator)
    common = dict(qbit=qbit, frozen_weights=frozen_weights,
                  compute_dtype=compute_dtype, use_pallas=use_pallas,
                  generator=generator, num_classes=num_classes or 1000)
    kind = name.split("/")[-1]
    if name in _MOBILENETS:
        from cnns_slfp_quantization_tpu_torch.models import mobilenetv1

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
    if name in _SHUFFLENETS:
        from cnns_slfp_quantization_tpu_torch.models import shufflenetv2

        common["num_classes"] = num_classes or 100
        return shufflenetv2.ShuffleNetV2(
            scales=scales or calib.load_scales("shufflenetv2_cifar"),
            ratio=ratio, **common)
    if name in _SHUFFLENET_IMGNET:
        from cnns_slfp_quantization_tpu_torch.models import shufflenetv2

        return shufflenetv2.ShuffleNetV2(
            scales=scales or calib.load_scales("shufflenetv2_imgnet"),
            imagenet=True, **common)
    if name in _VGGS:
        from cnns_slfp_quantization_tpu_torch.models import vgg16

        common["num_classes"] = num_classes or 100
        gelu = kind == "vgg16_gelu"
        return vgg16.VGG16(
            scales=scales or calib.load_scales(
                "vgg16_gelu_cifar" if gelu else "vgg16_cifar"),
            gelu_variant=gelu, **common)
    if name in _RESNETS:
        from cnns_slfp_quantization_tpu_torch.models import resnet50

        return resnet50.ResNet50(
            scales=scales or calib.load_scales("resnet50_imgnet"), **common)
    if name in _RESNET_VARIANTS:
        from cnns_slfp_quantization_tpu_torch.models import resnet50

        act = "stl" if name.endswith("stl") else "swish"
        if scales is None:
            scales = _resnet_variant_scales(name, act, qbit)
        return resnet50.ResNet50(scales=scales, act=act, layerout_quant=True,
                                 **common)
    if name in _SQUEEZENETS:
        from cnns_slfp_quantization_tpu_torch.models import squeezenet

        return squeezenet.SqueezeNet(
            scales=scales or calib.load_scales("squeezenet_imgnet"), **common)
    if name in _ALEXNETS:
        from cnns_slfp_quantization_tpu_torch.models import alexnet

        return alexnet.AlexNet(
            scales=scales or calib.load_scales("alexnet_imgnet"),
            image_size=image_size or INPUT_SIZE["imgnet"], **common)
    raise ValueError(f"unknown model {name!r}")


# the reference drivers' names, keyed by dataset as in the JAX registry
MODEL_NAMES = {
    "cifar": ["mobilenet", "mobilenet_swish", "shufflenetv2",
              "shufflenetv2_swish", "vgg16", "vgg16_gelu"],
    "imgnet": ["mobilenetv1", "resnet", "alexnet", "squeezenet",
               "inceptionv3"],
}

INPUT_SIZE = {"cifar": 32, "imgnet": 224}
