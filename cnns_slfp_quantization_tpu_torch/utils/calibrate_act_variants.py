"""Calibration constants for the STL / Swish ResNet-50 variants
(counterpart of JAX's ``tools/calibrate_act_variants.py``).

    python3 -m cnns_slfp_quantization_tpu_torch.utils.calibrate_act_variants \\
        [--train_steps 120] [--batch 32] [--size 224] [--calib_images 512] \\
        [--acts stl swish] [--out_dir DIR] [--device cuda|cpu]

Swapping ReLU for STL or Swish changes every layer input's distribution,
so the ReLU net's ``resnet50_imgnet`` Ka do not fit the variants.  For
each activation this follows JAX's workflow step by step on synthetic
data: the float32 ``resnet_{act}`` model (weights from seed 0) trains
``train_steps`` steps of SGD at 0.05 with momentum 0.9 and decayed
weights 5e-4, in optax's order (the decay added to the gradient, then
momentum: :func:`make_optimizer`) on the synthetic iterator with seed 0;
then the absmax calibration pass over ``calib_images`` images of the
iterator with seed 7, and ``calib.save_scales`` writes
``resnet50_{act}_imgnet.json`` (divisor 15.5, JAX's ``source`` text).
``--out_dir`` omitted writes into the package's shipped constants, as in
JAX: pass a directory to keep them.  Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch.train import optimizers


def make_optimizer(params):
    """``optax.chain(optax.add_decayed_weights(5e-4), optax.sgd(0.05,
    momentum=0.9))``: the port's momentum SGD adds the decayed weights to
    the gradient before the momentum, as that chain does."""
    return optimizers.sgd(params, 0.05, momentum=0.9, weight_decay=5e-4)


def source_text(act: str, train_steps: int, calib_images: int) -> str:
    """The ``source`` line JAX writes for these arguments."""
    return (f"synthetic-calibrated ({act} variant, {train_steps} train "
            f"steps, {calib_images} images; regenerate on real data via "
            f"--pre_reference)")


def calibrate_variant(act: str, *, train_steps: int, batch: int, size: int,
                      calib_images: int, out_dir=None, device="cuda"):
    """Train, calibrate and write one variant's constants; returns the
    calibration result."""
    from cnns_slfp_quantization_tpu_torch import calib, models
    from cnns_slfp_quantization_tpu_torch.calib import calibrate as cal
    from cnns_slfp_quantization_tpu_torch.data import synthetic
    from cnns_slfp_quantization_tpu_torch.train import loop

    dev = torch.device(device)
    name = f"resnet_{act}"
    model = models.create_model(
        name, 32, image_size=size,
        generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(model.parameters())
    state = loop.TrainState(model, opt)
    step = loop.make_train_step(model, opt)
    it = synthetic.SyntheticIterator(
        image_size=size, num_classes=1000, batch_size=batch,
        num_batches=train_steps, seed=0)
    for i, (images, labels) in enumerate(it):
        metrics = step(state, torch.from_numpy(images).to(dev),
                       torch.from_numpy(labels.astype(np.int64)).to(dev))
        if i % 25 == 0:
            print(f"  [{name}] step {i}: loss="
                  f"{float(metrics['loss']):.3f}", flush=True)

    cap = models.create_model(name, 32, capture="absmax", image_size=size)
    cap.load_state_dict(model.state_dict())
    cap.to(dev)
    batches = synthetic.SyntheticIterator(
        image_size=size, num_classes=1000, batch_size=batch,
        num_batches=-(-calib_images // batch), seed=7)
    result = cal.calibrate(cap, batches, max_images=calib_images)
    path = calib.save_scales(
        f"resnet50_{act}_imgnet", result.ka_max(), result.kw_max(), 15.5,
        source=source_text(act, train_steps, calib_images), out_dir=out_dir)
    print(f"wrote {path}", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train_steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--calib_images", type=int, default=512)
    ap.add_argument("--acts", nargs="+", default=["stl", "swish"])
    ap.add_argument("--out_dir", type=str, default=None,
                    help="default: the shipped calib/constants package dir")
    ap.add_argument("--device", default="cuda")
    cfg = ap.parse_args(argv)
    from cnns_slfp_quantization_tpu_torch.utils import turns

    dev, card = turns.device(cfg.device)
    print(f"card: {card}", flush=True)
    for act in cfg.acts:
        calibrate_variant(act, train_steps=cfg.train_steps, batch=cfg.batch,
                          size=cfg.size, calib_images=cfg.calib_images,
                          out_dir=cfg.out_dir, device=dev.type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
