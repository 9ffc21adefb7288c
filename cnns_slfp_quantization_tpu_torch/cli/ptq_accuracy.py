"""Statistical PTQ-accuracy harness (counterpart of the first half of the
JAX ``cli/ptq_accuracy.py``).

The reference's verification loop is dataset accuracy
(cifar100_train_eval.py:196-211, imgnet_train_eval.py:177-216) and its
headline claim is "<1% top-1 loss from SLFP<3,4> PTQ" (README.md:11).  With
no dataset or pretrained checkpoint at hand, the harness trains the port's
float32 model on class-conditional synthetic data until it is a real
classifier, calibrates it the reference's way, and evaluates held-out
inputs at fp32 and SLFP8 on the same weights:

- :data:`NETS`, :data:`TASK`, :func:`task_params`: the per-net synthetic
  task (image size, classes, signal, dropout), JAX's tuned values;
- :func:`train_our_model`, :func:`calibrate_trained`, :func:`gen_eval_sets`,
  :func:`_eval_ours`, :func:`to_markdown`.

The second half of JAX's harness, the oracle stage that evaluates the
reference's own PyTorch models (``nets_cifar`` / ``nets_imgnet``) on the
same weights and compares PTQ flip rates, waits until the reference's
model files are part of the repository: :data:`NETS` keeps the name of
each net's reference module for it, and no builder.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch import calib, models
from cnns_slfp_quantization_tpu_torch.calib import calibrate as calibrate_lib
from cnns_slfp_quantization_tpu_torch.data import synthetic
from cnns_slfp_quantization_tpu_torch.train import loop, optimizers

# net -> (dataset, image size, classes, dropout, the reference's module)
NETS = {
    "mobilenet": ("cifar", 32, 100, False, "nets_cifar.mobilenetv1"),
    # act-optimized variants: layerout SFP<4,4> quant + Swish/GELU
    "mobilenet_swish": ("cifar", 32, 100, False, "nets_cifar.mobilenetv1"),
    "shufflenetv2": ("cifar", 32, 100, False, "nets_cifar.shufflenet_v2"),
    "vgg16": ("cifar", 32, 100, True, "nets_cifar.vgg16"),
    "vgg16_gelu": ("cifar", 32, 100, True, "nets_cifar.vgg16"),
    "mobilenetv1": ("imgnet", 224, 1000, False, "nets_imgnet.mobilenetv1"),
    # 64px keeps the oracle tractable on a CPU; ResNet50's mean pool adapts
    "resnet": ("imgnet", 64, 1000, False, "nets_imgnet.resnet50"),
    "alexnet": ("imgnet", 224, 1000, True, "nets_imgnet.alexnet"),
    "squeezenet": ("imgnet", 224, 1000, True, "nets_imgnet.squeezenet1_0"),
}

# per-net fp32 training lr for the synthetic task (batch 64, SGD m=0.9):
# the no-BN nets (alexnet, squeezenet) diverge at the BN-net default 0.05
# and train with adam at 1e-4 (TASK "opt"); VGG/ResNet train better at 0.01
DEFAULT_LR = {"vgg16": 0.003, "vgg16_gelu": 0.01, "resnet": 0.01,
              "alexnet": 1e-4, "squeezenet": 1e-4}

# Per-net synthetic-task difficulty, tuned in JAX's probe runs so fp32 top-1
# lands in the informative 60-90% band (at saturation almost nothing flips;
# below 30% the rows compare near-random models).  ``signal`` is the
# class-signature amplitude against unit noise (data/synthetic.py),
# ``proto_res`` its resolution, ``classes`` shrinks the 1000-class ImageNet
# task to one the no-BN nets learn in a few hundred steps, and
# ``signal_jitter`` (per-image amplitude ~ U[0, 2*signal]) spreads the
# margins of the nets whose train accuracy jumps from chance.
TASK = {
    "mobilenet": {"signal": 0.25},
    "mobilenet_swish": {"signal": 0.2},
    "shufflenetv2": {"signal": 0.25},
    "vgg16": {"signal": 0.35},
    "vgg16_gelu": {"signal": 0.2},
    "resnet": {"signal": 0.25},
    "mobilenetv1": {"classes": 100, "signal": 0.2},
    "alexnet": {"classes": 100, "signal": 0.5, "opt": "adam",
                "signal_jitter": True},
    "squeezenet": {"classes": 100, "signal": 0.5, "opt": "adam",
                   "signal_jitter": True},
}


def task_params(name: str, *, signal=None, classes=None, proto_res=None,
                signal_jitter=None, opt=None):
    """Resolve the per-net synthetic-task configuration (CLI overrides win)."""
    dataset, size, default_classes, has_dropout, modname = NETS[name]
    t = TASK.get(name, {})
    return {
        "size": size,
        "classes": int(classes or t.get("classes", default_classes)),
        "signal": float(signal if signal is not None
                        else t.get("signal", 0.7)),
        "proto_res": int(proto_res or t.get("proto_res", 4)),
        "signal_jitter": bool(t.get("signal_jitter", False)
                              if signal_jitter is None else signal_jitter),
        "opt": str(opt or t.get("opt", "sgd")),
        "has_dropout": has_dropout,
        "modname": modname,
    }


def train_our_model(name: str, *, train_steps: int, batch_size: int,
                    lr: float, seed: int = 0, log_every: int = 50,
                    task=None, device="cuda") -> torch.nn.Module:
    """Train the port's fp32 model on synthetic class-conditional data
    (SGD with momentum 0.9 and weight decay 5e-4, or Adam where the task
    says so); returns it in eval mode."""
    task = task or task_params(name)
    size, classes = task["size"], task["classes"]
    model = models.create_model(
        name, 32, num_classes=classes, image_size=size,
        generator=torch.Generator().manual_seed(seed)).to(device)
    if task["opt"] == "adam":
        opt = optimizers.Adam(model.parameters(), lr)
    else:
        opt = optimizers.sgd(model.parameters(), lr, momentum=0.9,
                             weight_decay=5e-4)
    state = loop.TrainState(model, opt)
    step = loop.make_train_step(model, opt, task["has_dropout"])
    it = synthetic.SyntheticIterator(
        image_size=size, num_classes=classes, batch_size=batch_size,
        num_batches=train_steps, seed=seed, signal=task["signal"],
        proto_res=task["proto_res"], signal_jitter=task["signal_jitter"])
    for i, (images, labels) in enumerate(it):
        x = torch.from_numpy(images).to(device)
        y = torch.from_numpy(labels.astype(np.int64)).to(device)
        gen = (loop.step_generator((seed + 1,), i, x.device)
               if task["has_dropout"] else None)
        metrics = step(state, x, y, gen)
        if log_every and i % log_every == 0:
            print(f"  [{name}] step {i}: loss={float(metrics['loss']):.3f} "
                  f"acc={float(metrics['accuracy']):.3f}", flush=True)
    return model.eval()


def calibrate_trained(name: str, model: torch.nn.Module, calib_images,
                      batch: int, num_classes=None) -> calib.ScaleSet:
    """The reference's calibration workflow (cifar100_train_eval.py:213-301)
    on a trained fp32 model: absmax over a calibration set, through a
    qbit-32 capture model holding its weights -> ScaleSet."""
    dev = next(model.parameters()).device
    cap = models.create_model(name, 32, capture="absmax",
                              num_classes=num_classes,
                              image_size=NETS[name][1])
    cap.load_state_dict(model.state_dict())
    cap.to(dev)
    batches = [(calib_images[i:i + batch],)
               for i in range(0, len(calib_images), batch)]
    result = calibrate_lib.calibrate(cap, batches,
                                     max_images=len(calib_images))
    divisor = 15.0 if name.startswith("shufflenet") else 15.5
    ka = np.asarray(result.ka_max(), np.float64) / divisor
    kw = np.asarray(result.kw_max(), np.float64) / divisor
    n = max(len(ka), len(kw))

    def padto(a):
        return np.concatenate([a, np.ones(n - len(a))]) if len(a) < n else a

    return calib.ScaleSet(padto(ka), padto(kw), divisor,
                          source="ptq_accuracy synthetic calibration")


def _eval_ours(name: str, model: torch.nn.Module, images_nhwc, batch: int,
               scales=None, num_classes=None) -> dict:
    """qbit -> (predictions, logits) of the port's model at fp32 and SLFP8
    on ``model``'s weights (SLFP8 with ``scales``)."""
    dev = next(model.parameters()).device
    out = {}
    for qbit in (32, 8):
        m = models.create_model(name, qbit, num_classes=num_classes,
                                image_size=NETS[name][1],
                                scales=scales if qbit == 8 else None)
        m.load_state_dict(model.state_dict())
        m.to(dev).eval()
        logits = []
        with torch.no_grad():
            for i in range(0, len(images_nhwc), batch):
                x = torch.from_numpy(images_nhwc[i:i + batch]).to(dev)
                logits.append(m(x).float().cpu().numpy())
        logits = np.concatenate(logits)
        out[qbit] = (np.argmax(logits, -1), logits)
    return out


def gen_eval_sets(name: str, eval_images: int, eval_batch: int, seed: int,
                  task=None):
    """Deterministic held-out eval and calibration sets (the training class
    prototypes, fresh noise through seed offsets): JAX's, image for image."""
    task = task or task_params(name)
    size, classes = task["size"], task["classes"]
    kw = dict(signal=task["signal"], proto_res=task["proto_res"],
              signal_jitter=task["signal_jitter"])
    n_batches = math.ceil(eval_images / eval_batch)
    it = synthetic.SyntheticIterator(
        image_size=size, num_classes=classes, batch_size=eval_batch,
        num_batches=n_batches, seed=seed + 10_000, **kw)
    images, labels = [], []
    for x, y in it:
        images.append(x)
        labels.append(y)
    images = np.concatenate(images)[:eval_images]
    labels = np.concatenate(labels)[:eval_images]

    n_cal = min(512, eval_images)
    cal_it = synthetic.SyntheticIterator(
        image_size=size, num_classes=classes, batch_size=eval_batch,
        num_batches=-(-n_cal // eval_batch), seed=seed + 20_000, **kw)
    calib_images = np.concatenate([x for x, _ in cal_it])[:n_cal]
    return images, labels, calib_images


def to_markdown(rows) -> str:
    head = ("| net | n | fp32 top-1 (ours/torch) | SLFP8 top-1 (ours/torch) | "
            "PTQ drop (ours/torch) | flip rate (ours/torch) | "
            "flip diff ± 2se | pred match q8 | logit cos (mean/min) |\n"
            "|---|---|---|---|---|---|---|---|---|\n")
    body = ""
    for r in rows:
        body += (
            f"| {r['net']} | {r['n']} "
            f"| {r['acc_fp32_ours']:.2f} / {r['acc_fp32_torch']:.2f} "
            f"| {r['acc_slfp8_ours']:.2f} / {r['acc_slfp8_torch']:.2f} "
            f"| {r['ptq_drop_ours']:+.2f} / {r['ptq_drop_torch']:+.2f} "
            f"| {100 * r['flip_rate_ours']:.2f}% / "
            f"{100 * r['flip_rate_torch']:.2f}% "
            f"| {100 * r['flip_diff']:+.2f}% ± {200 * r['flip_diff_se']:.2f}% "
            f"| {100 * r['pred_match_slfp8']:.2f}% "
            f"| {r['logit_cos_slfp8_mean']:.4f} / "
            f"{r['logit_cos_slfp8_min']:.4f} |\n")
    return head + body
