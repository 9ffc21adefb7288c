"""6%-subset fine-tune recovery (counterpart of the JAX ``cli/recovery.py``;
reference README.md:12).

The reference's second headline: after PTQ, fine-tuning on about 6% of the
train set restores the lost accuracy.  The reference does it by hand (a
short ``--retrain`` at lr 1e-4); here it runs end to end on the
deterministic synthetic task of ``cli/ptq_accuracy.py``:

1. train fp32 on a fixed train set (momentum SGD),
2. calibrate on held-out images (the ``--pre_reference`` workflow) and
   measure the SLFP PTQ top-1 drop,
3. fine-tune the quantized model with DSGD (the paper's quantization-aware
   SGD) on a class-stratified 6% subset (``data/subset.py``),
4. re-evaluate: drop -> recovered.

    python -m cnns_slfp_quantization_tpu_torch.cli.recovery --net mobilenet

Every step trains and evaluates on ``--device`` (default ``cuda``) in
float32 compute, as JAX's does.  One JSON row per ``--qbits`` entry, with
JAX's keys.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch import models
from cnns_slfp_quantization_tpu_torch.cli.ptq_accuracy import (
    DEFAULT_LR,
    NETS,
    calibrate_trained,
    gen_eval_sets,
    task_params,
)
from cnns_slfp_quantization_tpu_torch.data import subset as subset_lib
from cnns_slfp_quantization_tpu_torch.data import synthetic
from cnns_slfp_quantization_tpu_torch.train import loop, optimizers


def _task(net: str) -> dict:
    """Synthetic-task config: the harness nets use their TASK entry; the
    activation-variant ResNets reuse the resnet task without dropout."""
    if net in NETS:
        return task_params(net)
    if net in ("resnet_stl", "resnet_swish"):
        t = dict(task_params("resnet"))
        t["has_dropout"] = False
        return t
    raise ValueError(
        f"unknown net {net!r}: recovery supports {sorted(NETS)} plus "
        f"resnet_stl / resnet_swish")


def _train_arrays(n_images, batch, task, seed=0):
    it = synthetic.SyntheticIterator(
        image_size=task["size"], num_classes=task["classes"],
        batch_size=batch, num_batches=math.ceil(n_images / batch), seed=seed,
        signal=task["signal"], proto_res=task["proto_res"],
        signal_jitter=task["signal_jitter"])
    xs, ys = zip(*list(it))
    return (np.concatenate(xs)[:n_images], np.concatenate(ys)[:n_images])


def _epochs(model, opt, images, labels, batch, epochs, seed, device):
    """``epochs`` passes over full batches in a fresh order each, drawn
    from ``np.random.default_rng(seed)`` as JAX's are (with no dropout:
    JAX's step here is ``make_train_step(model, tx)``)."""
    if len(images) < batch:
        raise ValueError(
            f"need at least one full batch: {len(images)} images < "
            f"batch {batch} (raise --train_images or lower --batch)")
    state = loop.TrainState(model, opt)
    step = loop.make_train_step(model, opt)
    rng = np.random.default_rng(seed)
    for e in range(epochs):
        order = rng.permutation(len(images))
        metrics = None
        for i in range(0, len(images) - batch + 1, batch):
            idx = order[i:i + batch]
            x = torch.from_numpy(images[idx]).to(device)
            y = torch.from_numpy(labels[idx].astype(np.int64)).to(device)
            metrics = step(state, x, y)
        print(f"  epoch {e}: loss={float(metrics['loss']):.3f} "
              f"acc={float(metrics['accuracy']):.3f}", flush=True)
    return state


def _evaluate(model, images, labels, batch, device):
    es = loop.make_eval_step(model)
    batches = [(torch.from_numpy(images[i:i + batch]).to(device),
                torch.from_numpy(labels[i:i + batch].astype(np.int64)).to(
                    device))
               for i in range(0, len(images) - batch + 1, batch)]
    return loop.evaluate(es, batches)["top1"]


def run(net="mobilenet", qbit=8, fp32_epochs=4, train_images=12800,
        batch=128, subset_fraction=0.06, qat_epochs=10, qat_lr=1e-4,
        eval_images=2000, seed=0, device="cuda"):
    device = torch.device(device)
    task = _task(net)
    size, classes = task["size"], task["classes"]
    tr_x, tr_y = _train_arrays(train_images, batch, task, seed=seed)
    ev_x, ev_y, cal_x = gen_eval_sets(net, eval_images, 64, seed, task=task)

    # 1. fp32 baseline training
    model32 = models.create_model(
        net, 32, num_classes=classes, image_size=size,
        generator=torch.Generator().manual_seed(seed)).to(device)
    lr32 = DEFAULT_LR.get(net, DEFAULT_LR.get(net.split("_")[0], 0.05))
    opt32 = optimizers.sgd(model32.parameters(), lr32, momentum=0.9,
                           weight_decay=5e-4)
    print(f"[{net}] fp32 training ({fp32_epochs} epochs x "
          f"{train_images} images, lr={lr32})", flush=True)
    _epochs(model32, opt32, tr_x, tr_y, batch, fp32_epochs, seed, device)
    acc_fp32 = _evaluate(model32, ev_x, ev_y, 64, device)

    # 2. calibrate + PTQ eval
    qs = calibrate_trained(net, model32, cal_x, 64, num_classes=classes)
    modelq = models.create_model(net, qbit, scales=qs, num_classes=classes,
                                 image_size=size)
    modelq.load_state_dict(model32.state_dict())
    modelq.to(device)
    acc_ptq = _evaluate(modelq, ev_x, ev_y, 64, device)

    # 3. DSGD fine-tune on the stratified 6% subset (the reference's lr
    #    default 1e-4, cifar100_train_eval.py:62)
    idx = subset_lib.stratified_indices(tr_y, subset_fraction, seed=seed)
    sub_x, sub_y = tr_x[idx], tr_y[idx]
    sub_batch = min(batch, max(32, len(idx) // 6))
    print(f"[{net}] DSGD fine-tune on {len(idx)} images "
          f"({100 * subset_fraction:.0f}% subset, {qat_epochs} epochs)",
          flush=True)
    optq = optimizers.create_optimizer("DSGD", modelq.parameters(), qat_lr,
                                       qbit, weight_decay=5e-4)
    _epochs(modelq, optq, sub_x, sub_y, sub_batch, qat_epochs, seed + 1,
            device)
    acc_rec = _evaluate(modelq, ev_x, ev_y, 64, device)

    row = {
        "net": net, "qbit": qbit, "train_images": train_images,
        "subset_images": int(len(idx)),
        "subset_fraction": subset_fraction, "qat_epochs": qat_epochs,
        "acc_fp32": round(acc_fp32, 2), "acc_ptq": round(acc_ptq, 2),
        "ptq_drop": round(acc_fp32 - acc_ptq, 2),
        "acc_recovered": round(acc_rec, 2),
        "recovered_delta": round(acc_rec - acc_ptq, 2),
        "vs_fp32_after_recovery": round(acc_rec - acc_fp32, 2),
    }
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    p = argparse.ArgumentParser(
        description="6%-subset fine-tune recovery, PyTorch/CUDA port")
    p.add_argument("--net", default="mobilenet")
    p.add_argument("--qbits", type=int, nargs="+", default=[8, 7])
    p.add_argument("--fp32_epochs", type=int, default=4)
    p.add_argument("--train_images", type=int, default=12800)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--subset", type=float, default=0.06)
    p.add_argument("--qat_epochs", type=int, default=10)
    p.add_argument("--qat_lr", type=float, default=1e-4)
    p.add_argument("--eval_images", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    # JAX's persistent compilation cache: accepted for CLI parity, ignored
    p.add_argument("--jax_cache", type=str, default="")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    cfg = p.parse_args(argv)
    if cfg.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu "
                           "to run on the CPU")
    return [run(cfg.net, q, cfg.fp32_epochs, cfg.train_images, cfg.batch,
                cfg.subset, cfg.qat_epochs, cfg.qat_lr, cfg.eval_images,
                cfg.seed, cfg.device)
            for q in cfg.qbits]


if __name__ == "__main__":
    main()
