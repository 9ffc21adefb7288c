"""The synthetic task's difficulty probe: fp32 top-1 against the signal
amplitude per net (counterpart of JAX's ``tools/tune_task_signal.py``).

    python3 -m cnns_slfp_quantization_tpu_torch.utils.tune_task_signal \\
        --net mobilenet --signals 0.08 0.12 0.16 0.24 [--train_steps 300] \\
        [--eval_images 1000] [--proto_res R] [--classes C] [--lr LR] \\
        [--seed 0] [--device cuda|cpu]

Supports tuning ``cli/ptq_accuracy.TASK`` so that every net's fp32
accuracy lands in the informative 60-90% band: for each signal it trains
the port's float32 model (``ptq_accuracy.train_our_model``, batch 64) and
reports the held-out top-1 on ``ptq_accuracy.gen_eval_sets``'s images,
one JSON line each with JAX's keys.  Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def probe(net, signal, *, train_steps, eval_images, proto_res, classes, lr,
          seed, device="cuda") -> float:
    """fp32 top-1 (%) of ``net`` trained on the task at ``signal``."""
    from cnns_slfp_quantization_tpu_torch.cli import ptq_accuracy as pa

    task = pa.task_params(net, signal=signal, classes=classes,
                          proto_res=proto_res)
    model = pa.train_our_model(
        net, train_steps=train_steps, batch_size=64,
        lr=lr if lr is not None else pa.DEFAULT_LR.get(net, 0.05),
        seed=seed, log_every=0, task=task, device=device)
    images, labels, _ = pa.gen_eval_sets(net, eval_images, 64, seed,
                                         task=task)
    preds = []
    with torch.no_grad():
        for i in range(0, len(images), 64):
            x = torch.from_numpy(images[i:i + 64]).to(device)
            preds.append(np.argmax(model(x).float().cpu().numpy(), -1))
    acc = 100.0 * float(np.mean(np.concatenate(preds) == labels))
    print(json.dumps({"net": net, "signal": signal,
                      "classes": task["classes"],
                      "proto_res": task["proto_res"],
                      "train_steps": train_steps, "fp32_top1": acc}),
          flush=True)
    return acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--net", required=True)
    ap.add_argument("--signals", type=float, nargs="+", required=True)
    ap.add_argument("--train_steps", type=int, default=300)
    ap.add_argument("--eval_images", type=int, default=1000)
    ap.add_argument("--proto_res", type=int, default=None)
    ap.add_argument("--classes", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    cfg = ap.parse_args(argv)
    from cnns_slfp_quantization_tpu_torch.utils import turns

    dev, card = turns.device(cfg.device)
    print(f"card: {card}", flush=True)
    for s in cfg.signals:
        probe(cfg.net, s, train_steps=cfg.train_steps,
              eval_images=cfg.eval_images, proto_res=cfg.proto_res,
              classes=cfg.classes, lr=cfg.lr, seed=cfg.seed,
              device=dev.type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
