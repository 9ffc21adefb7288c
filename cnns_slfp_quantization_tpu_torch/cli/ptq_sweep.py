"""PTQ bit-width sweep: evaluate one net at FP32 / SLFP8 / SFP7 in one run
(counterpart of the JAX ``cli/ptq_sweep.py``).

One set of weights (built at qbit 32 from seed 0, or ``--pretrain_dir``:
a reference ``.pth`` or a checkpoint of the port) is evaluated at each of
``--qbits``, top-1 / top-5, with the deltas against FP32 (the reference's
<1% PTQ-loss claim, README.md:11):

    python -m cnns_slfp_quantization_tpu_torch.cli.ptq_sweep \\
        --net alexnet --dataset imgnet --pretrain_dir ckpt/alexnet.pth \\
        --data_dir /path/to/imagenet-1k --compute_dtype bfloat16

``--dataset cifar`` reads ``--data_dir`` as the CIFAR driver does;
``--synthetic`` (or an ImageNet ``--data_dir`` without ``val``) runs on 8
generated batches.  At ``--compute_dtype bfloat16`` each quantized layer's
input goes through K1 on the card.
"""

from __future__ import annotations

import argparse
import json
import os

from cnns_slfp_quantization_tpu_torch import models
from cnns_slfp_quantization_tpu_torch.cli import common
from cnns_slfp_quantization_tpu_torch.data import synthetic
from cnns_slfp_quantization_tpu_torch.train import loop


def make_parser():
    p = argparse.ArgumentParser(
        description="PTQ bit-width sweep, PyTorch/CUDA port")
    common.add_common_args(p)
    p.add_argument("--net", type=str, default="alexnet")
    p.add_argument("--dataset", choices=["cifar", "imgnet"], default="imgnet")
    p.add_argument("--qbits", type=int, nargs="+", default=[32, 8, 7])
    p.add_argument("--eval_batch_size", type=int, default=32)
    p.add_argument("--max_images", type=int, default=None)
    return p


def main(argv=None):
    cfg = make_parser().parse_args(argv)
    device = common.configure_runtime(cfg)

    size = models.INPUT_SIZE[cfg.dataset]
    classes = 100 if cfg.dataset == "cifar" else 1000

    def batches():
        if cfg.synthetic or cfg.dataset == "imgnet" and not os.path.isdir(
                os.path.join(cfg.data_dir, "val")):
            return synthetic.SyntheticIterator(
                image_size=size, num_classes=classes,
                batch_size=cfg.eval_batch_size, num_batches=8, seed=1)
        if cfg.dataset == "cifar":
            from cnns_slfp_quantization_tpu_torch.data import cifar

            _, ev = cifar.make_iterators(cfg.data_dir, classes,
                                         cfg.eval_batch_size,
                                         cfg.eval_batch_size)
            return ev
        from cnns_slfp_quantization_tpu_torch.data import imagenet

        return imagenet.ImageNetIterator(
            os.path.join(cfg.data_dir, "val"), cfg.eval_batch_size,
            train=False, workers=cfg.num_workers)

    # one weight set shared across bit widths (PTQ: quantize the frozen
    # net), built at qbit 32
    base_cfg = argparse.Namespace(**vars(cfg))
    base_cfg.Qbits = 32
    weights = common.build_model(base_cfg, cfg.net, device, size)
    if cfg.pretrain or cfg.pretrain_dir:
        common.load_pretrained(cfg, weights)
    weights = weights.state_dict()

    results = {}
    for qbit in cfg.qbits:
        q_cfg = argparse.Namespace(**vars(cfg))
        q_cfg.Qbits = qbit
        model = common.build_model(q_cfg, cfg.net, device, size)
        model.load_state_dict(weights)
        metrics = loop.evaluate(loop.make_eval_step(model),
                                common.DeviceBatches(batches(), device),
                                max_images=cfg.max_images)
        results[qbit] = metrics
        print(f"Qbits={qbit}: top1={metrics['top1']:.2f}% "
              f"top5={metrics['top5']:.2f}% ({metrics['images']} images)")

    if 32 in results:
        for qbit in cfg.qbits:
            if qbit != 32:
                d1 = results[32]["top1"] - results[qbit]["top1"]
                print(f"PTQ top-1 loss @ Qbits={qbit}: {d1:+.2f}%")
    print(json.dumps({str(k): v for k, v in results.items()}))
    return results


if __name__ == "__main__":
    main()
