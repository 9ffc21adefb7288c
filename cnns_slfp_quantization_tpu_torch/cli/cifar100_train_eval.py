"""CIFAR-100 train/eval driver of the port (counterpart of the JAX
``cli/cifar100_train_eval.py``; reference cifar100_train_eval.py).

SLFP8 quantization-aware training with DSGD on the card:

    python -m cnns_slfp_quantization_tpu_torch.cli.cifar100_train_eval \\
        --Qbits 8 --net mobilenet --optimizer DSGD \\
        --compute_dtype bfloat16 --synthetic --retrain

``--device cpu`` runs it on the CPU (the kernels' plain versions).  Without
``--synthetic`` it reads CIFAR-100 (``--cifar 10``: CIFAR-10) from
``--data_dir`` in torchvision's layout (``cifar-100-python/{train,test}``;
``data/cifar.py``), ``--train_subset`` keeping a class-stratified fraction
of the train set.  ``--pre_reference`` calibrates the model over 1000 eval
images, writes ``max_inout_<net>.txt``, ``max_weight_<net>.txt`` and
``calib/<net>_calibrated.json`` under ``--root_dir`` and returns.  Nets:
shufflenetv2, shufflenetv2_swish, mobilenet, mobilenet_swish, vgg16,
vgg16_gelu (cifar100_train_eval.py:112-134).
"""

from __future__ import annotations

import argparse
import os

from cnns_slfp_quantization_tpu_torch.cli import common
from cnns_slfp_quantization_tpu_torch.data import cifar, synthetic


def make_parser():
    parser = argparse.ArgumentParser(
        description="SLFP reference and retrain, PyTorch/CUDA port")
    common.add_common_args(parser)
    parser.add_argument("--log_name", type=str, default="cifar-100")
    parser.add_argument("--cifar", type=int, default=100)
    parser.add_argument("--net", type=str, default="mobilenet")
    parser.add_argument("--ratio", type=float, default=1,
                        help="ShuffleNetV2 width ratio 0.5/1/1.5/2 "
                             "(reference shufflenet_v2.py:118-127)")
    parser.add_argument("--train_batch_size", type=int, default=256)
    parser.add_argument("--eval_batch_size", type=int, default=128)
    parser.add_argument("--max_epochs", type=int, default=1)
    return parser


def main(argv=None):
    cfg = make_parser().parse_args(argv)
    device = common.configure_runtime(cfg)
    log_dir = os.path.join(cfg.root_dir, "logs", cfg.log_name)
    ckpt_dir = os.path.join(cfg.root_dir, "ckpt", cfg.log_name)
    os.makedirs(log_dir, exist_ok=True)
    os.makedirs(ckpt_dir, exist_ok=True)

    # data (cifar100_train_eval.py:95-104)
    if cfg.synthetic:
        print("==> using synthetic data")
        train_batches = synthetic.SyntheticIterator(
            image_size=32, num_classes=cfg.cifar,
            batch_size=cfg.train_batch_size,
            num_batches=cfg.synthetic_batches or 20, seed=0)
        eval_batches = synthetic.SyntheticIterator(
            image_size=32, num_classes=cfg.cifar,
            batch_size=cfg.eval_batch_size, num_batches=8, seed=1)
    else:
        print("==> Preparing data ..")
        train_batches, eval_batches = cifar.make_iterators(
            cfg.data_dir, cfg.cifar, cfg.train_batch_size,
            cfg.eval_batch_size, train_subset=cfg.train_subset)

    print("=> creating model", cfg.net, "...")
    model = common.build_model(cfg, cfg.net, device)
    if cfg.pretrain:
        common.load_pretrained(cfg, model)

    if cfg.pre_reference:
        # cifar100_train_eval.py:279-301; ShuffleNetV2's constants divide by
        # 15 (reference shufflenet_v2.py:141)
        divisor = 15.0 if cfg.net.startswith("shufflenetv2") else 15.5
        common.run_calibration(cfg, model, cfg.net, eval_batches,
                               divisor=divisor)
        return

    return common.run_main_loop(
        cfg, model, train_batches, eval_batches, device=device,
        max_epochs=cfg.max_epochs, log_dir=log_dir,
        ckpt_path=os.path.join(ckpt_dir, f"{cfg.net}{cfg.num}_tmp"),
        steps_per_epoch=max(len(train_batches), 1),
        milestones=(75, 85, 100),  # cifar100_train_eval.py:154
        has_dropout=cfg.net.startswith("vgg16"),
    )


if __name__ == "__main__":
    main()
