"""ImageNet-1k train/eval driver of the port (counterpart of the JAX
``cli/imgnet_train_eval.py``; reference imgnet_train_eval.py).

    python -m cnns_slfp_quantization_tpu_torch.cli.imgnet_train_eval \\
        --Qbits 8 --net resnet --pretrain --pretrain_dir resnet50.pth \\
        --data_dir /path/to/imagenet-1k [--all_validate]

``--data_dir`` holds torchvision's ImageFolder layout,
``{train,val}/<wnid>/*.JPEG`` (``data/imagenet.py``, PIL decodes); without
a ``val`` directory there, or with ``--synthetic``, the driver runs on
generated 224x224 images.  ``--all_validate`` switches from the 100-image
smoke eval to the whole validation set (:40, :182-185).
``--pre_reference`` calibrates over 1000 eval images and returns, as in
the CIFAR driver.  ``--device cpu`` runs it on the CPU (the kernels' plain
versions).  Nets: mobilenetv1, resnet, alexnet, squeezenet, inceptionv3
(imgnet_train_eval.py:92-114).
"""

from __future__ import annotations

import argparse
import os

from cnns_slfp_quantization_tpu_torch.cli import common
from cnns_slfp_quantization_tpu_torch.data import imagenet, synthetic


def make_parser():
    parser = argparse.ArgumentParser(
        description="SLFP train and finetune, PyTorch/CUDA port")
    common.add_common_args(parser)
    parser.add_argument("--log_name", type=str, default="imgnet-1k")
    parser.add_argument("--net", type=str, default="mobilenetv1")
    parser.add_argument("--all_validate", action="store_true", default=False)
    parser.add_argument("--train_batch_size", type=int, default=32)
    parser.add_argument("--eval_batch_size", type=int, default=16)
    parser.add_argument("--max_epochs", type=int, default=2)
    parser.set_defaults(data_dir="./data/imagenet-1k")
    return parser


def main(argv=None):
    cfg = make_parser().parse_args(argv)
    device = common.configure_runtime(cfg)
    log_dir = os.path.join(cfg.root_dir, "logs", cfg.log_name)
    ckpt_dir = os.path.join(cfg.root_dir, "ckpt", cfg.log_name)
    os.makedirs(log_dir, exist_ok=True)
    os.makedirs(ckpt_dir, exist_ok=True)

    if cfg.synthetic or not os.path.isdir(os.path.join(cfg.data_dir, "val")):
        print("==> using synthetic data")
        train_batches = synthetic.SyntheticIterator(
            image_size=224, num_classes=1000,
            batch_size=cfg.train_batch_size,
            num_batches=cfg.synthetic_batches or 10, seed=0)
        # enough eval batches to cover the 100-image smoke cap whatever
        # --eval_batch_size is (the cap slices exactly to 100)
        eval_n = max(8, -(-120 // cfg.eval_batch_size))
        eval_batches = synthetic.SyntheticIterator(
            image_size=224, num_classes=1000,
            batch_size=cfg.eval_batch_size, num_batches=eval_n, seed=1)
    else:
        train_batches = imagenet.ImageNetIterator(
            os.path.join(cfg.data_dir, "train"), cfg.train_batch_size,
            train=True, workers=cfg.num_workers,
            subset_fraction=cfg.train_subset)
        eval_batches = imagenet.ImageNetIterator(
            os.path.join(cfg.data_dir, "val"), cfg.eval_batch_size,
            train=False, workers=cfg.num_workers)

    print("=> creating model", cfg.net, "...")
    print(" learning rate = ", cfg.lr)
    model = common.build_model(cfg, cfg.net, device)
    if cfg.pretrain:
        common.load_pretrained(cfg, model)

    if cfg.pre_reference:
        common.run_calibration(cfg, model, cfg.net, eval_batches)
        return

    # imgnet_train_eval.py:182-185: 100-image smoke eval unless --all_validate
    return common.run_main_loop(
        cfg, model, train_batches, eval_batches, device=device,
        max_epochs=cfg.max_epochs, log_dir=log_dir,
        ckpt_path=os.path.join(ckpt_dir, f"{cfg.net}{cfg.num}_tmp"),
        steps_per_epoch=max(len(train_batches), 1),
        milestones=(10**9,),  # the reference's LR schedule is off (:137)
        eval_max_images=None if cfg.all_validate else 100,
        has_dropout=cfg.net in ("alexnet", "squeezenet", "inceptionv3"),
    )


if __name__ == "__main__":
    main()
