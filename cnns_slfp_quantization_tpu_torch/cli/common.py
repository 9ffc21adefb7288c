"""Shared CLI engine for the port's drivers (counterpart of the JAX
``cli/common.py``).

The reference drivers' control flow (cifar100_train_eval.py:84-322): data
-> model -> optimizer -> epoch loop of train / test -> best-checkpoint
save, with JAX's flags and its divergences from the reference (no stale
``optimizer.step()`` before each epoch; ``>=`` for the best checkpoint;
``--save_state`` / ``--resume`` with a ``.meta.json`` sidecar).

``--device`` (default ``cuda``; ``--use_gpu`` names the index) is where the
model, the batches and the optimizer state live; ``cuda`` without a card
raises.  ``--pre_reference`` calibrates (:func:`run_calibration`) and
returns.  Not ported yet, and raising ``NotImplementedError`` with their
ROADMAP item: ``--mesh_data`` / ``--mesh_model`` (Queue 1 item 9).
"""

from __future__ import annotations

import json
import os
import time
import warnings

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch import calib, models
from cnns_slfp_quantization_tpu_torch.calib import calibrate as calibrate_lib
from cnns_slfp_quantization_tpu_torch.train import checkpoint, loop, optimizers
from cnns_slfp_quantization_tpu_torch.utils.logging import MetricLogger


def add_common_args(parser):
    parser.add_argument("--root_dir", type=str, default="./")
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--retrain", action="store_true", default=False)
    parser.add_argument("--save_model", action="store_true", default=False)
    parser.add_argument("--pre_reference", action="store_true", default=False)
    parser.add_argument("--pretrain", action="store_true", default=False)
    parser.add_argument("--pretrain_dir", type=str, default=None,
                        help="a reference .pth or a checkpoint of the port")
    parser.add_argument("--optimizer", type=str, default="SGD")
    parser.add_argument("--Qbits", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--wd", type=float, default=5e-4)
    parser.add_argument("--num", type=int, default=0)
    parser.add_argument("--log_interval", type=int, default=100)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--synthetic", action="store_true", default=False,
                        help="use generated data (no dataset needed)")
    parser.add_argument("--synthetic_batches", type=int, default=None,
                        help="train batches per epoch under --synthetic "
                             "(default: 20 cifar)")
    parser.add_argument("--train_subset", type=float, default=1.0,
                        help="class-stratified fraction of the train set")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="conv/matmul operand type (bfloat16 values, "
                             "float32 sums)")
    parser.add_argument("--mesh_data", type=int, default=0,
                        help="data-parallel mesh size (0 = single device)")
    parser.add_argument("--mesh_model", type=int, default=1,
                        help="tensor-parallel mesh size")
    parser.add_argument("--resume", type=str, default=None,
                        help="resume the full train state (model, "
                             "optimizer, step) from a --save_state file")
    parser.add_argument("--save_state", action="store_true", default=False,
                        help="checkpoint the full train state each epoch")
    parser.add_argument("--debug_nans", action="store_true", default=False,
                        help="torch.autograd anomaly detection")
    # JAX's persistent compilation cache: PyTorch runs eagerly and compiles
    # nothing, so the flag is accepted for CLI parity and ignored
    parser.add_argument("--jax_cache", type=str, default="")
    parser.add_argument("--use_gpu", type=str, default="0",
                        help="CUDA device index under --device cuda")
    parser.add_argument("--cluster", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])


def configure_runtime(cfg) -> torch.device:
    """The run's device (raising without a card under ``cuda``) and the
    flags: ``--debug_nans`` turns on autograd's anomaly detection; the
    unported mesh flags raise here, before anything is built."""
    if cfg.mesh_data or cfg.mesh_model > 1:
        raise NotImplementedError(
            "--mesh_data / --mesh_model: the port has no mesh yet (ROADMAP "
            "Queue 1 item 9)")
    if cfg.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if cfg.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu "
                           "to run on the CPU")
    return torch.device(f"cuda:{int(cfg.use_gpu)}")


def build_model(cfg, net: str, device: torch.device, image_size=None):
    """The model, its weights from a seeded generator (flax's init RNG
    cannot be reproduced: parity with JAX goes through
    ``checkpoint.load_jax_variables``); ``image_size`` sets AlexNet's fc1
    width (flax infers it from the input)."""
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    model = models.create_model(net, cfg.Qbits, compute_dtype=compute_dtype,
                                ratio=getattr(cfg, "ratio", 1),
                                image_size=image_size,
                                generator=torch.Generator().manual_seed(0))
    return model.to(device)


def load_pretrained(cfg, model):
    """``--pretrain_dir``: a reference ``.pth`` (positional import) or a
    checkpoint of the port (its ``model`` entry)."""
    path = cfg.pretrain_dir
    if path is None:
        return model
    if str(path).endswith(".pth"):
        checkpoint.load_jax_variables(model, checkpoint.load_pth(path, model))
    else:
        model.load_state_dict(checkpoint.restore(path)["model"])
    return model


def run_calibration(cfg, model, net, eval_batches, divisor=15.5,
                    total_images=1000):
    """``--pre_reference``: run ``model``'s weights through a float32
    capture model of the same net (JAX's ``calib_model``: ``--Qbits``, no
    compute dtype, ``capture="absmax"``) over ``total_images`` eval images
    and write ``max_inout_<net>.txt`` / ``max_weight_<net>.txt``
    (cifar100_train_eval.py:279-301; JAX's format, ``str`` of each float32
    maximum) and ``calib/<net>_calibrated.json`` under ``--root_dir``,
    never into the package."""
    cap = models.create_model(net, cfg.Qbits, capture="absmax",
                              ratio=getattr(cfg, "ratio", 1))
    cap.load_state_dict(model.state_dict())
    cap.to(next(model.parameters()).device)
    result = calibrate_lib.calibrate(cap, eval_batches,
                                     max_images=total_images)
    out_root = cfg.root_dir or "."
    os.makedirs(out_root, exist_ok=True)
    with open(os.path.join(out_root, f"max_inout_{net}.txt"), "w") as f:
        for idx in sorted(result.input_absmax):
            f.write(f"Layer {idx} Max Absolute Input:\n")
            f.write(str(result.input_absmax[idx]) + "\n\n")
        for idx in sorted(result.output_absmax):
            f.write(f"Layer {idx} Max Absolute Output:\n")
            f.write(str(result.output_absmax[idx]) + "\n\n")
    with open(os.path.join(out_root, f"max_weight_{net}.txt"), "w") as f:
        for idx in sorted(result.weight_absmax):
            f.write(f"Layer {idx} Max Absolute weight:\n")
            f.write(str(result.weight_absmax[idx]) + "\n\n")
    calib.save_scales(f"{net}_calibrated", result.ka_max(), result.kw_max(),
                      divisor, out_dir=os.path.join(out_root, "calib"))
    print(f"Results saved to max_weight_{net}.txt")
    return result


def _state_meta_path(state_path: str) -> str:
    """Sidecar for the loop state outside the checkpoint (epoch alignment
    and best accuracy)."""
    return str(state_path).rstrip("/") + ".meta.json"


class DeviceBatches:
    """Re-iterable stream of numpy ``(images, labels)`` batches as tensors on
    ``device`` (labels int64)."""

    def __init__(self, batches, device):
        self._batches = batches
        self._device = device

    def __len__(self):
        return len(self._batches)

    def __iter__(self):
        for images, labels in self._batches:
            yield (torch.from_numpy(np.ascontiguousarray(images)).to(
                       self._device, non_blocking=True),
                   torch.from_numpy(np.asarray(labels, np.int64)).to(
                       self._device, non_blocking=True))


def run_main_loop(cfg, model, train_batches, eval_batches, *, device,
                  max_epochs, log_dir, ckpt_path, steps_per_epoch,
                  milestones=(75, 85, 100), eval_max_images=None,
                  has_dropout=False):
    """Epoch loop (cifar100_train_eval.py:303-320); returns the train state
    and the accuracy of each epoch."""
    logger = MetricLogger(log_dir)
    train_batches = DeviceBatches(train_batches, device)
    eval_batches = DeviceBatches(eval_batches, device)
    lr_sched = loop.multistep_lr(cfg.lr, milestones, 0.1, steps_per_epoch)
    opt = optimizers.create_optimizer(cfg.optimizer, model.parameters(),
                                      lr_sched, cfg.Qbits,
                                      weight_decay=cfg.wd)
    state = loop.TrainState(model, opt)
    resumed_meta = {}
    if cfg.resume:
        # restart-based recovery: the full train state (weights, BN
        # statistics, optimizer momentum and count, step)
        state.load_state_dict(checkpoint.restore(cfg.resume))
        print(f"==> resumed train state from {cfg.resume} "
              f"(step {state.step})")
        meta_path = _state_meta_path(cfg.resume)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                resumed_meta = json.load(f)
            if resumed_meta.get("steps_per_epoch") not in (
                    None, steps_per_epoch):
                warnings.warn(
                    f"--resume: checkpoint was saved with steps_per_epoch="
                    f"{resumed_meta['steps_per_epoch']} but this run has "
                    f"{steps_per_epoch}; epoch numbering, the per-epoch RNG "
                    f"stream and the multistep LR schedule will not line up "
                    f"with the original run", stacklevel=2)
    train_step = loop.make_train_step(model, opt, has_dropout)
    eval_step = loop.make_eval_step(model)

    acc_data, acc_max = [], float(resumed_meta.get("acc_max", 0.0))
    # resume continues the epoch numbering from the restored step, so the
    # per-epoch dropout stream matches an uninterrupted run
    start_epoch = state.step // max(steps_per_epoch, 1)
    for epoch in range(start_epoch, max_epochs):
        if cfg.retrain:
            t0 = time.time()
            loop.train_epoch(train_step, state, train_batches,
                             (cfg.num, epoch), log_interval=cfg.log_interval,
                             epoch=epoch, has_dropout=has_dropout)
            logger.scalar("epoch_time", time.time() - t0, epoch)
        metrics = loop.evaluate(eval_step, eval_batches,
                                max_images=eval_max_images)
        acc = metrics["top1"]
        acc_data.append(acc)
        print(f"------ Precision@1: {acc:.2f}%  Precision@5: "
              f"{metrics['top5']:.2f}%  ({metrics['images']} images)")
        logger.scalar("Precision@1", acc, epoch)
        logger.scalar("Precision@5", metrics["top5"], epoch)
        # >= (not the reference's strict >): a first epoch at exactly 0.00%
        # must still leave a best checkpoint under --save_model
        if cfg.save_model and acc >= acc_max:
            acc_max = acc
            checkpoint.save(ckpt_path, {"model": model.state_dict()})
            print(f"max acc : {acc_max}\nsaving model....")
        if cfg.save_state:
            state_path = ckpt_path + "_state"
            checkpoint.save(state_path, state.state_dict())
            with open(_state_meta_path(state_path), "w") as f:
                json.dump({"steps_per_epoch": steps_per_epoch,
                           "acc_max": acc_max, "epoch": epoch}, f)
    logger.close()
    return state, acc_data
