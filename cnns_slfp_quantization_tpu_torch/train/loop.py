"""Training / evaluation steps and epoch loops (counterpart of the JAX
``train/loop.py``; reference cifar100_train_eval.py:162-211,
imgnet_train_eval.py:142-216): cross-entropy, top-1 / top-5, BatchNorm's
running statistics, samples/s.

Where JAX's ``TrainState`` is a pytree that each step returns anew, the
port keeps a :class:`TrainState` holding the model, the optimizer and the
step count, which each step updates in place.  Every step runs under
:func:`ops.backend.exact_f32`: cuDNN and the matmuls in full float32, so
that the backward's float32 cotangents are not cut to TF32.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch.ops.backend import exact_f32
from cnns_slfp_quantization_tpu_torch.ops.layers import Dropout


class TrainState:
    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    def state_dict(self) -> dict:
        """What ``--save_state`` saves: JAX's params, batch_stats,
        opt_state and step."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over integer labels (reference: nn.CrossEntropyLoss), as
    logsumexp minus the label's logit, in float32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return torch.mean(logz - ll)


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    has_dropout: bool = False) -> Callable:
    """``step(state, images, labels, generator=None) -> metrics``: one
    train-mode forward, CE, backward and optimizer step; ``metrics`` holds
    the ``loss`` and ``accuracy`` tensors (read them to synchronise).
    ``generator`` draws the dropout masks where the model has dropout."""
    drops = [m for m in model.modules() if isinstance(m, Dropout)] \
        if has_dropout else []

    def step(state: TrainState, images, labels, generator=None):
        for m in drops:
            m.generator = generator
        model.train()
        with exact_f32():
            logits = model(images)
            loss = cross_entropy(logits, labels)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
        state.step += 1
        acc = (torch.argmax(logits.detach(), -1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return step


def make_eval_step(model: torch.nn.Module) -> Callable:
    """``eval_step(images, labels) -> metrics``: top-1 / top-5 correct
    counts (imgnet_train_eval.py:199-204) in eval mode."""

    def eval_step(images, labels):
        model.eval()
        with torch.no_grad(), exact_f32():
            logits = model(images)
        top5 = torch.topk(logits, 5, dim=-1).indices
        correct1 = (torch.argmax(logits, -1) == labels).sum()
        correct5 = (top5 == labels[:, None]).any(dim=1).sum()
        return {"correct1": correct1, "correct5": correct5,
                "count": labels.shape[0]}

    return eval_step


def evaluate(eval_step, batches, max_images: Optional[int] = None) -> dict:
    """Accumulate top-1 / top-5 over an eval set (test(), cifar:196-211).

    ``max_images`` is an exact cap: a final partial batch is sliced so the
    reported image count never overshoots."""
    c1 = c5 = n = 0
    for images, labels in batches:
        if max_images is not None and n + images.shape[0] > max_images:
            keep = max_images - n
            images, labels = images[:keep], labels[:keep]
            if keep == 0:
                break
        m = eval_step(images, labels)
        c1 += int(m["correct1"])
        c5 += int(m["correct5"])
        n += int(m["count"])
        if max_images is not None and n >= max_images:
            break
    return {"top1": 100.0 * c1 / max(n, 1), "top5": 100.0 * c5 / max(n, 1),
            "images": n}


def step_generator(seed, i: int, device) -> torch.Generator:
    """The dropout generator of step ``i`` of a stream ``seed`` (a tuple of
    ints): the same on resume as in an uninterrupted run."""
    s = np.random.SeedSequence([*seed, i]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def train_epoch(train_step, state: TrainState, batches, seed=(0,), *,
                log_interval: int = 100, log_fn=print, epoch: int = 0,
                has_dropout: bool = False) -> TrainState:
    """One epoch (train(), cifar100_train_eval.py:162-191)."""
    t0 = time.time()
    seen = 0
    for i, (images, labels) in enumerate(batches):
        gen = (step_generator(seed, i, images.device) if has_dropout
               else None)
        metrics = train_step(state, images, labels, gen)
        seen += images.shape[0]
        if i % log_interval == 0:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            log_fn(f"epoch {epoch} step {i} cls_loss={loss:.5f} "
                   f"({seen / max(dt, 1e-9):.0f} samples/sec)")
    return state


def multistep_lr(base_lr: float, milestones=(75, 85, 100), gamma: float = 0.1,
                 steps_per_epoch: int = 1) -> Callable[[int], np.float32]:
    """MultiStepLR (cifar100_train_eval.py:154) as optax's
    ``piecewise_constant_schedule`` computes it in float32: from the count
    ``m * steps_per_epoch`` of each milestone on, ``v = f32(gamma) * v``."""
    bounds = sorted(int(m * steps_per_epoch) for m in milestones)
    v0, g = np.float32(base_lr), np.float32(gamma)

    def schedule(count: int) -> np.float32:
        v = v0
        for b in bounds:
            if count >= b:
                v = np.float32(g * v)
        return v

    return schedule
