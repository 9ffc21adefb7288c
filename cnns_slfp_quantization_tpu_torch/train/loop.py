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
from cnns_slfp_quantization_tpu_torch.utils import profiling

# a train step's phases, in stream order: forward and loss; zero_grad and
# backward; the optimizer's step
PHASES = ("train.forward", "train.backward", "train.optimizer")


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
    ``generator`` draws the dropout masks where the model has dropout.

    While spans record (``utils.profiling.on``) the step records
    ``train.step`` around its phases :data:`PHASES`: host spans on the CPU,
    device spans between CUDA events on the card.  Those events are the
    step's own (``step.phases``), recorded at every call under a CUDA
    graph's capture, so that each replay of the graph times its phases
    (``GraphedTrainStep``)."""
    drops = [m for m in model.modules() if isinstance(m, Dropout)] \
        if has_dropout else []
    phases = profiling.StepPhases(PHASES)

    def run(state, images, labels, generator, mark):
        for m in drops:
            m.generator = generator
        model.train()
        with exact_f32():
            if mark:
                mark(0)
            logits = model(images)
            loss = cross_entropy(logits, labels)
            if mark:
                mark(1)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if mark:
                mark(2)
            optimizer.step()
            if mark:
                mark(3)
        state.step += 1
        acc = (torch.argmax(logits.detach(), -1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    def step(state: TrainState, images, labels, generator=None):
        mark = phases.marker(images.is_cuda)
        if mark is None or not mark.step_span:
            return run(state, images, labels, generator, mark)
        with profiling.span("train.step"):
            return run(state, images, labels, generator, mark)

    step.phases = phases
    return step


class GraphedTrainStep:
    """``train_step`` (a :func:`make_train_step` step) captured once in a
    CUDA graph on ``images`` / ``labels``' shapes
    (``utils.profiling.capture``); each call copies its batch into the
    graph's inputs, writes the optimizer's learning rate at its count,
    replays the graph and advances the count and ``state.step``, as an
    eager step would.  It returns the step's metrics, tensors that the
    next call overwrites.  The eager step the capture runs first moves the
    state: the model's parameters and buffers, the optimizer's state and
    counters, ``state.step`` and ``generator`` go back in place before the
    capture, so that the replays continue from the state the caller gave,
    bit for bit as eager steps would.  ``launches``: the hand kernels'
    launches of one replay.  While spans record (``utils.profiling.on``) a
    call records ``train.step`` with its children ``train.copy_in``,
    ``train.ready`` and ``train.replay``, and the replay's device phases
    (the step's ``phases``), read at a later recorded call if the device
    has passed them (a replay still running then is not read: the next one
    records its events over) or when the spans are read.

    Dropout draws from ``generator``, registered with the graph: each
    replay advances it as an eager step drawing from it would, so replay
    i masks as eager step i on the same generator does (not as
    ``train_epoch``, which seeds a generator per step).  Refused, with the
    reason: an optimizer whose step reads host scalars (``capturable``
    False: Adam, RMSprop), a state under a mesh (its step reduces over
    gloo or NCCL and stays eager), a CPU batch, and a ``generator`` where
    this torch cannot register one with a graph."""

    def __init__(self, train_step: Callable, state: TrainState, images,
                 labels, generator=None):
        from cnns_slfp_quantization_tpu_torch.utils.profiling import capture

        opt = state.optimizer
        if not getattr(opt, "capturable", False):
            raise ValueError(
                f"{type(opt).__name__} reads host scalars in its step; a "
                f"CUDA graph takes QSGD (DSGD, SSGD, SGD): time it eagerly "
                f"(graph=False)")
        if getattr(state, "mesh", None) is not None:
            raise ValueError("a step under a mesh reduces over gloo or "
                             "NCCL, which a CUDA graph does not capture: it "
                             "runs eagerly (graph=False)")
        if not images.is_cuda:
            raise ValueError("a CUDA graph needs the batch on the card")
        if generator is not None and not hasattr(torch.cuda.CUDAGraph,
                                                 "register_generator_state"):
            raise RuntimeError(
                "this torch has no CUDAGraph.register_generator_state: a "
                "dropout step drawing from its own generator cannot be "
                "captured; time it eagerly (graph=False)")
        self.state = state
        self.phases = getattr(train_step, "phases", None)
        self.images, self.labels = images.clone(), labels.clone()
        saved = _snapshot(state, generator)
        self.graph, self.metrics, self.launches = capture(
            lambda: train_step(state, self.images, self.labels, generator),
            images.device, before=lambda: _restore(state, saved, generator),
            generator=generator)
        state.step = saved["step"]      # the capture ran no step

    def __call__(self, images, labels) -> dict:
        rec = profiling.on()
        with profiling.span_if(rec, "train.step"):
            if rec:
                profiling.poll()    # the last replay's phases, if passed
            with profiling.span_if(rec, "train.copy_in"):
                self.images.copy_(images)
                self.labels.copy_(labels)
            with profiling.span_if(rec, "train.ready"):
                self.state.optimizer.ready()
            with profiling.span_if(rec, "train.replay"):
                self.graph.replay()
            if rec and self.phases is not None:
                self.phases.pend()
            self.state.optimizer.count += 1
            self.state.step += 1
        return self.metrics


def _snapshot(state: TrainState, generator=None) -> dict:
    opt = state.optimizer
    return {
        "generator": None if generator is None else generator.get_state(),
        "model": {k: v.detach().clone() for k, v in
                  state.model.state_dict(keep_vars=True).items()},
        "opt": {p: {k: v.clone() for k, v in st.items()
                    if isinstance(v, torch.Tensor)}
                for p, st in opt.state.items()},
        "count": opt.count, "step": state.step,
        "stats": (None if getattr(opt, "stats", None) is None else
                  {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                   for k, v in opt.stats.items()})}


def _restore(state: TrainState, saved: dict, generator=None) -> None:
    """Put the tensors of ``saved`` back in place (a graph about to be
    captured reads these storages); optimizer state made since, zeros
    (QSGD starts a momentum buffer from zero)."""
    opt = state.optimizer
    if generator is not None:
        generator.set_state(saved["generator"])
    with torch.no_grad():
        for k, v in state.model.state_dict(keep_vars=True).items():
            v.copy_(saved["model"][k])
        for p, st in opt.state.items():
            for k, v in st.items():
                if not isinstance(v, torch.Tensor):
                    continue
                old = saved["opt"].get(p, {}).get(k)
                if old is None:
                    v.zero_()
                else:
                    v.copy_(old)
        for k, v in (saved["stats"] or {}).items():
            cur = opt.stats[k]
            if isinstance(cur, torch.Tensor):    # counters made since: 0
                cur.copy_(torch.as_tensor(v))
    opt.count, state.step = saved["count"], saved["step"]


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
