"""The DSGD SLFP8 QAT step's cost by quantize class on the card
(counterpart of JAX's ``tools/bench_train_sites.py``).

    python3 -m cnns_slfp_quantization_tpu_torch.utils.bench_train_sites \\
        [--nets resnet mobilenet] [--steps 8] [--batch B] [--size S] \\
        [--device cuda|cpu]

The reference's QAT step quantizes (a) every layer input, (b) every weight
and (c) every parameter twice in the optimizer (Q(p) and Q(p + delta1)).
Each class is priced by a variant of the step with the same shapes and,
on purpose, other numbers:

  prod       qbit-8 model, DSGD                                  (baseline)
  opt_noq    DSGD whose rescale compares the raw update (:class:`DSGDNoQ`,
             JAX's ``_dsgd_noq``): no quantize in the optimizer       (c)
  opt_sgd    plain momentum SGD (no rescale at all)              (c)+where
  fwd_nowq   the weights frozen as Q(w/Kw) values (``ops.freeze.
             prequantize``), still trained: no weight quantize       (b)
  fwd_none   qbit-32 model (no forward quantize), DSGD q8        (a)+(b)

Nets and shapes are JAX's: ``resnet`` at 224, batch 64, 1000 classes;
CIFAR ``mobilenet`` at 32, batch 256, 100 classes (``--batch`` /
``--size`` override both).  Each variant is timed with
``profiling.scan_train_throughput``: on the card the whole step as one
CUDA graph replayed per step, the fastest of three runs of ``steps`` steps
after one.  On the card each variant's replay is first held bit for bit
against an eager step from the same state (loss, weights, momentum, BN
statistics), and its idle share is read from a replay's trace
(``profiling.busy_ms``).  One JSON line per net with JAX's keys
(``img_per_sec``, ``step_ms``, ``cost_ms``: ``optimizer_2x_quantize`` =
prod - opt_noq, ``fwd_weight_quantize`` = prod - fwd_nowq,
``fwd_act_quantize`` = fwd_nowq - fwd_none), the checks and each
variant's hand-kernel launches in one eager step.  Prints the card's name
and power limit first; ``--device cpu`` times the host.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch.train import optimizers

NETS = {"resnet": (64, 224, 1000), "mobilenet": (256, 32, 100)}
VARIANTS = ("prod", "opt_noq", "opt_sgd", "fwd_nowq", "fwd_none")
LR = 0.01


class DSGDNoQ(optimizers.QSGD):
    """DSGD with its control flow kept and both quantizes taken out (JAX
    ``tools/bench_train_sites.py::_dsgd_noq``): the extra step's scale is
    2 where the raw update ``|delta1|`` is below the tolerance, else 0."""

    def __init__(self, params, lr, qbit: int = 8):
        super().__init__(params, lr, qbit, "dsgd", 0.9, 0.0, 5e-4, False)

    def _scale(self, p, d1):
        scale = torch.where(d1.abs() < np.float32(self.tol),
                            self._const(2.0, p.device),
                            self._const(0.0, p.device))
        return scale, 1.0 + scale


def variant(name: str, kind: str, batch: int, size: int, dev):
    """(TrainState, step) of one variant, weights from seed 2."""
    from cnns_slfp_quantization_tpu_torch import models
    from cnns_slfp_quantization_tpu_torch.ops import freeze
    from cnns_slfp_quantization_tpu_torch.train import loop

    qbit = 32 if kind == "fwd_none" else 8
    model = models.create_model(
        name, qbit, compute_dtype=torch.bfloat16, image_size=size,
        generator=torch.Generator().manual_seed(2))
    if kind == "fwd_nowq":
        freeze.prequantize(model)
        for _, layer in freeze.quant_layers(model):
            layer.weight.requires_grad_(True)    # still trained, as in JAX
    model.to(dev)
    params = model.parameters()
    opt = (DSGDNoQ(params, LR) if kind == "opt_noq"
           else optimizers.sgd(params, LR) if kind == "opt_sgd"
           else optimizers.dsgd(params, LR, 8))
    return loop.TrainState(model, opt), loop.make_train_step(model, opt)


def _bits(tensors) -> bytes:
    return b"".join(t.detach().reshape(-1).contiguous().view(torch.uint8)
                    .cpu().numpy().tobytes() for t in tensors)


def replay_is_eager(name: str, kind: str, batch: int, size: int, dev, x,
                    y) -> tuple:
    """(equal, launches): whether one replay of the variant's captured step
    gives an eager step's loss, weights, momentum and BN statistics bit for
    bit, each from the seed's state; and {wrapper: launches} of that eager
    step, the counts set to 0 just before it."""
    from cnns_slfp_quantization_tpu_torch import kernels
    from cnns_slfp_quantization_tpu_torch.train import loop

    got = {}
    for mode in ("eager", "graph"):
        st, step = variant(name, kind, batch, size, dev)
        if mode == "graph":
            loss = loop.GraphedTrainStep(step, st, x, y)(x, y)["loss"]
        else:
            kernels.reset_launches()
            loss = step(st, x, y)["loss"]
            launches = {k: n for k, n in kernels.launches().items() if n}
        torch.cuda.synchronize()
        opt = st.optimizer
        got[mode] = (_bits([loss]), _bits(st.model.parameters()),
                     _bits(opt.state[p]["momentum"]
                           for p in st.model.parameters()
                           if "momentum" in opt.state[p]),
                     _bits(b for n, b in st.model.named_buffers()
                           if "running" in n))
        del st, step
    return got["eager"] == got["graph"], launches


def measure(name: str, kind: str, batch: int, size: int, classes: int, dev,
            steps: int = 8) -> dict:
    """{"img_per_sec", "bit_equal", "idle", "launches"} of one variant
    (``launches``: an eager step's, on the card)."""
    from cnns_slfp_quantization_tpu_torch.train import loop
    from cnns_slfp_quantization_tpu_torch.utils import profiling

    x = torch.randn(batch, size, size, 3,
                    generator=torch.Generator().manual_seed(0)).to(dev)
    y = torch.randint(0, classes, (batch,),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    out = {"bit_equal": None, "idle": None, "launches": None}
    if dev.type == "cuda":
        out["bit_equal"], out["launches"] = replay_is_eager(
            name, kind, batch, size, dev, x, y)
    state, step = variant(name, kind, batch, size, dev)
    out["img_per_sec"] = profiling.scan_train_throughput(step, state, x, y,
                                                         steps=steps)
    if dev.type == "cuda":
        g = loop.GraphedTrainStep(step, state, x, y)
        wall, busy, _, _ = profiling.busy_ms(lambda: g(x, y))
        out["idle"] = None if busy is None else 1 - busy / wall
        del g
    del state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run_net(name: str, *, batch: int, size: int, n_classes: int, dev,
            steps: int = 8, card: str = "") -> dict:
    """One net's JSON line (printed and returned)."""
    rows = {k: measure(name, k, batch, size, n_classes, dev, steps)
            for k in VARIANTS}
    ips = {k: r["img_per_sec"] for k, r in rows.items()}

    def ms(v):
        return batch / v * 1e3

    out = {
        "net": name, "batch": batch, "size": size, "card": card,
        "img_per_sec": ips,
        "step_ms": {k: ms(v) for k, v in ips.items()},
        "cost_ms": {
            "optimizer_2x_quantize": ms(ips["prod"]) - ms(ips["opt_noq"]),
            "fwd_weight_quantize": ms(ips["prod"]) - ms(ips["fwd_nowq"]),
            "fwd_act_quantize": ms(ips["fwd_nowq"]) - ms(ips["fwd_none"]),
        },
        "replay_bit_equal_to_eager": {k: r["bit_equal"]
                                      for k, r in rows.items()},
        "idle_share": {k: r["idle"] for k, r in rows.items()},
        "eager_step_launches": {k: r["launches"] for k, r in rows.items()},
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nets", nargs="+", default=list(NETS),
                    choices=list(NETS))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=None,
                    help="default: JAX's per net (resnet 64, mobilenet 256)")
    ap.add_argument("--size", type=int, default=None,
                    help="default: JAX's per net (resnet 224, mobilenet 32)")
    ap.add_argument("--device", default="cuda")
    cfg = ap.parse_args(argv)
    from cnns_slfp_quantization_tpu_torch.utils import turns

    dev, card = turns.device(cfg.device)
    print(f"card: {card}", flush=True)
    ok = True
    for name in cfg.nets:
        batch, size, classes = NETS[name]
        out = run_net(name, batch=cfg.batch or batch, size=cfg.size or size,
                      n_classes=classes, dev=dev, steps=cfg.steps, card=card)
        ok &= all(v is not False
                  for v in out["replay_bit_equal_to_eager"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
