"""Float against packed weights in the fused SLFP8 ResNet-50 on the card
(counterpart of JAX's ``tools/bench_packed.py``).

    python3 -m cnns_slfp_quantization_tpu_torch.utils.bench_packed \\
        [--batches 8 32 256] [--steps 16] \\
        [--configs float packed-torch packed-kernel] [--size 224] \\
        [--device cuda|cpu]

Configurations (JAX's ``float``, ``packed-xla``, ``packed-pallas``), all
under JAX's placement (no K6):

  float          bf16 frozen weights, conv1 / conv3 as plain f32 matmuls
                 (``policy={"conv1": "torch", "conv3": "torch"}``)
  packed-torch   uint8 SLFP codes decoded before those matmuls (each
                 forward); the 3x3 convs' weights decoded once, at prepare
  packed-kernel  uint8 codes decoded inside K2 for conv1 and conv3

Each batch prints one JSON line: images/s of each configuration as
``InferenceEngine.throughput`` times its engine (the executor's forward as
one CUDA graph, ``profiling.scan_throughput``, on zeros perturbed per
forward: ``steps`` forwards, the fastest of three runs after one), the
float and packed executors each prepared once.  Weights from seed 1,
shipped scales.  Prints the card's name and power limit first;
``--device cpu`` times the host.
"""

from __future__ import annotations

import argparse
import json
import sys

TORCH = {"conv1": "torch", "conv3": "torch", "chain": frozenset()}
KERNEL = {"conv1": "kernel", "conv3": "kernel", "chain": frozenset()}
CONFIGS = {"float": (False, TORCH), "packed-torch": (True, TORCH),
           "packed-kernel": (True, KERNEL)}


def engines(size: int, dev) -> dict:
    """{packed: an engine}: the float-frozen and the packed executors."""
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    return {packed: InferenceEngine("resnet", qbit=8, image_size=size,
                                    pack_weights=packed, seed=1,
                                    device=dev.type)
            for packed in (False, True)}


def measure(engs: dict, batch: int, config: str, size: int, dev,
            steps: int) -> float:
    """Images/s of one configuration at one batch."""
    import torch

    from cnns_slfp_quantization_tpu_torch.models import resnet50_fused as rf
    from cnns_slfp_quantization_tpu_torch.utils.profiling import (
        scan_throughput)

    packed, policy = CONFIGS[config]
    fw = engs[packed].executor
    x = torch.zeros(batch, size, size, 3, device=dev)
    return scan_throughput(lambda xx: rf.fused_apply(fw, xx, policy=policy),
                           x, steps=steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 32, 256])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS),
                    choices=list(CONFIGS))
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--device", default="cuda")
    cfg = ap.parse_args(argv)
    from cnns_slfp_quantization_tpu_torch.utils import turns

    dev, card = turns.device(cfg.device)
    print(f"card: {card}", flush=True)
    engs = engines(cfg.size, dev)
    for batch in cfg.batches:
        row = {"batch": batch}
        for name in cfg.configs:
            row[name] = measure(engs, batch, name, cfg.size, dev, cfg.steps)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
