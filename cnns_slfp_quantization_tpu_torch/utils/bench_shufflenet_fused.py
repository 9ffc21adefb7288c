"""The fused SLFP8 ShuffleNetV2 executor against its module path on the
card (counterpart of JAX's ``tools/bench_shufflenet_fused.py``).

    python3 -m cnns_slfp_quantization_tpu_torch.utils.bench_shufflenet_fused \\
        [--batch 256] [--steps 8] [--device cuda|cpu]

CIFAR ShuffleNetV2 at 32x32: the bf16 frozen module path
(``InferenceEngine(..., fused=False, use_pallas=False)``) and the
BN-folded fused executor (``fused=True``) on the same weights (seed 1)
and scales (shipped), first JAX's gate on 16 random inputs (seed 0): the
logits' cosine and the share of equal top-1 (JAX's keys), held to JAX's
bar for the two (``tests/test_shufflenet_fused.py``: cosine > 0.98, the
same top-1 on every row whose top-2 margin exceeds three times the
largest difference); then each one's images/s (``throughput(steps)``,
the engine's CUDA graph).  Prints the card's name and power limit first;
``--device cpu`` times the host.
"""

from __future__ import annotations

import argparse
import json
import sys

GATE_ROWS = 16


def gate(module, fused, xs) -> dict:
    """JAX's gate between two engines' eager forwards on ``xs``, with its
    test's bar (``passed``)."""
    import numpy as np
    import torch

    with torch.inference_mode():
        want = module._eager(xs).float().cpu().numpy()
        got = fused._eager(xs).float().cpu().numpy()
    cos = float(np.sum(got * want)
                / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-30))
    diff = float(np.abs(got - want).max())
    top2 = np.sort(want, axis=-1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 3 * diff
    same = np.argmax(got, -1) == np.argmax(want, -1)
    return {"gate": "fused-vs-module", "cos": cos,
            "top1_match": float(np.mean(same)),
            "decisive_rows": int(decisive.sum()),
            "passed": bool(cos > 0.98 and same[decisive].all())}


def main(argv=None, scales=None) -> int:
    """``scales``: a ``calib.ScaleSet`` in place of the shipped one."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    cfg = ap.parse_args(argv)
    import torch

    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
    from cnns_slfp_quantization_tpu_torch.utils import turns

    dev, card = turns.device(cfg.device)
    print(f"card: {card}", flush=True)
    kw = dict(qbit=8, batch_size=cfg.batch, seed=1, scales=scales,
              device=dev.type)
    module = InferenceEngine("shufflenetv2", fused=False, use_pallas=False,
                             **kw)
    fused = InferenceEngine("shufflenetv2", fused=True, **kw)
    x = torch.randn(GATE_ROWS, 32, 32, 3,
                    generator=torch.Generator().manual_seed(0)).to(dev)
    g = gate(module, fused, x)
    print(json.dumps(g), flush=True)
    for name, eng in (("module_bf16_frozen", module), ("fused", fused)):
        print(json.dumps({"config": name, "img_per_sec":
                          eng.throughput(cfg.steps)}),
              flush=True)
    return 0 if g["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
