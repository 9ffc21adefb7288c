"""The block-input quantize placements of the fused SLFP8 ResNet-50 on the
card (counterpart of JAX's ``tools/bench_blockin.py``).

    python3 -m cnns_slfp_quantization_tpu_torch.utils.bench_blockin \\
        [--batch 256] [--steps 16] [--modes consumer pallas_dual packed] \\
        [--size 224] [--device cuda|cpu]

Under JAX's placement (``policy={"conv1": "torch", "conv3": "torch",
"chain": frozenset()}``, where ``_diag_blockin_fuse`` applies), each mode
of ``resnet50_fused.BLOCKIN_FUSE`` serves the forward:

- ``consumer``: K3 writes the raw block output, K1 quantizes it for the
  next block;
- ``producer``: two K3 passes over the conv3 output, raw and quantized;
- ``pallas_dual`` (the executor's default): K3's dual form writes both in
  one pass;
- ``packed``: raw, then uint8 codes of it decoded back, which sends the
  pseudo-zero code to 0.0.

One JSON line per mode with its images/s (``profiling.scan_throughput``:
the forward as one CUDA graph, ``steps`` forwards, the fastest of three
runs after one), then JAX's guard: every mode's logits on the same batch
against ``consumer``'s (``outputs_bit_identical``, ``max_abs_delta``);
``pallas_dual`` must be bit-identical.  Weights from seed 1, shipped
scales, inputs from seed 0.  Prints the card's name and power limit
first; ``--device cpu`` times the host.
"""

from __future__ import annotations

import argparse
import json
import sys

POLICY = {"conv1": "torch", "conv3": "torch", "chain": frozenset()}


def engine(batch: int, size: int, dev):
    """The engine whose executor every mode serves through."""
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    return InferenceEngine("resnet", qbit=8, batch_size=batch,
                           image_size=size, policy=POLICY, seed=1,
                           device=dev.type)


def run(batch: int, modes, size: int, dev, steps: int) -> dict:
    """{"rows": [...], "guard": [...]}, each line printed as it comes."""
    import numpy as np
    import torch

    from cnns_slfp_quantization_tpu_torch.models import resnet50_fused as rf
    from cnns_slfp_quantization_tpu_torch.utils.profiling import (
        scan_throughput)

    eng = engine(batch, size, dev)
    x = torch.randn(batch, size, size, 3,
                    generator=torch.Generator().manual_seed(0)).to(dev)
    outs, rows = {}, []
    for mode in modes:
        def forward(xx, mode=mode):
            with torch.inference_mode():
                return rf.fused_apply(eng.executor, xx, policy=POLICY,
                                      _diag_blockin_fuse=mode)

        row = {"blockin_fuse": mode,
               "img_per_sec": scan_throughput(forward, x, steps=steps)}
        outs[mode] = forward(x).float().cpu().numpy()
        print(json.dumps(row), flush=True)
        rows.append(row)
    guard = []
    base = outs.get("consumer")
    for mode, got in outs.items():
        if base is None or mode == "consumer":
            continue
        g = {"mode": mode,
             "outputs_bit_identical": bool(np.array_equal(
                 base.view(np.uint32), got.view(np.uint32))),
             "max_abs_delta": float(np.max(np.abs(base - got)))}
        print(json.dumps(g), flush=True)
        guard.append(g)
    return {"rows": rows, "guard": guard}


def main(argv=None) -> int:
    from cnns_slfp_quantization_tpu_torch.models.resnet50_fused import (
        BLOCKIN_FUSE)

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--modes", nargs="+", choices=BLOCKIN_FUSE,
                    default=["consumer", "pallas_dual", "packed"])
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--device", default="cuda")
    cfg = ap.parse_args(argv)
    from cnns_slfp_quantization_tpu_torch.utils import turns

    dev, card = turns.device(cfg.device)
    print(f"card: {card}", flush=True)
    out = run(cfg.batch, cfg.modes, cfg.size, dev, cfg.steps)
    ok = all(g["outputs_bit_identical"] for g in out["guard"]
             if g["mode"] == "pallas_dual")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
