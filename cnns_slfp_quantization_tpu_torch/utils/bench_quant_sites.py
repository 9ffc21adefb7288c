"""The price of each activation-quantize site of the fused ResNet-50
executor on the card (counterpart of JAX's ``tools/bench_quant_sites.py``).

    python3 -m cnns_slfp_quantization_tpu_torch.utils.bench_quant_sites \\
        [--batch 64 256] [--steps 16]

For each batch and each placement (``default``: the port's policy, K6 on
stages 2 and 3; ``jax``: JAX's, conv1 / conv3 as plain matmuls and no K6)
it serves the forward with every quantize site on (production), with each
site removed (``fused_apply(..., _diag_quant_sites=...)``: wrong numbers on
purpose, the same shapes) and with none (the ceiling).  Each configuration
runs one forward first, whose logits must be finite and, for the
production one, bit-equal to the engine's forward without the keyword, and
whose hand-kernel launches are counted; then images/s from
``profiling.scan_throughput`` (the forward as one CUDA graph replayed per
step, the fastest of three runs of ``steps`` forwards).  One JSON line per
configuration: case, batch, config, images/s, its ratio to production, the
launches, and the two checks.  Random weights from seed 0 (the engine's),
the shipped scales, inputs from seed 0.  Prints the card's name and power
limit first.  Needs a CUDA device and nvcc; a measuring tool, not part of
the serving path.
"""

from __future__ import annotations

import argparse
import json
import sys

CASES = {"default": None,
         "jax": {"conv1": "torch", "conv3": "torch", "chain": frozenset()}}


def configs():
    """(label, ``_diag_quant_sites``): all, each site removed, none."""
    from cnns_slfp_quantization_tpu_torch.models.resnet50_fused import (
        QUANT_SITES)

    yield "all", None
    for site in sorted(QUANT_SITES):
        yield f"without {site}", QUANT_SITES - {site}
    yield "none (ceiling)", frozenset()


def measure(batch: int, case: str, steps: int = 16) -> list:
    """The rows of one case at one batch, each printed as it comes."""
    import torch

    from cnns_slfp_quantization_tpu_torch import kernels
    from cnns_slfp_quantization_tpu_torch.models import resnet50_fused as rf
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine
    from cnns_slfp_quantization_tpu_torch.utils.profiling import (
        scan_throughput)

    eng = InferenceEngine("resnet", qbit=8, batch_size=batch,
                          image_size=224, seed=0, policy=CASES[case])
    x = torch.randn((batch, 224, 224, 3), generator=torch.Generator()
                    .manual_seed(0)).to(eng.device)
    production = eng.forward(x)
    rows = []
    for label, sites in configs():
        def forward(xx, sites=sites):
            with torch.inference_mode():
                return rf.fused_apply(eng.executor, xx, policy=eng.policy,
                                      _diag_quant_sites=sites)

        forward(x)
        torch.cuda.synchronize()
        kernels.reset_launches()
        y = forward(x)
        torch.cuda.synchronize()
        launches = {k: n for k, n in kernels.launches().items() if n}
        row = {"case": case, "batch": batch, "config": label,
               "img_per_sec": scan_throughput(forward, x, steps=steps),
               "launches": launches,
               "finite": bool(torch.isfinite(y.float()).all())}
        if sites is None:
            row["bit_equal_to_default"] = bool(torch.equal(
                y.view(torch.int16), production.view(torch.int16)))
        row["vs_all"] = row["img_per_sec"] / (rows[0]["img_per_sec"]
                                              if rows else row["img_per_sec"])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--steps", type=int, default=16)
    cfg = ap.parse_args(argv)
    from cnns_slfp_quantization_tpu_torch.utils import turns

    card = turns.card()
    if card is None:
        return 2
    print(f"card: {card}", flush=True)
    ok = True
    for batch in cfg.batch:
        for case in CASES:
            for row in measure(batch, case, cfg.steps):
                ok &= row["finite"] and row.get("bit_equal_to_default", True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
