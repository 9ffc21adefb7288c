"""Weight memory against images/s of the fused SLFP8 ResNet-50 with float
and packed weights on the card (counterpart of JAX's
``tools/bench_packed_fused.py``).

    python3 -m cnns_slfp_quantization_tpu_torch.utils.bench_packed_fused \\
        [--batch 256] [--steps 16] [--size 224] [--device cuda|cpu]

For ``pack_weights=False`` and ``True``: the engine's fused executor
(default policy) serves four images (finite logits, their top-1 printed)
and then times ``throughput(steps)`` (its CUDA graph); ``weight_MB`` is what
the executor holds on the device after that forward (every tensor of its
``FusedWeights``, K6's decoded chain weights included), with the split by
dtype.  One JSON line per configuration: JAX's keys (``config``,
``weight_MB``, ``img_per_sec``) and the port's; then one line that holds
the packed executor's logits against the float one's: the codes decode to
the float-frozen bf16 values, so the logits must be bit-equal (JAX checks
only that they are finite; a top-1 would not do, as a random-weight net
gives one class to every image).  Weights from seed 0, shipped scales.
Prints the card's name and power limit first; ``--device cpu`` times the
host.
"""

from __future__ import annotations

import argparse
import json
import sys


def engine(packed: bool, batch: int, size: int, dev):
    """The fused engine of one configuration."""
    from cnns_slfp_quantization_tpu_torch.serve import InferenceEngine

    return InferenceEngine("resnet", qbit=8, batch_size=batch,
                           image_size=size, pack_weights=packed, fused=True,
                           seed=0, device=dev.type)


def measure(packed: bool, batch: int, size: int, dev, iters: int = 16):
    """(row, logits): one configuration's JSON line (printed) and its
    logits of the four images."""
    import numpy as np

    from cnns_slfp_quantization_tpu_torch.utils.bench_roofline import (
        tensor_bytes)

    eng = engine(packed, batch, size, dev)
    x = np.random.default_rng(0).normal(0, 1, (4, size, size, 3)).astype(
        np.float32)
    logits = eng.predict(x)
    by_dtype = tensor_bytes(eng.executor)
    row = {"config": "packed_fused" if packed else "float_fused",
           "weight_MB": sum(by_dtype.values()) / 1e6,
           "weight_MB_by_dtype": {k: v / 1e6 for k, v in by_dtype.items()},
           "img_per_sec": eng.throughput(iters),
           "finite": bool(np.isfinite(logits).all()),
           "top1": np.argmax(logits, -1).tolist(), "batch": batch}
    print(json.dumps(row), flush=True)
    return row, logits


def compare(flt, packed) -> dict:
    """The packed executor's logits against the float one's (printed and
    returned)."""
    import numpy as np

    out = {"check": "packed-vs-float logits",
           "bit_equal": flt.shape == packed.shape
           and np.array_equal(flt.view(np.uint32), packed.view(np.uint32)),
           "max_abs_delta": float(np.abs(flt - packed).max())}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--device", default="cuda")
    cfg = ap.parse_args(argv)
    from cnns_slfp_quantization_tpu_torch.utils import turns

    dev, card = turns.device(cfg.device)
    print(f"card: {card}", flush=True)
    (flt, lf), (pk, lp) = (measure(p, cfg.batch, cfg.size, dev, cfg.steps)
                           for p in (False, True))
    ok = flt["finite"] and pk["finite"] and compare(lf, lp)["bit_equal"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
