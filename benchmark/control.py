"""The control runs that the limits in the configuration files rest on: the
plain reference put in the program's place, computed in the precision
just below what the configuration states, and (training) the faults a
training cell can have, planted in that reference.  The benchmark's own
runs never run this.

    python3 -m benchmark.control --workload <cell> --seeds 11 12 13

prints one JSON line per seed with each variant's verdict, as a run's
check gives it (:func:`benchmark.checks.verdict` with the configuration's
limits: ``correct`` and each number beside its limit), against the sound
reference, at the cell's own sizes:

- serving: ``fp8``, the operands held in float8 (e4m3) in place of bf16;
- training: ``tf32``, the convolutions, matmuls and backward in TF32 in
  place of full float32; ``half_batch``, each step's loss the mean over
  the first half of its rows; ``label``, one label of each batch altered;
  a state left unchanged reads ``change_gap`` 1 by construction and is not
  run.  Beside them ``sound_again``, the reference run twice, which
  reads 0, and a witness that is read and not judged: ``exact_sums``, the
  reference with its convolutions' and matmuls' sums in float64, rounded
  to float32 once, which shows how far the numbers swing when only the
  rounding of the sums changes.

Each control and fault should come out not correct, ``sound_again``
correct.  It needs a card at the cells' sizes
(``benchmark/test_bench_control.py`` runs it at a test's size on the CPU).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

from benchmark import checks, inputs, manifest
from benchmark.reference.common import Numerics


def serve_control(cell, seed: int, dev) -> dict:
    """{"fp8": numbers} of one seed: the checked requests' logits of the
    reference in float8 operands against the reference's own."""
    cfg, tr, ref = cell.config, cell.traffic, cell.reference
    size, batch = cfg["image_size"], tr["batch"]
    p, scales = inputs.model(cell, seed, dev)
    ka, kw = inputs.scale_arrays(scales)
    pool = inputs.images(batch * tr["pool_batches"], size, seed, 3,
                         dev).view(tr["pool_batches"], batch, size, size, 3)
    policy, rows = cfg["serve"]["policy"], cfg["check_rows"]
    gaps = []
    with torch.no_grad():
        for i in range(min(tr["check_requests"], len(pool))):
            x = pool[i]
            for j in range(0, batch, rows):
                r = ref.serve_forward(p, x[j:j + rows], ka, kw,
                                      policy=policy)
                c = ref.serve_forward(
                    p, x[j:j + rows], ka, kw, policy=policy,
                    num=Numerics(operand=torch.float8_e4m3fn))
                gaps += checks.logit_gaps(c.float(), r.float())
    return {"fp8": checks.verdict({"logit_gap": max(gaps)},
                                  cfg["limits"]["serve"])}


def train_control(cell, seed: int, dev) -> dict:
    """{variant: numbers} of one seed, each variant's steps against the
    sound reference's from the same weights, batches and scales."""
    from benchmark.reference import train as ref_train

    cfg, tr, ref = cell.config, cell.traffic, cell.reference
    t, size, batch = cfg["train"], cfg["image_size"], tr["batch"]
    n = tr["checked_steps"]
    p, scales = inputs.model(cell, seed, dev)
    ka, kw = inputs.scale_arrays(scales)
    xs = inputs.images(batch * tr["pool_batches"], size, seed, 5, dev).view(
        tr["pool_batches"], batch, size, size, 3)
    ys = inputs.labels(batch * tr["pool_batches"], cfg["num_classes"], seed,
                       6, dev).view(tr["pool_batches"], batch)
    batches = [(xs[i], ys[i]) for i in range(n)]

    def steps(bs, num=Numerics(sums="float32")):
        r = ref_train.qat_steps(ref, p, bs, ka, kw, lr=t["lr"],
                                momentum=t["momentum"],
                                weight_decay=t["weight_decay"], tol=t["tol"],
                                num=num)
        return {"loss": r["loss"],
                "grad1": {k: v.cpu() for k, v in r["grad1"].items()},
                "change": {k: v.cpu() for k, v in r["change"].items()}}

    sound = steps(batches)
    altered = [(x, torch.cat([(y[:1] + 1) % cfg["num_classes"], y[1:]]))
               for x, y in batches]
    variants = {
        "tf32": steps(batches, Numerics(sums="tf32")),
        "half_batch": steps([(x[:batch // 2], y[:batch // 2])
                             for x, y in batches]),
        "label": steps(altered),
    }
    variants["exact_sums"] = steps(batches, Numerics(sums="exact"))
    variants["sound_again"] = steps(batches)
    return {k: dict(checks.verdict(checks.train_numbers(v, sound),
                                   cfg["limits"]["train"]),
                    readings=checks.train_readings(v, sound))
            for k, v in variants.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs at the cells' sizes on a card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    root = pathlib.Path.cwd()
    cell = manifest.cell(root, args.workload)
    cell.reference = manifest.reference(root, cell.config["reference"])
    run = serve_control if cell.traffic["kind"] == "serve" else train_control
    for seed in args.seeds:
        out = run(cell, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "card": torch.cuda.get_device_name(dev), **out},
                         default=float), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
