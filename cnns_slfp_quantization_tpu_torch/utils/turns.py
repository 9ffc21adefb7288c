"""Timing in turns, shared by the bench tools (``bench_gemm``, ``bench_dw``,
``bench_chain``, and the device choice of every ``bench_*`` tool): the
card's name and power limit, a tool's measurements
through another checkout's wrappers in a process of its own, and two
calls timed in alternating turns.  Needs a CUDA device."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parents[2]    # this checkout
# what the tools' images/s time: ``InferenceEngine.forward`` on the card
FORWARD_NOTE = ("images/s of InferenceEngine.forward: replays of the "
                "engine's CUDA graph in this checkout (eager calls in a "
                "checkout older than its graph dispatch)")


def card() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    None (after saying so) where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()


def device(name: str = "cuda"):
    """(torch.device, its line for a tool's output) for a tool's
    ``--device``: on the card (the default) the line is :func:`card`'s,
    and without a CUDA device it raises; ``"cpu"`` runs the plain versions,
    whose numbers are counts, never a device's times."""
    import torch

    if name == "cpu":
        return torch.device("cpu"), "cpu (plain versions: no device time)"
    if not torch.cuda.is_available():
        raise RuntimeError("this tool runs on the card by default and found "
                           "no CUDA device; pass --device cpu to run the "
                           "plain versions on the CPU")
    return torch.device(name), card()


def worker(script: str, root: pathlib.Path, *args: str,
           timeout: int = 1200):
    """The JSON value printed as the last line of ``python3 script
    --worker root *args``: the tool's measurements through the wrappers of
    the checkout at ``root``, in a process of its own."""
    res = subprocess.run([sys.executable, str(script), "--worker", str(root),
                          *args], capture_output=True, text=True,
                         timeout=timeout)
    if res.returncode:
        print(res.stdout, res.stderr, file=sys.stderr)
        raise RuntimeError(f"{pathlib.Path(script).name} worker for {root} "
                           f"failed")
    return json.loads(res.stdout.strip().splitlines()[-1])


def across_checkouts(script: str, other: Optional[pathlib.Path],
                     *args: str) -> dict:
    """{"this": [result, ...], "other": [...]}: :func:`worker` for this
    checkout and for ``other`` in turns (this, other, other, this), or for
    this one alone; results in turn order."""
    roots = {"this": ROOT}
    if other is not None:
        roots["other"] = other.resolve()
    order = ["this", "other", "other", "this"] if other else ["this"]
    runs = {name: [] for name in roots}
    for name in order:
        runs[name].append(worker(script, roots[name], *args))
    return runs


def alternate(calls: dict, pairs: int) -> dict:
    """{name: [value, ...]}: two calls (``calls``: name -> a callable that
    returns a measurement, such as images/s), each once untimed, then in
    turns a, b, b, a, ``pairs`` times; values in turn order."""
    (a, fa), (b, fb) = calls.items()
    fa()
    fb()
    out = {a: [], b: []}
    for name in [a, b, b, a] * pairs:
        out[name].append(calls[name]())
    return out


def joined(values, fmt: str = ".1f") -> str:
    return " / ".join(f"{v:{fmt}}" for v in values)


def compared(runs: dict, unit: str = "images/s") -> str:
    """Both calls' values in turn order, the ratio of their sums, and
    whether every run of the first lies above (or below) every run of the
    second."""
    (a, va), (b, vb) = runs.items()
    return (f"{a} {joined(va)}; {b} {joined(vb)} {unit}; {a} / {b} "
            f"{sum(va) / sum(vb):.3f}; every {a} run above every {b} run: "
            f"{min(va) > max(vb)}, below: {max(va) < min(vb)}")

