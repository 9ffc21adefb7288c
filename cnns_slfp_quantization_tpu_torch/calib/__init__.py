"""Calibration scale constants (counterpart of the JAX ``calib/__init__.py``).

Per-layer ``ka``/``kw`` are stored as max-abs values in JSON under
``calib/constants/`` with the reference's divisor (``Ka = max|input| /
15.5``, 15.0 for ShuffleNetV2).  The port ships its own copy of the
constants it serves; :mod:`.calibrate` regenerates them from a float32
model and :func:`save_scales` writes them in JAX's format.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

_CONSTANTS_DIR = pathlib.Path(__file__).parent / "constants"


@dataclasses.dataclass(frozen=True)
class ScaleSet:
    """Per-layer quantization scales: ``ka[i] = max|input_i| / divisor``."""

    ka: np.ndarray  # already divided
    kw: np.ndarray
    divisor: float
    source: str = ""

    def __post_init__(self):
        object.__setattr__(self, "ka", np.asarray(self.ka, np.float64))
        object.__setattr__(self, "kw", np.asarray(self.kw, np.float64))

    @staticmethod
    def ones(n: int) -> "ScaleSet":
        return ScaleSet(np.ones(n), np.ones(n), 1.0, "unit")


def load_scales(name: str) -> ScaleSet:
    """Load a shipped scale set (e.g. "resnet50_imgnet")."""
    return load_scales_path(_CONSTANTS_DIR / f"{name}.json")


def load_scales_path(path) -> ScaleSet:
    """Load a scale-set JSON from an explicit path."""
    path = pathlib.Path(path)
    data = json.loads(path.read_text())
    div = float(data["divisor"])
    return ScaleSet(
        ka=np.asarray(data["ka_max"], np.float64) / div,
        kw=np.asarray(data["kw_max"], np.float64) / div,
        divisor=div,
        source=data.get("source", str(path)),
    )


def save_scales(name: str, ka_max, kw_max, divisor: float,
                source: str = "calibrated", out_dir=None):
    """Write a scale-set JSON (JAX ``calib.save_scales``: the same keys,
    order and ``indent=1``).

    ``out_dir=None`` writes into the package's ``calib/constants/`` (for
    deliberately shipping a new constants set); runtime callers (the
    ``--pre_reference`` CLI path) pass an output directory, so generated
    files land under ``--root_dir``, not inside the installed package.
    """
    out = _CONSTANTS_DIR if out_dir is None else pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.json"
    path.write_text(
        json.dumps(
            {
                "source": source,
                "divisor": divisor,
                "ka_max": list(map(float, ka_max)),
                "kw_max": list(map(float, kw_max)),
            },
            indent=1,
        )
        + "\n"
    )
    return path
