"""``BENCHMARK.json`` and the files it names, found by name:

- ``configs/<config>.json``: a configuration (``file`` in the manifest);
- ``traffic/<traffic>.json``: a traffic mix, run by the module its
  ``kind`` names (``runners/<kind>.py``);
- ``metrics/<metric>.py``: a per-layer metric's reader (``read(run)``);
- ``reference/<reference>.py``: a configuration's plain reference.

A cell (``workloads`` entry) pairs a configuration with a traffic mix.  A
later change adds a configuration, a mix or a metric as new files and new
entries, and edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list          # the manifest's end-to-end metrics of the cell
    per_layer: list           # ... and its per-layer metrics
    root: pathlib.Path        # the checkout the manifest lies in


def load(root) -> dict:
    root = pathlib.Path(root)
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root, name: str) -> Cell:
    """The cell ``name`` of the manifest under ``root``, its files read."""
    root = pathlib.Path(root)
    man = load(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; the cells "
                       f"are {sorted(cells)}")
    w = cells[name]
    confs = {c["name"]: c for c in man["configs"]}
    config = json.loads((root / confs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in man["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in man["per_layer"] if _reports(m, name)],
        root=root)


def _module(root, folder: str, name: str):
    """``benchmark/<folder>/<name>.py`` under ``root``, loaded by its path
    (a name may hold dots and dashes)."""
    path = pathlib.Path(root) / "benchmark" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no such {folder[:-1]} file")
    key = f"benchmark_{folder}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(root, kind: str):
    """The module that runs a traffic kind (``runners/<kind>.py``)."""
    return _module(root, "runners", kind)


def reference(root, name: str):
    """A configuration's plain reference (``reference/<name>.py``)."""
    return _module(root, "reference", name)


def reader(root, metric: str):
    """The ``read(run)`` function of a per-layer metric
    (``metrics/<metric>.py``)."""
    return _module(root, "metrics", metric).read
