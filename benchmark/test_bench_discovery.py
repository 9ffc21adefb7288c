"""The harness finds a configuration, a traffic mix, a reference and a
per-layer metric by name: a later change adds them as new files and new
entries in BENCHMARK.json, editing no file that is there."""

import json
import shutil

from benchmark import manifest
from benchmark.conftest import ROOT


def test_new_files_are_found_without_editing_any(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    b = tmp_path / "benchmark"
    conf = json.loads((b / "configs" / "resnet50-slfp8.json").read_text())
    conf.update(name="resnet50-wide", reference="resnet50_wide")
    (b / "configs" / "resnet50-wide.json").write_text(json.dumps(conf))
    (b / "reference" / "resnet50_wide.py").write_text(
        (b / "reference" / "resnet50.py").read_text())
    (b / "traffic" / "closed-b64.json").write_text(json.dumps(
        {"kind": "serve", "batch": 64, "pool_batches": 8,
         "warmup_requests": 3, "check_requests": 4, "trace_calls": 40}))
    (b / "metrics" / "batch_rows.serve.py").write_text(
        "def read(run):\n    return float(run.batch)\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "resnet50-wide", "source": "x",
                           "file": "benchmark/configs/resnet50-wide.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "resnet50-wide-b64",
                             "config": "resnet50-wide",
                             "traffic": "closed-b64", "chips": 1,
                             "why": "x"})
    for m in man["end_to_end"]:
        if "workloads" in m and "resnet50-serve-b256" in m["workloads"]:
            m["workloads"].append("resnet50-wide-b64")
    man["per_layer"].append({"name": "batch_rows.serve", "unit": "rows",
                             "better": "higher", "source": "host_clock",
                             "layer": "engine", "moves": "images_per_s",
                             "workloads": ["resnet50-wide-b64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    cell = manifest.cell(tmp_path, "resnet50-wide-b64")
    assert cell.config["name"] == "resnet50-wide"
    assert cell.traffic["batch"] == 64
    assert manifest.runner(tmp_path, cell.traffic["kind"]).window
    assert manifest.reference(tmp_path, "resnet50_wide").serve_forward
    assert "batch_rows.serve" in {m["name"] for m in cell.per_layer}
    run = type("Run", (), {"batch": 64})()
    assert manifest.reader(tmp_path, "batch_rows.serve")(run) == 64.0
    for p, data in before.items():
        assert p.read_bytes() == data, p
