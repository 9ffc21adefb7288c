"""BENCHMARK.json against the benchmark's contract: names and units, the
files each entry names, which cells report which metric, the layer
tables' work against the published counts, and the run length's budget."""

import json
import re

import pytest

from benchmark import manifest, work
from benchmark.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = manifest.load(ROOT)


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(MAN["command"]) <= 32
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")


@pytest.mark.parametrize("entry", (
    [("config", c) for c in MAN["configs"]]
    + [("workload", w) for w in MAN["workloads"]]
    + [("metric", m) for m in MAN["end_to_end"] + MAN["per_layer"]]),
    ids=lambda e: f"{e[0]}-{e[1]['name']}")
def test_names_units_and_lines(entry):
    kind, e = entry
    assert NAME.match(e["name"])
    for key in ("why", "layer", "source"):
        if key in e and not (kind == "metric" and key == "source"):
            assert 1 <= len(e[key]) <= 200
            assert "\n" not in e[key] and "\t" not in e[key]
    if kind == "metric":
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    if kind == "workload":
        assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        assert e["chips"] in (1, 4)
    if kind == "config":
        assert all(NAME.match(k) for k in e["reduced"])


def test_names_are_unique_and_cells_are_pairs():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds_and_sources():
    names = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in names and names["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_enough():
    for w in MAN["workloads"]:
        cell = manifest.cell(ROOT, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = [w["name"] for w in MAN["workloads"]]
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for c in m.get("workloads", cells):
            assert c in cells
            assert "workloads" not in moved or c in moved["workloads"], \
                (m["name"], c)


def test_every_named_file_exists():
    for c in MAN["configs"]:
        assert c["file"].startswith(MAN["paths"][0] + "/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert (ROOT / "benchmark" / "reference"
                / f"{conf['reference']}.py").is_file()
    for w in MAN["workloads"]:
        tr = json.loads((ROOT / "benchmark" / "traffic"
                         / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "runners"
                / f"{tr['kind']}.py").is_file()
    for m in MAN["per_layer"]:
        assert callable(manifest.reader(ROOT, m["name"]))


@pytest.mark.parametrize("config, macs", (("resnet50-slfp8", 4.09e9),
                                          ("mobilenetv1-slfp8", 569e6)))
def test_layer_tables_count_the_published_work(config, macs):
    conf = json.loads((ROOT / "benchmark" / "configs"
                       / f"{config}.json").read_text())
    got = sum(work.macs(lay) for lay in conf["layers"])
    assert abs(got - macs) / macs < 0.002, got


def test_a_full_check_fits_the_day():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
