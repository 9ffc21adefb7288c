"""The ShuffleNetV2 configuration's own pieces: its layer table against the
published count, and the serving control at a test's size on the CPU."""

import json

import torch

from benchmark import control, work
from benchmark.conftest import ROOT, small_cell

CELL = "shufflenetv2-serve-b256"


def test_layer_table_counts_the_published_work():
    conf = json.loads((ROOT / "benchmark" / "configs"
                       / "shufflenetv2-slfp8.json").read_text())
    got = sum(work.macs(lay) for lay in conf["layers"])
    assert abs(got - 144.9e6) / 144.9e6 < 0.002, got


def test_serving_control_fails():
    got = control.serve_control(small_cell(CELL), 99, torch.device("cpu"))
    assert got["fp8"]["correct"] is False, got
