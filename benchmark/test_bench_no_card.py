"""The runner prints no result and exits non-zero without a card, and in
a directory that holds only BENCHMARK.json and the benchmark's files."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.conftest import ROOT


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "resnet50-serve-b256", "--seed", "2147483701", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def _no_result(p):
    assert p.returncode != 0
    for line in p.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    _no_result(_run(ROOT, env))


def test_refuses_with_only_the_benchmark(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    _no_result(_run(tmp_path))
