"""A run that finds no card fails, printing no result; so does a run from
a directory that holds only BENCHMARK.json and the benchmark's folder."""

import shutil
import subprocess
import sys

import pytest

from .conftest import ROOT

ARGS = ["--workload", "aideal-serve", "--seed", "4294967311", "--seconds",
        "1", "--trace", "0"]


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")


def _run(root):
    return subprocess.run([sys.executable, "port_bench/run.py", *ARGS],
                          cwd=root, capture_output=True, text=True,
                          env={"PATH": "/usr/bin:/bin",
                               "HOME": str(root)})


def test_no_card_no_result(no_card):
    p = _run(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
