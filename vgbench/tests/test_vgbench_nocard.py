"""A run without a card, or without the program beside it, fails and
prints no result."""

import os
import shutil
import subprocess
import sys

import pytest

from helpers import ROOT


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "vgbench.run", "--workload",
                           "drb1-abpoa.short100", "--seed", "3000000000", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_fails_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible here: the run would measure")
    r = _run(ROOT)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA" in r.stderr


def test_benchmark_alone_fails_without_a_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "vgbench"), tmp_path / "vgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = dict(os.environ, PYTHONPATH="")
    r = _run(str(tmp_path), env)
    assert r.returncode != 0
    assert r.stdout == ""
