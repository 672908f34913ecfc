"""The port runs with jax unimportable, and never imports it.

The GPU machine has no jax, so a single jax import anywhere on the
port's path would crash it there: the CLI is run in a subprocess where
``import jax`` fails, and every module of the port is scanned for
imports of ``jax`` or of the JAX package ``vgaligner_tpu``.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from vgaligner_tpu_torch import cli
from vgaligner_tpu_torch.testing import (one_torch_thread, sample_reads, write_fasta,
                                         write_synthetic_gfa)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "vgaligner_tpu_torch")
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

_RUN = r"""
import runpy, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.path.insert(0, {repo!r})
for argv in {argvs!r}:
    sys.argv = ["vgaligner_tpu_torch"] + argv
    runpy.run_module("vgaligner_tpu_torch", run_name="__main__", alter_sys=True)
bad = [m for m in sys.modules if m == "vgaligner_tpu" or m.startswith("vgaligner_tpu.")]
assert not bad, bad
print("NOJAX_OK")
"""


@pytest.fixture
def tiny(tmp_path):
    from vgaligner_tpu_torch._shared.graph import graph_from_gfa

    gfa = str(tmp_path / "tiny.gfa")
    write_synthetic_gfa(gfa, seed=2, backbone_len=300, n_haplotypes=3)
    fa = str(tmp_path / "reads.fa")
    write_fasta(fa, sample_reads(graph_from_gfa(gfa), 12, 100, seed=1, sub_rate=0.02))
    return gfa, fa


def _run(tmp_path, argvs):
    code = _RUN.format(repo=REPO, argvs=argvs)
    env = dict(os.environ, OMP_NUM_THREADS="1")  # tiny tensors; see one_torch_thread
    return subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=env)


def test_cli_index_and_map_align_with_jax_blocked(tmp_path, tiny):
    gfa, fa = tiny
    prefix = str(tmp_path / "tiny")
    proc = _run(tmp_path, [
        ["index", "-i", gfa, "-k", "11"],
        ["map", "-i", prefix, "-f", fa, "-p", "abpoa", "-D", "-G", gfa,
         "--device", "cpu", "-o", str(tmp_path / "out")],
    ])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout
    chains = (tmp_path / "out-chains.gaf").read_text().splitlines()
    alns = (tmp_path / "out-alignments.gaf").read_text().splitlines()
    assert len(alns) == 12 and len(chains) >= 12
    assert all(len(r.split("\t")) == 13 for r in chains + alns)
    assert any("cs:Z:" in r for r in alns)
    assert len(os.listdir(tmp_path / "subgraphs")) >= 1  # -G exports subgraphs


def test_cli_rspoa_exact_with_jax_blocked(tmp_path, tiny):
    gfa, fa = tiny
    prefix = str(tmp_path / "tiny")
    proc = _run(tmp_path, [
        ["index", "-i", gfa, "-k", "11"],
        ["map", "-i", prefix, "-f", fa, "-p", "rspoa", "-D", "-G", gfa, "--precision",
         "exact", "--device", "cpu", "-o", str(tmp_path / "out")],
    ])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout
    alns = (tmp_path / "out-alignments.gaf").read_text().splitlines()
    assert len(alns) == 12 and all(len(r.split("\t")) == 13 for r in alns)
    assert sum(r.split("\t")[5] != "*" for r in alns) >= 10
    assert not (tmp_path / "subgraphs").exists()  # the rspoa route exports none


def _imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 15
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "vgaligner_tpu"), (path, mod)


def test_default_device_without_a_card_is_an_error(tmp_path, tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot be shown")
    gfa, fa = tiny
    proc = _run(tmp_path, [
        ["index", "-i", gfa, "-k", "11"],
        ["map", "-i", str(tmp_path / "tiny"), "-f", fa, "-p", "abpoa"],
    ])
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not (tmp_path / "reads-chains.gaf").exists()


@pytest.mark.parametrize("extra,roadmap", [
    (["-p", "abpoa", "-t", "2"], "A12"),
    (["-p", "abpoa", "--shard-index"], "A12"),
])
def test_unported_options_fail_loudly(extra, roadmap):
    with pytest.raises(NotImplementedError, match=roadmap):
        cli.main(["map", "-i", "unused", "-f", "unused.fa", "--device", "cpu", *extra])
