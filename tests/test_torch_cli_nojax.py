"""The port runs with jax unimportable, and never touches the JAX package.

The GPU machine has no jax, so a single jax import anywhere on the
port's path would crash it there: the CLI is run in a subprocess where
``import jax`` fails; again with ``vgaligner_tpu``, ``jax`` and
``jaxlib`` blocked by a meta-path finder and an audit hook recording
every file opened, compiled or imported and every process started under
``vgaligner_tpu/`` (the CLI, and the suite runner
``experiments/run_suite``); and every module of the port is scanned for
imports of ``jax`` or of the JAX package and for paths it builds into
``vgaligner_tpu``.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

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


_AUDIT_RUN = r"""
import os, runpy, sys
ref = os.path.join({repo!r}, "vgaligner_tpu") + os.sep
events = []


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("vgaligner_tpu", "jax", "jaxlib"):
            raise ImportError("blocked: " + name)
        return None


def under(p):
    if isinstance(p, bytes):
        p = os.fsdecode(p)
    return isinstance(p, str) and os.path.abspath(p).startswith(ref)


def hook(event, args):
    if event in ("open", "import") and args and under(args[0] if event == "open" else args[1]):
        events.append((event, str(args[:2])))
    elif event == "compile" and len(args) > 1 and under(args[1]):
        events.append((event, args[1]))
    elif event == "subprocess.Popen":
        argv = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
        if under(args[0]) or any(under(a) for a in argv) or under(args[2]):
            events.append((event, str(args[:3])))


sys.meta_path.insert(0, Block())
sys.addaudithook(hook)
sys.path.insert(0, {repo!r})
for argv in {argvs!r}:
    sys.argv = [{module!r}] + argv
    try:
        runpy.run_module({module!r}, run_name="__main__", alter_sys=True)
    except SystemExit as exc:  # a module that ends in sys.exit(main())
        assert exc.code in (0, None), exc.code
assert not events, events[:10]
loaded = [n for n, m in list(sys.modules.items()) if under(getattr(m, "__file__", None))]
assert not loaded, loaded
print("AUDIT_OK", len(sys.modules))
"""


@pytest.fixture
def tiny(tmp_path):
    from vgaligner_tpu_torch.graph import graph_from_gfa

    gfa = str(tmp_path / "tiny.gfa")
    write_synthetic_gfa(gfa, seed=2, backbone_len=300, n_haplotypes=3)
    fa = str(tmp_path / "reads.fa")
    write_fasta(fa, sample_reads(graph_from_gfa(gfa), 12, 100, seed=1, sub_rate=0.02))
    return gfa, fa


def _run(tmp_path, argvs, script=_RUN, module="vgaligner_tpu_torch"):
    code = script.format(repo=REPO, argvs=argvs, module=module)
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


def test_cli_touches_no_file_of_the_jax_package(tmp_path, tiny):
    """index and map -p abpoa -D -G with the JAX package, jax and jaxlib
    unimportable: no file under vgaligner_tpu/ is opened, compiled or
    imported, no process is started on one, and no loaded module comes
    from there."""
    gfa, fa = tiny
    proc = _run(tmp_path, [
        ["index", "-i", gfa, "-k", "11"],
        ["map", "-i", str(tmp_path / "tiny"), "-f", fa, "-p", "abpoa", "-D", "-G", gfa,
         "--device", "cpu", "-o", str(tmp_path / "out")],
    ], script=_AUDIT_RUN)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "AUDIT_OK" in proc.stdout
    assert len((tmp_path / "out-alignments.gaf").read_text().splitlines()) == 12


def test_run_suite_touches_no_file_of_the_jax_package(tmp_path, tiny):
    """``python -m vgaligner_tpu_torch.experiments.run_suite`` on a dataset
    directory, under the same block and audit hook as the CLI."""
    gfa, _fa = tiny
    os.makedirs(tmp_path / "datasets" / "tiny")
    os.replace(gfa, tmp_path / "datasets" / "tiny" / "graph.gfa")
    report = tmp_path / "report.json"
    proc = _run(tmp_path, [
        ["--datasets", str(tmp_path / "datasets"), "--device", "cpu", "--n-reads", "16",
         "--out", str(report)],
    ], script=_AUDIT_RUN, module="vgaligner_tpu_torch.experiments.run_suite")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "AUDIT_OK" in proc.stdout
    assert json.loads(report.read_text())[0]["n_reads"] == 16


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


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _names_the_jax_package(node):
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and node.value.replace("\\", "/").split("/")[0] == "vgaligner_tpu")


def _paths_into_the_jax_package(tree):
    """String constants naming vgaligner_tpu that the code joins into a
    path (os.path.join, Path, open, ``/``) or hands to ``__path__``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("join", "Path", "PurePath", "open", "joinpath"):
                yield from (a.value for a in node.args if _names_the_jax_package(a))
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            yield from (x.value for x in (node.left, node.right) if _names_the_jax_package(x))
        elif isinstance(node, ast.Assign) and any(
                getattr(t, "id", getattr(t, "attr", "")) == "__path__" for t in node.targets):
            yield "__path__"


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 30
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for mod in _imported_modules(tree):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "vgaligner_tpu"), (path, mod)
        assert not list(_paths_into_the_jax_package(tree)), path


def test_the_path_scan_sees_a_path_into_the_jax_package():
    for code in ('os.path.join(REPO, "vgaligner_tpu")', 'Path(REPO) / "vgaligner_tpu/native"',
                 '__path__ = [x]'):
        assert list(_paths_into_the_jax_package(ast.parse(code))), code
    assert not list(_paths_into_the_jax_package(ast.parse(
        'os.path.join(REPO, "vgaligner_tpu_torch"); s = "vgaligner_tpu/ops/poa.py:1"')))


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
