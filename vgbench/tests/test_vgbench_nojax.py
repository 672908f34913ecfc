"""Neither the harness nor the reference loads JAX or the JAX package,
and the reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "vgaligner_tpu"}


def test_run_loads_no_jax():
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, %r)\n"
        "from tests_helpers_path import small_cell\n" % ROOT
    )
    code = (
        "import sys\n"
        "sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from helpers import small_cell\n"
        "from vgbench import run\n"
        "import vgbench.reference, vgbench.harness, vgbench.judge, vgbench.work\n"
        "out = run.execute(small_cell('drb1-abpoa.short100'), 7, 0.5, True, device='cpu',"
        " batch=32)\n"
        "assert out['correct'], out\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (ROOT, os.path.join(ROOT, "vgbench", "tests"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    top = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "vgaligner_tpu_torch" in top  # whole names: the port's is not the JAX package's
    assert not (top & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "vgbench", "reference", "*.py")):
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"vgaligner_tpu_torch", "torch"}, \
                    (path, n)
