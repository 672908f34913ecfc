"""Port vs JAX package: the HLA-zoo suite runner (``experiments/``).

  * ``gafcompare``: tests/test_experiments.py's tests 1-4 on the port's
    copy, and its results equal to the JAX module's;
  * ``simulate_reads``: reads and truth equal to JAX's in both
    orientation models;
  * ``run_dataset`` on a tiny synthetic dataset with ``device="cpu"``:
    every report field but the timings equal to the JAX ``run_dataset``'s,
    on both engines;
  * ``main`` over a datasets directory (``--device cpu``, ``--out``), and
    its exit code 2 when no dataset is found.
"""

import json

import pytest
import torch

from vgaligner_tpu.experiments import gafcompare as jax_gafcompare
from vgaligner_tpu.experiments import run_suite as jax_run_suite
from vgaligner_tpu.graph import graph_from_gfa as jax_graph_from_gfa

from vgaligner_tpu_torch.experiments import run_suite
from vgaligner_tpu_torch.experiments.gafcompare import (compare_paths, parse_gaf_paths,
                                                       path_jaccard, signed_ids)
from vgaligner_tpu_torch.graph import graph_from_gfa
from vgaligner_tpu_torch.testing import one_torch_thread, write_synthetic_gfa

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
_TIMINGS = {"index_build_s", "map_s", "align_s", "map_align_rps"}


def test_signed_ids():
    assert signed_ids(">1>3<5>12") == [1, 3, -5, 12]
    assert signed_ids("*") == []
    # the chains-GAF tuple format also parses (node ids only)
    assert signed_ids("(>1:0,>6:2),(>3:1,>8:0),") == [1, 6, 3, 8]
    for s in (">1>3<5>12", "*", "(>1:0,>6:2),(>3:1,>8:0),"):
        assert signed_ids(s) == jax_gafcompare.signed_ids(s)


def test_path_jaccard_exact_and_range():
    assert path_jaccard([1, 2, 3], [1, 2, 3]) == 1.0
    # range semantics (gafcompare.py:57-67): [min,max) intersections
    assert path_jaccard([1, 4], [2, 5]) == pytest.approx(2 / 4)
    assert path_jaccard([1, 2], [5, 9]) == 0.0
    assert path_jaccard([], [1]) == 0.0
    # reverse orientation flips sign, shifting the range
    assert path_jaccard([-3, -1], [1, 3]) == 0.0
    for a, b in (([1, 4], [2, 5]), ([-3, -1], [1, 3]), ([7, 2, 9], [2, 9])):
        assert path_jaccard(a, b) == jax_gafcompare.path_jaccard(a, b)


def test_compare_paths_counts():
    q = {"a": [1, 2], "b": [5, 6]}
    r = {"a": [1, 2], "b": [1, 2], "c": [9]}
    res = compare_paths(q, r)
    assert res.total_ref_reads == 3
    assert res.reads_found == 2
    assert res.jaccards[0] == 1.0
    assert res.exact_rate == 0.5
    want = jax_gafcompare.compare_paths(q, r)
    assert (res.jaccards, res.avg_jaccard) == (want.jaccards, want.avg_jaccard)


def test_parse_gaf_first_record_wins(tmp_path):
    p = tmp_path / "x.gaf"
    p.write_text(
        "r1\t10\t0\t10\t+\t>1>2\t5\t0\t5\t0\t5\t255\tnote\n"
        "r1\t10\t0\t10\t+\t>7>8\t5\t0\t5\t0\t5\t255\tnote\n"
    )
    assert parse_gaf_paths(str(p)) == {"r1": [1, 2]} == jax_gafcompare.parse_gaf_paths(str(p))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    for name, seed in (("tiny-a", 1), ("tiny-b", 2)):
        (root / name).mkdir()
        write_synthetic_gfa(str(root / name / "graph.gfa"), seed=seed, backbone_len=1500,
                            n_haplotypes=4)
    (root / "not-a-dataset").mkdir()
    return root


@pytest.mark.parametrize("orient", ["forward", "as-path"])
def test_simulate_reads_equal_jax(datasets, orient):
    gfa = str(datasets / "tiny-a" / "graph.gfa")
    got = run_suite.simulate_reads(graph_from_gfa(gfa), 40, 100, orient=orient)
    assert got == jax_run_suite.simulate_reads(jax_graph_from_gfa(gfa), 40, 100, orient=orient)


def _fields(report):
    return {k: v for k, v in vars(report).items() if k not in _TIMINGS}


@pytest.mark.parametrize("engine,precision", [("abpoa", "fast"), ("rspoa", "exact")])
def test_run_dataset_equals_jax(datasets, engine, precision):
    gfa = str(datasets / "tiny-b" / "graph.gfa")
    got = run_suite.run_dataset(gfa, "tiny-b", 48, 100, 11, precision, engine, device="cpu")
    want = jax_run_suite.run_dataset(gfa, "tiny-b", 48, 100, 11, precision, engine)
    assert _fields(got) == _fields(want)
    assert got.n_reads == 48 and got.reads_found >= 45 and got.avg_jaccard > 0.9


def test_main_writes_a_report(datasets, tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = run_suite.main(["--datasets", str(datasets), "--device", "cpu", "--n-reads", "24",
                         "--out", str(out)])
    assert rc == 0
    reports = json.loads(out.read_text())
    assert [r["name"] for r in reports] == ["tiny-a", "tiny-b"]
    assert all(r["n_reads"] == 24 and r["reads_found"] >= 20 for r in reports)
    assert "suite: 2 graphs, 48 reads" in capsys.readouterr().out


def test_main_without_datasets_exits_2(tmp_path):
    assert run_suite.main(["--datasets", str(tmp_path), "--device", "cpu"]) == 2
    assert run_suite.main(["--datasets", str(tmp_path / "absent"), "--device", "cpu"]) == 2


def test_run_dataset_defaults_to_the_card(datasets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot be shown")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run_suite.run_dataset(str(datasets / "tiny-a" / "graph.gfa"), "tiny-a", 8, 100, 11,
                              "fast")
