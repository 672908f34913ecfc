"""Port vs JAX package: ``align_global_batch``, the abPOA engine's batch
entry point for (nodes, edges, query) problems, tolerance 0.

  * random DAG problems over every row width the kernels route by: rows
    up to 256 columns (K6's), 512 and 1,024 (K8's) and 16,384 (K2 +
    K3's, at a small V), and subgraphs over 8,192 base vertices (the
    native host POA): each ``PoaResult`` equal, field for field, to the
    port's ``align_global_host`` and to the JAX package's
    ``align_global_batch``;
  * ``_align_bucket`` (Python base graphs, the lane-padded contract,
    Python tape decoding) against the host oracle;
  * a vertex fan-in above 8 raises ValueError in both packages: a known
    reference fault the port keeps on purpose (ROADMAP, section C);
  * with no device argument it asks for the card, which this machine
    lacks: RuntimeError, never a CPU run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vgaligner_tpu.ops import poa_device as JPD

from vgaligner_tpu_torch.ops import poa_device as PD
from vgaligner_tpu_torch.ops.poa import align_global_host, build_base_graph
from vgaligner_tpu_torch.testing import one_torch_thread
from vgaligner_tpu_torch.utils.dna import encode_seq

CPU = torch.device("cpu")
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _problem(rng, n_nodes, max_label, q_len, mutate=0.08):
    """A random DAG (chain edges plus skips) and a query read off one of
    its source-to-sink walks, mutated, cut or padded to ``q_len``."""
    nodes = ["".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(1, max_label + 1))))
             for _ in range(n_nodes)]
    edges = [(b - 1, b) for b in range(1, n_nodes)]
    edges += [(int(rng.integers(0, b - 1)), b) for b in range(2, n_nodes) if rng.random() < 0.3]
    succ = {}
    for a, b in edges:
        succ.setdefault(a, []).append(b)
    walk, cur = [nodes[0]], 0
    while cur in succ:
        cur = succ[cur][int(rng.integers(len(succ[cur])))]
        walk.append(nodes[cur])
    seq = "".join(walk)
    seq = (seq * (q_len // max(len(seq), 1) + 1))[:q_len]
    q = "".join(c if rng.random() > mutate else "ACGT"[int(rng.integers(4))] for c in seq)
    return nodes, edges, q


def _problems():
    rng = np.random.default_rng(5)
    probs = [(["A", "CT", "GA", "GCA"], [(0, 1), (0, 2), (1, 3), (2, 3)], "ACTGCA"),
             (["ACT", "GGGG", "CA"], [(0, 1), (1, 2)], "ACTCA"),
             (["ACT"], [], "ACT")]
    probs += [_problem(rng, 40, 5, 100) for _ in range(5)]  # V 256, W 128 (K6)
    probs += [_problem(rng, 120, 6, 200) for _ in range(2)]  # V 512, W 256 (K6)
    probs += [_problem(rng, 90, 6, 300), _problem(rng, 150, 6, 700)]  # W 512, 1,024 (K8)
    probs += [_problem(rng, 12, 5, 8300)]  # W 16,384 at V 256 (K2 + K3)
    probs += [_problem(rng, 1400, 12, 120)]  # over 8,192 vertices: the native host POA
    return probs


def _buckets(probs):
    return {(PD._next_pow2(max(sum(map(len, n)), 256)), PD._l_pad_for(len(q)) + 1)
            for n, _e, q in probs if sum(map(len, n)) <= 8192}


@pytest.fixture(scope="module")
def problems():
    probs = _problems()
    assert {w for _v, w in _buckets(probs)} == {128, 256, 512, 1024, 16384}
    assert any(sum(map(len, n)) > 8192 for n, _e, _q in probs)
    return probs


@pytest.fixture(scope="module")
def got(problems):
    return PD.align_global_batch(problems, CPU)


def test_align_global_batch_equals_the_host_oracle(problems, got):
    assert len(got) == len(problems)
    for i, (res, prob) in enumerate(zip(got, problems)):
        assert res == align_global_host(*prob), i
    assert sum(r.n_aligned >= 60 for r in got) >= 8
    assert any("D" in r.cigar for r in got) and any("I" in r.cigar for r in got)


def test_align_global_batch_equals_jax(problems, got):
    want = JPD.align_global_batch(problems)
    for i, (g, w) in enumerate(zip(got, want)):
        assert dataclasses.astuple(g) == dataclasses.astuple(w), i


def test_align_bucket_equals_the_host_oracle():
    """The Python bucket route (``prepare_problem``, ``poa_global_kernel``
    under the lane-padded contract, a batch padded with copies, Python
    decoding) on problems whose fan-in fits."""
    rng = np.random.default_rng(9)
    probs = [_problem(rng, 30, 5, 90) for _ in range(3)]
    bgs = [build_base_graph(n, e) for n, e, _q in probs]
    got = PD._align_bucket(bgs, [encode_seq(q) for _n, _e, q in probs], 256, 127, CPU)
    for res, prob in zip(got, probs):
        assert res == align_global_host(*prob)


def test_fan_in_over_8_raises_as_in_jax():
    """Known reference fault, kept on purpose: the native builder refuses
    the bucket and ``prepare_problem`` raises ValueError in both packages."""
    nodes = ["A"] * 9 + ["C"]
    problems = [(nodes, [(i, 9) for i in range(9)], "AAC")]
    with pytest.raises(ValueError, match="fan-in 9 exceeds 8"):
        JPD.align_global_batch(problems)
    with pytest.raises(ValueError, match="fan-in 9 exceeds 8"):
        PD.align_global_batch(problems, CPU)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot be shown")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PD.align_global_batch([(["ACT"], [], "ACT")])
