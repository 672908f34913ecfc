"""Port vs JAX package: device index, window k-mer codes, anchor lookup.

Same seeded inputs through both; tolerance 0 (integers and bools).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vgaligner_tpu.graph import graph_from_gfa as jax_graph_from_gfa
from vgaligner_tpu.index import Index as JaxIndex
from vgaligner_tpu.ops.encode import encode_reads_host as jax_encode
from vgaligner_tpu.ops.encode import window_kmer_codes as jax_window
from vgaligner_tpu.ops.lookup import lookup_and_materialize_anchors as jax_lookup

from vgaligner_tpu_torch.graph import graph_from_gfa
from vgaligner_tpu_torch.index import Index
from vgaligner_tpu_torch.index.device_index import device_index, from_numpy
from vgaligner_tpu_torch.ops.encode import encode_reads_host, window_kmer_codes
from vgaligner_tpu_torch.ops.lookup import lookup_and_materialize_anchors
from vgaligner_tpu_torch.testing import one_torch_thread, sample_reads, write_synthetic_gfa

K = 11
CPU = torch.device("cpu")
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    gfa = str(tmp_path_factory.mktemp("g") / "graph.gfa")
    write_synthetic_gfa(gfa, seed=3, backbone_len=500, n_haplotypes=4)
    jidx = JaxIndex.build(jax_graph_from_gfa(gfa), K, 100, 100)
    graph = graph_from_gfa(gfa)
    pidx = Index.build(graph, K, 100, 100)
    reads = sample_reads(graph, 24, 100, seed=5, sub_rate=0.03, n_rate=0.02)
    reads += ["ACGT" * 3, "N" * 40, reads[0][:37]]  # short, all-N, odd length
    return jidx, pidx, reads


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("lut", [False, True])
def test_device_index_matches_jax_and_from_numpy(indexes, monkeypatch, lut):
    monkeypatch.setenv("VGALIGNER_DENSE_LUT_MAX", str(1 << 24) if lut else "0")
    jidx, pidx, _ = indexes
    jd = jidx.device()
    fields = {k: None if v is None else np.asarray(v) for k, v in jd._asdict().items()}
    built = device_index(pidx, CPU)
    loaded = from_numpy(fields, CPU)
    assert (built.dense_lut is None) == (not lut) == (loaded.dense_lut is None)
    for name in built._fields:
        want = fields[name]
        for got in (getattr(built, name), getattr(loaded, name)):
            if want is None:
                assert got is None
                continue
            assert str(got.dtype).split(".")[-1] == str(want.dtype), name
            np.testing.assert_array_equal(_np(got), want, err_msg=name)


def test_window_kmer_codes_with_n_and_padding(indexes):
    _, _, reads = indexes
    codes, lens = encode_reads_host(reads, 128)
    jcodes, jlens = jax_encode(reads, 128)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(lens, jlens)
    w, v = window_kmer_codes(torch.from_numpy(codes), torch.from_numpy(lens), K)
    jw, jv = jax_window(jnp.asarray(jcodes), jnp.asarray(jlens), K)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert not v.numpy()[-2].any()  # the all-N read has no valid window


@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("a_max", [64, 256])
def test_anchors_match_jax(indexes, monkeypatch, lut, a_max):
    monkeypatch.setenv("VGALIGNER_DENSE_LUT_MAX", str(1 << 24) if lut else "0")
    jidx, pidx, reads = indexes
    codes, lens = encode_reads_host(reads, 128)
    jd = jidx.device()
    jw, jv = jax_window(jnp.asarray(codes), jnp.asarray(lens), K)
    want = jax_lookup(jd, jw, jv, a_max)
    dind = device_index(pidx, CPU)
    w, v = window_kmer_codes(torch.from_numpy(codes), torch.from_numpy(lens), K)
    got = lookup_and_materialize_anchors(dind, w, v, a_max)
    assert int(want.n_anchors.max()) > 64  # some reads are truncated at 64
    for name in ("qb", "tb", "te", "valid", "n_anchors"):
        g, wv = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == wv.dtype, name
        np.testing.assert_array_equal(g, wv, err_msg=name)
