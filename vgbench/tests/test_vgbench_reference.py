"""The plain reference against the port's plain CPU path at a tiny size:
the same chains GAF rows in both arithmetics, and the same alignments
GAF rows on both engines."""

import pytest

from helpers import ROOT  # noqa: F401


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import torch

    from vgbench import traffic
    from vgbench.reference import Reference
    from vgaligner_tpu_torch.graph import graph_from_gfa
    from vgaligner_tpu_torch.index import Index

    torch.set_num_threads(2)
    d = tmp_path_factory.mktemp("ref")
    gfa = str(d / "g.gfa")
    traffic.write_graph(gfa, seed=5, backbone_len=900)
    text = traffic.make_reads(gfa, 96, 100, 0.02, 2 ** 31 + 9).decode()
    reads = [(f"q{i}", text[i * 100:(i + 1) * 100]) for i in range(96)]
    return {"gfa": gfa, "reads": reads, "ref": Reference(gfa),
            "index": Index.build(graph_from_gfa(gfa), 11)}


def test_index_is_the_forward_table(world):
    idx, ref = world["index"], world["ref"].index
    fo = {}
    for g, c in enumerate(idx.kmer_codes.tolist()):
        o, n = int(idx.fo_offsets[g]), int(idx.fo_counts[g])
        if n:
            fo[c] = [tuple(r) for r in idx.fo_positions[o:o + n].tolist()]
    mine = {c: list(zip(ref.starts[ref.offsets[g]:ref.offsets[g + 1]].tolist(),
                        ref.ends[ref.offsets[g]:ref.offsets[g + 1]].tolist()))
            for g, c in enumerate(ref.codes.tolist())}
    assert fo == mine


@pytest.mark.parametrize("precision,engine", [("fast", "abpoa"), ("exact", "rspoa"),
                                              ("exact", None), ("fast", "rspoa")])
def test_rows_equal_the_port_cpu_path(world, precision, engine):
    import torch

    from vgaligner_tpu_torch.io.fastx import QuerySequence
    from vgaligner_tpu_torch.models.mapper import Mapper
    from vgaligner_tpu_torch.models.poa_aligner import PoaAligner, PoaEngine

    reads = world["reads"]
    qs = [QuerySequence(n, s) for n, s in reads]
    cpu = torch.device("cpu")
    mapper = Mapper(world["index"], cpu, bandwidth=50, precision=precision)
    chains = mapper.map_reads(qs)
    want = world["ref"].rows(reads, precision, engine)
    mapped = 0
    for i, (name, _) in enumerate(reads):
        assert mapper.chains_gaf_text([chains[i]]) == want[name][0], name
        mapped += not chains[i][0].is_placeholder
    assert mapped >= len(reads) // 2
    if engine:
        aligner = PoaAligner(world["index"], cpu, engine=PoaEngine(engine))
        alns = aligner.best_alignments_for_queries(chains, 1)
        for i, (name, _) in enumerate(reads):
            assert alns[i].to_string().encode() == want[name][1], name


def test_control_arithmetics_run(world):
    ref = world["ref"]
    seqs = [s for _, s in world["reads"]]
    n = ref.n_anchors(seqs)
    assert n.shape == (len(seqs),) and (n > 0).all()
    assert len(ref.rows(world["reads"][:8], "int16", None)) == 8
