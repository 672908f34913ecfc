"""Port vs JAX package: the Python subgraph route and the per-chain API,
tolerance 0 (integers and text).

  * ``find_range_chain``, ``extend_range_chain``,
    ``find_range_chain_corridor``, ``close_bubbles`` and
    ``find_nodes_edges`` on the chains of seeded reads mapped on a
    synthetic graph, and on host-anchor chains of reverse-strand reads
    (reverse and mixed-orient ranges): orient, handles, label trims,
    nodes and edges equal to the JAX functions';
  * ``PoaAligner._range_for_chain`` in corridor, id and id +
    bubble-closure mode against the port's own native extractor
    (``_extract``): handles, trimmed labels, edges and trim starts (the
    counterpart of tests/test_corridor.py's native-vs-Python check);
  * ``best_alignment_for_query`` and ``obtain_base_level_alignment`` on
    both engines and in every range mode against the JAX package's, GAF
    text equal, with the subgraph GFAs each writes byte-identical; and
    the per-chain API against the port's own batch route.
"""

import os

import numpy as np
import pytest
import torch

from vgaligner_tpu.graph import graph_from_gfa as jax_graph_from_gfa
from vgaligner_tpu.index import Index as JaxIndex
from vgaligner_tpu.io.fastx import QuerySequence as JaxQuery
from vgaligner_tpu.models import poa_aligner as JPA
from vgaligner_tpu.models.mapper import Chain as JaxChain

from vgaligner_tpu_torch.graph import graph_from_gfa
from vgaligner_tpu_torch.index import Index
from vgaligner_tpu_torch.io.fastx import QuerySequence
from vgaligner_tpu_torch.models import poa_aligner as PA
from vgaligner_tpu_torch.models.mapper import Chain, Mapper, anchors_for_query_host
from vgaligner_tpu_torch.parallel.mesh import rank_device
from vgaligner_tpu_torch.testing import one_torch_thread, sample_reads, write_synthetic_gfa
from vgaligner_tpu_torch.utils.dna import reverse_complement

K = 11
CPU = torch.device("cpu")
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
_MODES = {"corridor": dict(range_mode="corridor"), "id": dict(range_mode="id"),
          "bubble": dict(range_mode="id", bubble_closure=True)}


def _jax_chain(c: Chain) -> JaxChain:
    return JaxChain(query=JaxQuery(c.query.name, c.query.seq), aqb=c.aqb, atb=c.atb,
                    ate=c.ate, aso=c.aso, aeo=c.aeo, k=c.k,
                    mapping_quality=c.mapping_quality, is_secondary=c.is_secondary,
                    is_placeholder=c.is_placeholder, strand=c.strand)


def _oriented_chains(index, reads):
    """Chains of host anchors on both strands: the anchors of each read's
    reverse complement (reverse ranges) and one forward anchor plus one
    reverse anchor of a read (a mixed range)."""
    out = []
    for i, r in enumerate(reads):
        q = QuerySequence.from_name_and_string(f"o{i}", reverse_complement(r))
        anchors = anchors_for_query_host(index, q, only_forward=False)
        rev = [a for a in anchors if a.so == 1 and a.eo == 1]
        if len(rev) >= 3:
            out.append(Chain.from_anchor_list(q, rev[:: max(1, len(rev) // 5)]))
        fwd = anchors_for_query_host(index, QuerySequence.from_name_and_string(f"m{i}", r))
        if fwd and rev:
            out.append(Chain.from_anchor_list(q, [fwd[0], rev[-1]]))
    return out


def _alts_last(src: str, dst: str, frac: float, seed: int) -> None:
    """Rewrite a GFA with a seeded ``frac`` of its one-base nodes (mostly
    SNP alleles) renumbered after all the others, as vg construct numbers
    alt alleles after the backbone: edges then run against id order,
    which the id range drops and bubble closure restores."""
    rng = np.random.default_rng(seed)
    with open(src) as fh:
        rows = [ln.rstrip("\n").split("\t") for ln in fh]
    seqs = {int(r[1]): r[2] for r in rows if r[0] == "S"}
    moved = [i for i in sorted(seqs) if len(seqs[i]) == 1 and rng.random() < frac]
    order = [i for i in sorted(seqs) if i not in set(moved)] + moved
    new = {old: j + 1 for j, old in enumerate(order)}
    with open(dst, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        for old in order:
            fh.write(f"S\t{new[old]}\t{seqs[old]}\n")
        for r in rows:
            if r[0] == "L":
                fh.write(f"L\t{new[int(r[1])]}\t+\t{new[int(r[3])]}\t+\t0M\n")
            elif r[0] == "P":
                steps = ",".join(f"{new[int(x[:-1])]}+" for x in r[2].split(","))
                fh.write(f"P\t{r[1]}\t{steps}\t*\n")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A synthetic graph with long nodes (corridor flank trims) and alt
    alleles numbered last (bubble closure), reads mapped on it, and
    host-anchor chains of reverse-strand reads."""
    root = tmp_path_factory.mktemp("range")
    gfa = str(root / "graph.gfa")
    write_synthetic_gfa(str(root / "topo.gfa"), seed=4, backbone_len=2500, mean_spacing=70,
                        n_haplotypes=6)
    _alts_last(str(root / "topo.gfa"), gfa, 0.5, seed=4)
    graph = graph_from_gfa(gfa)
    index = Index.build(graph, K, 100, 100)
    reads = sample_reads(graph, 28, 100, seed=21, sub_rate=0.03)
    reads += [reads[0][:40] + "ACGTAC" + reads[0][40:], "N" * 100]
    queries = [QuerySequence.from_name_and_string(f"r{i}", s) for i, s in enumerate(reads)]
    per_read = Mapper(index, CPU, precision="exact").map_reads(queries)
    oriented = _oriented_chains(index, reads[:12])
    jgraph = jax_graph_from_gfa(gfa)
    return dict(root=root, graph=graph, index=index, per_read=per_read, oriented=oriented,
                jgraph=jgraph, jindex=JaxIndex.build(jgraph, K, 100, 100))


def _key(rng):
    return None if rng is None else (rng.orient.name, list(rng.handles), rng.label_trims)


def test_oriented_chains_cover_every_orient(world):
    orients = {PA.find_range_chain(world["index"], c).orient for c in world["oriented"]}
    assert orients == {PA.RangeOrient.REVERSE, PA.RangeOrient.BOTH}


def test_ranges_equal_jax(world):
    index, jindex = world["index"], world["jindex"]
    chains = [c for cs in world["per_read"] for c in cs if not c.is_placeholder]
    chains += world["oriented"]
    assert len(chains) >= 30
    n_corridor = n_trimmed = n_closed = 0
    for c in chains:
        jc = _jax_chain(c)
        base = PA.find_range_chain(index, c)
        assert _key(base) == _key(JPA.find_range_chain(jindex, jc))
        ext = PA.extend_range_chain(index, c, base)
        jext = JPA.extend_range_chain(jindex, jc, JPA.find_range_chain(jindex, jc))
        assert _key(ext) == _key(jext)
        closed = PA.close_bubbles(index, ext)
        assert _key(closed) == _key(JPA.close_bubbles(jindex, jext))
        n_closed += closed.handles != ext.handles
        cor = PA.find_range_chain_corridor(index, c)
        assert _key(cor) == _key(JPA.find_range_chain_corridor(jindex, jc))
        for rng, jrng in ((ext, jext), (closed, JPA.close_bubbles(jindex, jext)),
                          (cor, JPA.find_range_chain_corridor(jindex, jc))):
            if rng is not None:
                assert PA.find_nodes_edges(index, rng) == JPA.find_nodes_edges(jindex, jrng)
        n_corridor += cor is not None
        n_trimmed += bool(cor is not None and cor.label_trims)
    assert n_corridor >= 25 and n_trimmed >= 2 and n_closed >= 2


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_python_route_equals_native_extractor(world, mode):
    aligner = PA.PoaAligner(world["index"], CPU, **_MODES[mode])
    chains = [c for cs in world["per_read"] for c in aligner._chains_for_alignment(cs, 1)
              if not c.is_placeholder]
    chains += world["oriented"]
    sub = aligner._extract(chains)
    for i, c in enumerate(chains):
        rng = aligner._range_for_chain(c)
        nodes, edges = PA.find_nodes_edges(world["index"], rng)
        assert sub.handles(i) == rng.handles, i
        assert sub.nodes(i) == nodes, i
        assert sub.edges(i) == edges, i
        trims = rng.label_trims or {}
        lbase = sub.lbase[sub.handle_off[i] : sub.handle_off[i + 1]].tolist()
        assert lbase == [trims.get(h, (0, 0))[0] for h in rng.handles], i


def _gaf(alns):
    return [a.to_string() for a in alns]


@pytest.mark.parametrize("engine", ["abpoa", "rspoa"])
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_per_chain_api_equals_jax(world, engine, mode, tmp_path, monkeypatch):
    """``best_alignment_for_query`` read by read (which runs
    ``obtain_base_level_alignment`` on each chosen chain) with subgraph
    export on: GAF text and the written subgraph GFAs equal to JAX's."""
    kw = _MODES[mode]
    per_read = world["per_read"]
    port = PA.PoaAligner(world["index"], CPU, engine=PA.PoaEngine(engine), graph=world["graph"],
                         export_subgraphs=True, **kw)
    jax = JPA.PoaAligner(world["jindex"], JPA.PoaEngine(engine), graph=world["jgraph"],
                         export_subgraphs=True, **kw)
    out = {}
    for side, aligner, conv in (("port", port, lambda c: c), ("jax", jax, _jax_chain)):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        out[side] = _gaf(aligner.best_alignment_for_query([conv(c) for c in cs])
                         for cs in per_read)
        out[side + "_one"] = _gaf(aligner.obtain_base_level_alignment(conv(cs[0]))
                                  for cs in per_read[:4])
    assert out["port"] == out["jax"]
    assert out["port_one"] == out["jax_one"]
    assert sum("cs:Z:" in row or engine == "rspoa" for row in out["port"]) >= 25
    names = sorted(os.listdir(tmp_path / "port" / "subgraphs"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "subgraphs")) and len(names) >= 25
    for name in names:
        assert ((tmp_path / "port" / "subgraphs" / name).read_bytes()
                == (tmp_path / "jax" / "subgraphs" / name).read_bytes()), name


@pytest.mark.parametrize("engine", ["abpoa", "rspoa"])
def test_per_chain_api_equals_the_batch_route(world, engine):
    """The Python route on the host oracles against the native route on
    the kernels' CPU twins: the same GAF text for every read."""
    aligner = PA.PoaAligner(world["index"], CPU, engine=PA.PoaEngine(engine))
    per_read = world["per_read"]
    assert (_gaf(aligner.best_alignments_for_queries(per_read))
            == _gaf(aligner.best_alignment_for_query(cs) for cs in per_read))


def test_get_subgraph_paths_takes_a_range_or_its_handles(world):
    c = world["per_read"][0][0]
    rng = PA.find_range_chain_corridor(world["index"], c)
    assert (PA.get_subgraph_paths(world["graph"], rng)
            == PA.get_subgraph_paths(world["graph"], rng.handles)
            == JPA.get_subgraph_paths(world["jgraph"], _jax_chain_range(rng)))


def _jax_chain_range(rng):
    return JPA.OrientedGraphRange(orient=JPA.RangeOrient[rng.orient.name],
                                  handles=list(rng.handles), label_trims=rng.label_trims)


def test_default_device_without_a_card_is_an_error(world):
    """``Mapper(index)`` and ``PoaAligner(index)`` ask for the card; with
    none they raise the device module's RuntimeError (not a TypeError,
    and never a CPU run), as ``rank_device`` does for None and "cuda"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot be shown")
    for make in (lambda: Mapper(world["index"]), lambda: PA.PoaAligner(world["index"]),
                 lambda: rank_device(None, None), lambda: rank_device(None, "cuda")):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make()
    assert rank_device(None, "cpu") == CPU
