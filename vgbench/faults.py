"""Faults planted under a run to show that ``correct`` sees them.

Only the tests plant them (``run.execute(..., fault=name)``); a
benchmark run never does.  Each breaks the timed path where its output
is made:

  * ``answer_altered``: the first read of each batch gets one anchor of
    its first chain moved by one base, as the mapper hands it on;
  * ``half_batch``: the mapper returns the chains of the first half of
    each batch only, so the rest are never written;
  * ``no_exchange``: rank 0 merges its own rows only (the collectives
    still run on every rank, so no rank waits);
  * ``export_skipped``: the abPOA aligner writes no subgraph GFA;
  * ``export_altered``: every tenth subgraph GFA gets the first base of
    its first node changed as it is written.
"""

from __future__ import annotations


def _answer_altered(mapper, aligner, mesh) -> None:
    fn = mapper.map_reads if aligner is not None else mapper.finish_map

    def altered(arg, *a, **kw):
        out = fn(arg, *a, **kw)
        for chains in out[:1]:
            c = chains[0]
            if not c.is_placeholder and c.n_anchors:
                c.atb = c.atb.copy()
                c.ate = c.ate.copy()
                c.atb[-1] += 1
                c.ate[-1] += 1
        return out

    setattr(mapper, "map_reads" if aligner is not None else "finish_map", altered)


def _half_batch(mapper, aligner, mesh) -> None:
    name = "map_reads" if aligner is not None else "begin_map"
    fn = getattr(mapper, name)

    def half(queries, *a, **kw):
        return fn(queries[: (len(queries) + 1) // 2], *a, **kw)

    setattr(mapper, name, half)


def _no_exchange(mapper, aligner, mesh) -> None:
    if mesh is None or mesh.rank != 0:
        return
    from vgaligner_tpu_torch.parallel import mesh as mesh_mod

    gather = mesh_mod.Mesh.gather_bytes

    def own_rows(self, blob: bytes, n_items: int = 0):
        got = gather(self, blob, n_items)
        return None if got is None else (n_items, blob)

    mesh_mod.Mesh.gather_bytes = own_rows


def _export_skipped(mapper, aligner, mesh) -> None:
    aligner.export_subgraphs = False


def _export_altered(mapper, aligner, mesh) -> None:
    from vgaligner_tpu_torch.io import validate

    begin = aligner.begin_alignments
    write = validate.export_gfa
    count = [0]

    def altered(content: str, file_name: str, *a, **kw):
        count[0] += 1
        if count[0] % 10 == 1:
            i = content.index("\nS\t1\t") + 5
            content = content[:i] + ("A" if content[i] != "A" else "C") + content[i + 1:]
        return write(content, file_name, *a, **kw)

    def begin_altered(*a, **kw):
        # the aligner looks the writer up at each call: swap it for the call only
        validate.export_gfa = altered
        try:
            return begin(*a, **kw)
        finally:
            validate.export_gfa = write

    aligner.begin_alignments = begin_altered


INSTALL = {"answer_altered": _answer_altered, "half_batch": _half_batch,
           "no_exchange": _no_exchange, "export_skipped": _export_skipped,
           "export_altered": _export_altered}
