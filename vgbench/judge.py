"""Whether the window's output is correct, against the plain reference.

Once the window has closed and the program's state is freed:

  * ``reads_missing``: every read of the window has its rows in the
    chains GAF, in input order, and (when aligning) exactly one row in
    the alignments GAF, in order; the count of reads that do not;
  * ``chain_rows_differing``: the reads whose chains GAF rows differ
    from the reference's by any byte, over every read of the window, or
    over a sample drawn from the seed where the traffic names a size;
  * ``alignment_rows_differing``: the same for the alignments GAF row,
    over a sample drawn from the seed;
  * on abPOA, which exports the subgraph of each aligned chain to a GFA
    file of its own under ``./subgraphs``: ``export_files_wrong``, the
    reads of the chains comparison whose file is missing or that have a
    file the reference does not name, and ``export_gfa_differing``, the
    reads of the alignment sample whose file differs from the
    reference's by any byte.

Each is an exact comparison, limit 0.  With ``control`` set, the
reference computed in that lower arithmetic takes the program's place,
and the comparison has to fail.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, List, Optional, Set, Tuple

import numpy as np

from .reference import Reference

LIMITS = {"reads_missing": 0, "chain_rows_differing": 0, "alignment_rows_differing": 0,
          "export_files_wrong": 0, "export_gfa_differing": 0}
SUFFIX = "-subgraph-"


def _groups(path: str) -> Iterator[Tuple[bytes, bytes, int]]:
    """(read name, its rows, row count) of consecutive rows of one read."""
    with open(path, "rb") as fh:
        cur, buf = None, []
        for line in fh:
            name = line[: line.find(b"\t")]
            if name != cur:
                if cur is not None:
                    yield cur, b"".join(buf), len(buf)
                cur, buf = name, []
            buf.append(line)
        if cur is not None:
            yield cur, b"".join(buf), len(buf)


def _scan(path: str, names: List[str], keep: Set[str], one_row: bool):
    """(positions whose read is not the expected one or has the wrong
    number of rows, kept rows by name)."""
    bad: Set[int] = set()
    rows: Dict[str, bytes] = {}
    i = -1
    for i, (name, blob, n) in enumerate(_groups(path)):
        nm = name.decode()
        if i >= len(names) or nm != names[i] or (one_row and n != 1):
            bad.add(i)
        if nm in keep:
            rows[nm] = blob
    bad.update(range(i + 1, len(names)))
    return {j for j in bad if j < len(names)}, rows


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def judge(gfa: str, reads: List[Tuple[str, str]], chains_path: str,
          align_path: Optional[str], export_dir: str, traffic: dict, precision: str,
          engine: Optional[str], seed: int, control: Optional[str] = None) -> dict:
    """The checks, each with its number and limit, and the reads failed."""
    t0 = time.monotonic()
    names = [n for n, _ in reads]
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 0x6A756467])
    n_chain = traffic["chain_sample"]
    chain_idx = (np.arange(len(reads)) if not n_chain or n_chain >= len(reads)
                 else np.sort(rng.choice(len(reads), n_chain, replace=False)))
    n_aln = min(traffic["alignment_sample"], len(reads)) if engine else 0
    aln_idx = np.sort(rng.choice(len(reads), n_aln, replace=False)) if n_aln else \
        np.zeros(0, np.int64)
    chain_keep = {names[i] for i in chain_idx}
    aln_keep = {names[i] for i in aln_idx}

    bad_c, got_c = _scan(chains_path, names, chain_keep, one_row=False)
    bad_a, got_a = (set(), {})
    if engine:
        bad_a, got_a = _scan(align_path, names, aln_keep, one_row=True)
    missing = {names[i] for i in bad_c | bad_a}
    got_files = {}  # read -> its exported file names, for the reads compared
    if os.path.isdir(export_dir):
        for f in os.listdir(export_dir):
            nm = f.rsplit(SUFFIX, 1)[0]
            if nm in chain_keep or nm in aln_keep:
                got_files.setdefault(nm, set()).add(f)

    ref = Reference(gfa)
    idx = np.union1d(chain_idx, aln_idx)
    want = ref.rows([reads[i] for i in idx], precision, engine, aligned=aln_keep)
    if control:
        got = ref.rows([reads[i] for i in idx], control, engine, aligned=aln_keep)
        got_c = {n: got[n][0] for n in chain_keep}
        got_a = {n: got[n][1] for n in aln_keep}
        got_files = {n: set(r[2]) for n, r in got.items() if r[2]}

        def content(name, f):
            return got[name][2][f]
    else:
        def content(name, f):
            return _read(os.path.join(export_dir, f))
    diff_c = {n for n in chain_keep if got_c.get(n) != want[n][0]}
    diff_a = {n for n in aln_keep if got_a.get(n) != want[n][1]}
    checks = {
        "reads_missing": len(missing),
        "chain_rows_differing": len(diff_c),
        "alignment_rows_differing": len(diff_a),
    }
    diff_f = diff_g = set()
    if engine == "abpoa":
        diff_f = {n for n in chain_keep | aln_keep
                  if got_files.get(n, set()) != set(want[n][2])}
        diff_g = {n for n in aln_keep
                  if any(f in got_files.get(n, ()) and content(n, f) != b
                         for f, b in want[n][2].items())}
        checks["export_files_wrong"] = len(diff_f)
        checks["export_gfa_differing"] = len(diff_g)
    if not engine:
        del checks["alignment_rows_differing"]
    failed = missing | diff_c | diff_a | diff_f | diff_g
    return {
        "correct": all(v <= LIMITS[k] for k, v in checks.items()),
        "attempted": len(reads),
        "failed": len(failed),
        "checks": {k: {"value": v, "limit": LIMITS[k]} for k, v in checks.items()},
        "compared": {"chains": int(len(chain_idx)), "alignments": int(n_aln)},
        "examples": sorted(failed)[:3],
        "seconds": time.monotonic() - t0,
    }
