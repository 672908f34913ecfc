"""GAF path-Jaccard comparison (a copy of the JAX package's
``experiments/gafcompare.py``, which imports nothing of JAX).

Behavioral reference: the reference's experiments-snakemake/gafcompare.py
(:31-73): per reference read present in the query GAF, compare the
signed node-id lists parsed from the path column; exact match scores
1.0, otherwise the Jaccard of the half-open [min, max) signed-id ranges.
The variants gafcompareVG.py / gafcompareGraphaligner.py differ only in
how many GAF columns pandas is told to expect; this implementation
parses whole lines and is column-count agnostic.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_NODE_RE = re.compile(r"(>|<)([0-9]+)")


def parse_gaf_paths(path: str) -> Dict[str, List[int]]:
    """read name -> signed node ids of the FIRST record per read."""
    out: Dict[str, List[int]] = {}
    with open(path) as fh:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 6:
                continue
            name = cols[0]
            if name in out:
                continue  # .iloc[0] semantics: first record wins
            out[name] = signed_ids(cols[5])
    return out


def signed_ids(path_col: str) -> List[int]:
    return [
        int(nid) if orient == ">" else -int(nid)
        for orient, nid in _NODE_RE.findall(path_col)
    ]


def path_jaccard(query: List[int], ref: List[int]) -> float:
    """gafcompare.py:53-67 — exact match 1.0, else range Jaccard."""
    if query == ref:
        return 1.0
    if not query or not ref:
        return 0.0
    q_min, q_max = min(query), max(query)
    r_min, r_max = min(ref), max(ref)
    inter = max(0, min(q_max, r_max) - max(q_min, r_min))
    union = max(q_max, r_max) - min(q_min, r_min)
    return inter / union if union else 0.0


@dataclass
class CompareResult:
    reads_found: int
    total_ref_reads: int
    jaccards: List[float] = field(default_factory=list)

    @property
    def avg_jaccard(self) -> float:
        return sum(self.jaccards) / len(self.jaccards) if self.jaccards else 0.0

    @property
    def exact_rate(self) -> float:
        if not self.jaccards:
            return 0.0
        return sum(1 for j in self.jaccards if j == 1.0) / len(self.jaccards)


def compare_gaf(query_gaf: str, ref_gaf: str) -> CompareResult:
    """Compare two GAF files by read name (gafcompare.py:31-73)."""
    q = parse_gaf_paths(query_gaf)
    r = parse_gaf_paths(ref_gaf)
    res = CompareResult(reads_found=0, total_ref_reads=len(r))
    for name, ref_ids in r.items():
        if name not in q:
            continue
        res.reads_found += 1
        res.jaccards.append(path_jaccard(q[name], ref_ids))
    return res


def compare_paths(
    query: Dict[str, List[int]], ref: Dict[str, List[int]]
) -> CompareResult:
    """In-memory variant of compare_gaf."""
    res = CompareResult(reads_found=0, total_ref_reads=len(ref))
    for name, ref_ids in ref.items():
        if name not in query:
            continue
        res.reads_found += 1
        res.jaccards.append(path_jaccard(query[name], ref_ids))
    return res


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Compare two GAFs given as input.")
    ap.add_argument("GAF1", help="Path to the first GAF file")
    ap.add_argument("REF", help="Path to the reference GAF file")
    args = ap.parse_args(argv)
    res = compare_gaf(args.GAF1, args.REF)
    print(f"Matching reads: {res.reads_found}/{res.total_ref_reads}")
    print(f"AVG Jaccard is: {res.avg_jaccard}")
    print("Jaccard list is: \n {}".format(",".join(str(v) for v in res.jaccards)))


if __name__ == "__main__":
    main()
