"""The window's thread cut into stretches, each labelled by the innermost
span open there.

``trace.reduce_trace`` credits an idle interval to every span open on
the window's thread.  That is right while spans never nest, as the
harness's own do not; once the program's spans sit inside them
(``aligner.export`` inside ``aligner.begin``), the same idle time is
counted under both.  Crediting each idle stretch to the label of the
``innermost_segments`` stretch it falls in counts it once, and gives
``reduce_trace``'s labels where spans do not nest.  ``reduce_trace``
does not call this yet: its idle loop is to take it in place of its
``covered`` list (PERF.md, open questions).
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def innermost_segments(spans: List[Tuple[float, float, str]], lo: float,
                       hi: float) -> List[Tuple[float, float, Optional[str]]]:
    """[lo, hi] cut into (start, end, label) stretches, each labelled by
    the innermost of ``spans`` (start, end, name) open there, None where
    none is.  Spans of one thread nest; a child that ends a rounding
    error after its parent keeps that sliver."""
    out: List[Tuple[float, float, Optional[str]]] = []
    stack: List[Tuple[float, str]] = []  # (end, name), innermost last
    t = lo

    def upto(x: float) -> None:
        nonlocal t
        if x > t:
            out.append((t, x, stack[-1][1] if stack else None))
            t = x

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        while stack and stack[-1][0] <= a:
            upto(stack[-1][0])
            stack.pop()
        upto(a)
        stack.append((b, name))
    while stack:
        upto(stack[-1][0])
        stack.pop()
    upto(hi)
    return out
