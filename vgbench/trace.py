"""Spans around the program's layers, and the reduction of a profiler
trace to device time.

``Spans`` wraps methods of the program's instances (and the harness's
own write callbacks) so each call records its layer, thread and host
interval; inside a profiled run each span is also a
``torch.profiler.record_function`` annotation, so the trace shows what
the host was doing.  A call made while a span of the same layer is open
on the thread is not counted twice.

``reduce_trace`` reads the Chrome trace torch.profiler exports: kernels,
copies and sets on the card inside the traced window, their union (busy
time), the kernels' time by name and by family, and the idle time
labelled by the span open on the main thread.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import threading
import time
from typing import Dict, List, Tuple

WINDOW = "vgbench.window"
MAIN_WAIT = "stream.wait"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel families by the __global__ function's name (kernels/csrc/*.cu)
FAMILIES = {
    "chain": re.compile(r"\b(chain_dp_kernel|chain_dp_exact_kernel)\b"),
    "poa": re.compile(r"\b(poa_dp_tb_kernel|poa_dp_tb_cluster_kernel|"
                      r"poa_local_warp_kernel|poa_local_cluster_kernel)\b"),
}


class Spans:
    """Host spans by layer; ``annotate`` makes each a profiler range too."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.records: List[Tuple[str, int, float, float]] = []  # layer, thread, t0, t1
        self._open = threading.local()
        self._lock = threading.Lock()
        self.main = threading.get_ident()

    @contextlib.contextmanager
    def span(self, layer: str):
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        if layer in stack:
            yield
            return
        stack.append(layer)
        ctx = contextlib.nullcontext()
        if self.annotate:
            from torch.profiler import record_function

            ctx = record_function(layer)
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            t1 = time.perf_counter()
            stack.pop()
            with self._lock:
                self.records.append((layer, threading.get_ident(), t0, t1))

    def wrap(self, obj, method: str, layer: str) -> None:
        """Record every call of ``obj.method`` as a span of ``layer``."""
        fn = getattr(obj, method)

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with self.span(layer):
                return fn(*a, **kw)

        setattr(obj, method, wrapped)

    def totals(self, t0: float, t1: float, main_only: bool = False) -> Dict[str, float]:
        """Seconds by layer of the spans inside [t0, t1]."""
        out: Dict[str, float] = {}
        for layer, tid, a, b in self.records:
            if main_only and tid != self.main:
                continue
            a, b = max(a, t0), min(b, t1)
            if b > a:
                out[layer] = out.get(layer, 0.0) + (b - a)
        return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace noise and
    arguments, at most 100 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:100]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_trace(path: str) -> dict:
    """Seconds of device activity in the traced window (the ``vgbench.window``
    annotation): ``window_s``, ``busy_s`` (union of kernels, copies and
    sets), ``kernel_s`` by family, ``device_ops`` (kernel and copy time
    by name, most first) and ``idle_by_host`` (idle seconds by the span
    open on the window's thread, ``stream.wait`` where none is)."""
    with open(path) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
           and e.get("cat") in ("user_annotation", "cpu_op", None)]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w = max(win, key=lambda e: float(e.get("dur", 0)))
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    main_tid = w.get("tid")
    dev: List[Tuple[float, float]] = []
    by_name: Dict[str, float] = {}
    fam: Dict[str, float] = {k: 0.0 for k in FAMILIES}
    fam_n: Dict[str, int] = {k: 0 for k in FAMILIES}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        if b <= lo or a >= hi:
            continue
        a, b = max(a, lo), min(b, hi)
        dev.append((a, b))
        name = short_name(e.get("name", "?"))
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        if e.get("cat") == "kernel":
            for k, rx in FAMILIES.items():
                if rx.search(name):
                    fam[k] += (b - a) * 1e-6
                    fam_n[k] += 1
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    # host labels: the harness's spans on the window's thread
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]) for e in events
             if e.get("ph") == "X" and e.get("tid") == main_tid
             and e.get("cat") == "user_annotation" and e.get("name") != WINDOW]
    spans = sorted((a, b, n) for a, b, n in spans if b > lo and a < hi)
    idle = []
    prev = lo
    for a, b in busy:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        idle.append((prev, hi))
    idle_by: Dict[str, float] = {}
    for a, b in idle:
        covered = []
        for sa, sb, n in spans:
            ca, cb = max(a, sa), min(b, sb)
            if cb > ca:
                covered.append((ca, cb, n))
        taken = 0.0
        for ca, cb, n in covered:
            idle_by[n] = idle_by.get(n, 0.0) + (cb - ca) * 1e-6
            taken += cb - ca
        rest = (b - a) - taken
        if rest > 0:
            idle_by[MAIN_WAIT] = idle_by.get(MAIN_WAIT, 0.0) + rest * 1e-6
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy_s,
        "kernel_s": fam,
        "kernel_launches": fam_n,
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_by_host": sorted(([n, s] for n, s in idle_by.items()), key=lambda x: -x[1])[:10],
    }
