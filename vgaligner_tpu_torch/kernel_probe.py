"""Design choices timed on the card: the local cluster kernel's columns
a CTA, and the fast and exact chaining kernels against earlier versions.

    python -m vgaligner_tpu_torch.kernel_probe [--old-chain-dp PATH]
        [--old-chain-dp-exact PATH] [--old-local-warp PATH] [--reps 10]
        [--json PATH]

Maps chip_smoke.py's long reads (``testing.long_reads`` on
``write_synthetic_gfa`` seed 0, k = 11) on the card as the smoke's
long-read phase does: ``--precision fast`` mapping keeps the launch the
fast chaining kernel (kernels/csrc/chain_dp.cu) receives, and the rspoa
route (``--precision exact``) the launch the exact chaining kernel
(kernels/csrc/chain_dp_exact.cu) receives and the largest batch the
local cluster kernel (kernels/csrc/poa_local_cluster.cu) receives; and
the main path's anchors of 8,192 reads (``sample_reads`` seed 77, 100
bp, a_max 256).  Then it builds, with nvcc, one library a source text
into ``_build/probe/``:

  * ``slice2048``: poa_local_cluster.cu as it is (at most 2,048 columns a
    CTA: one CTA a problem at W 2,048), and ``slice1024`` and
    ``slice512``, edited copies with 1,024 and 512 (two and four CTAs a
    cluster at W 2,048); each is held against ``poa_local_plain`` on the
    batch, then all are timed in turns, each and then each in reverse
    order, ``--reps`` launches a turn through the C entry on buffers
    allocated once;
  * ``old_chain_dp``: the chain_dp.cu at PATH, another version of the
    kernel with the same C entry (the first port: that file from a
    checkout of an earlier commit).  It and the port's own kernel are
    held against ``chain_dp_plain``, then timed in turns (old, new, new,
    old) on the long-read launch and on the main path's shape, the first
    4,096 reads x 256 anchors;
  * ``old_chain_dp_exact``: the chain_dp_exact.cu at PATH, an earlier
    version with the same C entry (the one-warp-a-read plan: that file
    from a checkout of an earlier commit).  It and the port's own kernel
    are held against ``chain_dp_exact_plain`` bit for bit, then timed in
    turns (old, new, new, old) on the long-read launch and on the main
    path's 4,096 x 256 anchors (int64 tb/te), kernels alone through
    their C entries, then in turns on the first 512-8,192 of the main
    reads (the two keep different numbers of reads resident); in the
    same turns on both launches, the port's chain_dp_exact.cu with each
    of its design choices undone alone (``exact_variant_sources``),
    each held against the twin too;
  * ``old_local_warp``: the poa_local_warp.cu at PATH, an earlier version
    of the one-warp local POA kernel whose C entry takes no ``back_off``
    and whose backing store is a whole int16 plane [B, V, W] indexed by
    vertex (that file from a checkout of an earlier commit).  On the
    rspoa route's largest launch of the main reads (the first 8,192,
    mapped ``--precision exact``: 8,192 x V 256 x W 128, P 2) and on a
    far-heavy random batch (1,024 x V 256 x W 128, P 2, ``far_frac``
    0.3), it and the port's kernel (given the host's backing-row counts)
    are held against ``poa_local_plain`` bit for bit, timed in turns
    (old, new, new, old) through a wrapper (the parent's allocations and
    ``poa_local_warp``) and as kernels alone on buffers allocated once,
    and each wrapper's peak device memory above what was allocated
    before it is read (``reset_peak_memory_stats``,
    ``max_memory_allocated``).

Each section runs when its PATH is given; the local cluster kernel's
always does.

Every line carries the card's name and power limit; without a CUDA GPU it
exits with an error.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

K = 11
SLICES = (2048, 1024, 512)
_SLICE_LINE = "constexpr int SLICE = 2048;"


def slice_sources(src: str) -> dict:
    """poa_local_cluster.cu at each of SLICES columns a CTA, by name."""
    if _SLICE_LINE not in src:
        raise ValueError("poa_local_cluster.cu no longer has the line the probe edits")
    return {f"slice{s}": src.replace(_SLICE_LINE, f"constexpr int SLICE = {s};") for s in SLICES}


# chain_dp_exact.cu's design choices, each undone in an edited copy: the
# barrier id in a register (ptxas then reserves all 16 named barriers a
# block), no register cap, the consumer's first two f values loaded from
# the ring at their row, and term blocks of 6 and 24 rows at bw 50
_EXACT_EDITS = {
    "regbar": ('''  if (rib == 0)
    asm volatile("bar.sync 1, 64;" ::: "memory");
  else
    asm volatile("bar.sync 2, 64;" ::: "memory");''',
               '  asm volatile("bar.sync %0, 64;" ::"r"(1 + rib) : "memory");'),
    "nolb": ("__launch_bounds__(THREADS, MIN_BLOCKS)", "__launch_bounds__(THREADS)"),
    "ringload": ("const double f0 = gl == 0 ? fprev : rf0, f1 = rf1;",
                 "const double f0 = fr[(i - 1 - gl) & rmask], f1 = fr[(i - 33 - gl) & rmask];"),
    "rb6": ("c.rb = max(1, 640 / bw);", "c.rb = max(1, 320 / bw);"),
    "rb24": ("c.rb = max(1, 640 / bw);", "c.rb = max(1, 1280 / bw);"),
}


def exact_variant_sources(src: str) -> dict:
    """chain_dp_exact.cu with each of _EXACT_EDITS applied alone, by name."""
    out = {}
    for name, (old, new) in _EXACT_EDITS.items():
        if src.count(old) != 1:
            raise ValueError(f"chain_dp_exact.cu no longer has the text the {name} edit replaces")
        out[f"exact_{name}"] = src.replace(old, new)
    return out


def _captured_launches(dev, main_local: bool = False):
    """The long reads' fast and exact chaining launches (qb, tb, te,
    valid), the main path's anchors of 8,192 reads (the same, tb/te
    int64), the local cluster kernel's largest batch (vcodes, vpred, nv,
    q, nq) and, with ``main_local``, the one-warp local kernel's largest
    launch of the same 8,192 reads on the rspoa route ((vcodes, vpred,
    nv, q, nq), back_rows), else None."""
    from .graph import graph_from_gfa
    from .index import Index
    from .io.fastx import QuerySequence
    from .models.mapper import Mapper
    from .models.poa_aligner import PoaAligner, PoaEngine
    from .ops import chain as C
    from .ops import poa_device as PD
    from .testing import long_reads, sample_reads, write_synthetic_gfa

    work = tempfile.mkdtemp(prefix="vg_kernel_probe_")
    got: dict = {}
    real_k1, real_k5, real_k9 = C.chain_dp, C.chain_dp_exact, PD.poa_local_cluster
    real_k7 = PD.poa_local_warp

    def keep(name, size, real):
        def call(*args):
            if name not in got or size(args) > got[name][1]:
                got[name] = (args, size(args))
            return real(*args)
        return call

    try:
        gfa = os.path.join(work, "graph.gfa")
        write_synthetic_gfa(gfa, seed=0)
        graph = graph_from_gfa(gfa)
        index = Index.build(graph, K, 100, 100)
        qs = [QuerySequence(f"read{i}", r) for i, r in enumerate(long_reads(graph))]
        C.chain_dp = keep("k1", lambda a: a[0].numel(), real_k1)
        C.chain_dp_exact = keep("k5", lambda a: a[0].numel(), real_k5)
        PD.poa_local_cluster = keep("k9", lambda a: int(a[2].sum()) * a[3].shape[1], real_k9)
        Mapper(index, dev, precision="fast").map_reads(qs)
        chains = Mapper(index, dev, precision="exact").map_reads(qs)
        PoaAligner(index, dev, engine=PoaEngine.RSPOA).best_alignments_for_queries(chains)
        main_reads = sample_reads(graph, 12288, 100, seed=77)[:8192]
        main = _main_anchors(index, main_reads, dev)
        if main_local:
            PD.poa_local_warp = keep("k7", lambda a: a[0].shape[0], real_k7)
            chains = Mapper(index, dev, precision="exact").map_reads(
                [QuerySequence(f"read{i}", r) for i, r in enumerate(main_reads)])
            PoaAligner(index, dev, engine=PoaEngine.RSPOA).best_alignments_for_queries(chains)
    finally:
        C.chain_dp, C.chain_dp_exact, PD.poa_local_cluster = real_k1, real_k5, real_k9
        PD.poa_local_warp = real_k7
        shutil.rmtree(work, ignore_errors=True)
    k7 = (got["k7"][0][:5], got["k7"][0][5]) if main_local else None
    return got["k1"][0][:4], got["k5"][0][:4], main, got["k9"][0][:5], k7


def _main_anchors(index, reads, dev):
    """The main path's chaining input: ``reads`` encoded, looked up at
    a_max 256 and sorted (tb/te int64, as the exact kernel takes them)."""
    import torch

    from .index.device_index import device_index
    from .ops.chain import sort_anchors
    from .ops.encode import encode_reads_host, window_kmer_codes
    from .ops.lookup import lookup_and_materialize_anchors

    codes, lens = encode_reads_host(reads, 128)
    w, wv = window_kmer_codes(torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev), K)
    anchors = lookup_and_materialize_anchors(device_index(index, dev), w, wv, 256)
    _o, qb, tb, te, valid = sort_anchors(anchors.qb, anchors.tb, anchors.te, anchors.valid)
    return qb.contiguous(), tb.contiguous(), te.contiguous(), valid.contiguous()


def _holding(call, *buffers):
    """``call`` that holds ``buffers``, the tensors behind its pointers,
    for as long as it lives: a closure over the pointers alone would let
    the allocator hand their memory to the next tensor while the kernel
    still writes (or reads its offsets) there."""
    def run():
        call()
        return buffers

    return run


def _int32_anchors(args):
    """(qb, tb, te, valid) with tb/te as the fast kernel's int32."""
    import torch

    qb, tb, te, valid = args
    return qb, tb.to(torch.int32).contiguous(), te.to(torch.int32).contiguous(), valid


def _chain_launcher(entry, args):
    """A call of a ``vg_chain_dp`` C entry on ``args`` with outputs
    allocated once -> (call, (f, pred, curr_max))."""
    import torch

    from . import kernels

    qb, _tb, _te, _valid = args
    B, A = qb.shape
    dev = qb.device
    outs = (torch.empty((B, A), dtype=torch.int32, device=dev),
            torch.empty((B, A), dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev))
    ptrs = ([x.data_ptr() for x in args] + [B, A, K, 50, 1000] + [o.data_ptr() for o in outs]
            + [kernels.stream_ptr(dev)])
    return _holding(lambda: kernels.check(entry(*ptrs), "kernel_probe chain_dp"), outs), outs


def _exact_launcher(entry, args):
    """A call of a ``vg_chain_dp_exact`` C entry on ``args`` with the gap
    table and outputs allocated once -> (call, (f, pred, curr_max))."""
    import torch

    from . import kernels
    from .ops import chain as C

    qb, _tb, _te, _valid = args
    B, A = qb.shape
    dev = qb.device
    table = C.make_gap_cost_table(K, 1000)
    tab = C._device_gap_table(table, K, dev)
    outs = (torch.empty((B, A), dtype=torch.float64, device=dev),
            torch.empty((B, A), dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.float64, device=dev))
    div_once = int(C.exact_divide_once(A, K, table))
    ptrs = ([x.data_ptr() for x in args] + [tab.data_ptr(), B, A, K, 50, 1000, div_once]
            + [o.data_ptr() for o in outs] + [kernels.stream_ptr(dev)])

    return _holding(lambda: kernels.check(entry(*ptrs), "kernel_probe chain_dp_exact"),
                    tab, outs), outs


def _local_launcher(so, args):
    """A call of a ``vg_poa_local_cluster`` C entry on ``args`` with its
    buffers allocated once -> (call, (best, tape, tlen, qend, n_backing))."""
    import torch

    from . import kernels
    from .ops import poa_device as PD

    vcodes, vpred, nv, q, _nq = args
    B, V = vcodes.shape
    P, L = vpred.shape[-1], q.shape[1]
    dev = vcodes.device
    off = torch.from_numpy(PD._back_offsets(vpred, nv, None)).to(dev)
    scratch = (off, torch.empty((max(int(off[-1]), 1), L + 1), dtype=torch.int16, device=dev),
               torch.empty((B, V, L + 1), dtype=torch.uint8, device=dev))
    outs = (torch.empty(B, dtype=torch.float32, device=dev),
            torch.empty((B, L + 1), dtype=torch.int32, device=dev),
            *(torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)))
    ptrs = ([x.data_ptr() for x in args[:4]] + [B, V, P, L]
            + [x.data_ptr() for x in scratch + outs] + [kernels.stream_ptr(dev)])
    return _holding(lambda: kernels.check(so.vg_poa_local_cluster(*ptrs), "kernel_probe local"),
                    scratch, outs), outs


def _warp_launcher(entry, args, back, old):
    """A call of a ``vg_poa_local_warp`` C entry on ``args`` with its
    buffers allocated once -> (call, (best, tape, tlen, qend, n_backing)):
    with ``old``, the earlier entry (no back_off; a whole int16 plane
    [B, V, W]), else the port's (the ``back`` rows the host counted)."""
    import torch

    from . import kernels
    from .ops import poa_device as PD

    vcodes, vpred, nv, q, _nq = args
    B, V = vcodes.shape
    P, L = vpred.shape[-1], q.shape[1]
    dev = vcodes.device
    if old:
        scratch = (torch.empty((B, V, L + 1), dtype=torch.int16, device=dev),
                   torch.empty((B, V, L + 1), dtype=torch.uint8, device=dev))
    else:
        off = torch.from_numpy(PD._back_offsets(vpred, nv, back)).to(dev)
        scratch = (off, torch.empty((max(int(off[-1]), 1), L + 1), dtype=torch.int16, device=dev),
                   torch.empty((B, V, L + 1), dtype=torch.uint8, device=dev))
    outs = (torch.empty(B, dtype=torch.float32, device=dev),
            torch.empty((B, L + 1), dtype=torch.int32, device=dev),
            *(torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)))
    ptrs = ([x.data_ptr() for x in args[:4]] + [B, V, P, L]
            + [x.data_ptr() for x in scratch + outs] + [kernels.stream_ptr(dev)])
    return _holding(lambda: kernels.check(entry(*ptrs), "kernel_probe local warp"),
                    scratch, outs), outs


def _old_warp_wrapper(entry, args):
    """The earlier ``poa_local_warp`` wrapper on ``entry``: its buffers,
    the whole int16 plane [B, V, W] among them, allocated at each call ->
    (best, tape, tlen, qend, n_backing)."""
    import torch

    from . import kernels

    vcodes, vpred, nv, q, _nq = args
    B, V = vcodes.shape
    P, L = vpred.shape[-1], q.shape[1]
    dev = vcodes.device
    bufs = (torch.empty((B, V, L + 1), dtype=torch.int16, device=dev),
            torch.empty((B, V, L + 1), dtype=torch.uint8, device=dev),
            torch.empty(B, dtype=torch.float32, device=dev),
            torch.empty((B, L + 1), dtype=torch.int32, device=dev),
            *(torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)))
    kernels.check(entry(*(x.data_ptr() for x in args[:4]), B, V, P, L,
                        *(x.data_ptr() for x in bufs), kernels.stream_ptr(dev)),
                  "kernel_probe old local warp")
    return bufs[2:]


def _peak_bytes(fn) -> int:
    """Device memory ``fn()`` allocates at its peak above what was
    allocated before it, its outputs held until the peak is read."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak


def _local_warp_section(old_entry, main_k7, card, reps, out):
    """The one-warp local kernel against the version at PATH (module
    docstring) on the main reads' rspoa launch ``main_k7`` ((args,
    back_rows)) and on a far-heavy random batch."""
    import numpy as np
    import torch

    from . import kernels
    from .ops import poa_device as PD
    from .poa_cluster_probe import _ms
    from .testing import random_local_batch, with_local_edge_cases

    dev = main_k7[0][0].device
    far = [torch.from_numpy(a).to(dev) for a in with_local_edge_cases(
        random_local_batch(1303, 1024, 256, 2, 127, far_frac=0.3))]
    far_back = PD.backing_rows_plain(far[1], far[2], PD.LOCAL_RING, PD.LOCAL_PINS).cpu().numpy()
    new_entry = kernels.lib().vg_poa_local_warp
    for label, (args, back) in (("main", main_k7), ("far", (far, far_back))):
        back = np.asarray(back)
        want = (*PD.poa_local_plain(*args),
                PD.backing_rows_plain(args[1], args[2], PD.LOCAL_RING, PD.LOCAL_PINS))
        wrappers = {"old": lambda: _old_warp_wrapper(old_entry, args),
                    "new": lambda: PD.poa_local_warp(*args, back)}
        alone = {}
        for name, entry in (("old", old_entry), ("new", new_entry)):
            _held(f"poa_local_warp ({name}) through its wrapper on the {label} launch",
                  wrappers[name](), want)
            call, got = _warp_launcher(entry, args, back, name == "old")
            call()
            _held(f"poa_local_warp ({name}) alone on the {label} launch", got, want)
            alone[name] = call
        ms = {"wrapper": _turns(wrappers, reps), "alone": _turns(alone, reps)}
        off = PD._back_offsets(args[1], args[2], back)
        ms["offsets"] = _ms(lambda: PD._pinned_offsets(off, dev), reps)
        peak = {name: _peak_bytes(fn) for name, fn in wrappers.items()}
        B, V = args[0].shape
        W, P = args[3].shape[1] + 1, args[1].shape[-1]
        rows = int(back.sum())
        out[f"local_warp_{label}"] = {
            "B": B, "V": V, "W": W, "P": P, "nv_mean": float(args[2].float().mean()),
            "backing_rows": rows, "backing_problems": int((back > 0).sum()),
            "plane_bytes": 2 * B * V * W, "rows_bytes": 2 * W * rows, "ms": ms,
            "peak_bytes": peak,
            "problem_bytes": int(PD.local_problem_bytes(V, W, P, back).sum())}
        r = out[f"local_warp_{label}"]
        print(f"[probe] poa_local_warp on the {label} launch B {B} x V {V} x W {W}, P {P} (nv mean "
              f"{r['nv_mean']:.2f}), {rows} backing rows in {r['backing_problems']} problems: old "
              f"and new equal to the twin bit for bit; in turns (old, new, new, old) through the "
              f"wrappers {ms['wrapper']['old'][0]:.4f}, {ms['wrapper']['new'][0]:.4f}, "
              f"{ms['wrapper']['new'][1]:.4f}, {ms['wrapper']['old'][1]:.4f} ms, kernels alone "
              f"{ms['alone']['old'][0]:.4f}, {ms['alone']['new'][0]:.4f}, "
              f"{ms['alone']['new'][1]:.4f}, {ms['alone']['old'][1]:.4f} ms; the new wrapper's "
              f"offsets alone (pinned copy, {4 * (B + 1)} B) {ms['offsets']:.4f} ms; peak device "
              f"memory "
              f"old {peak['old']} B, new {peak['new']} B (old - new {peak['old'] - peak['new']}; "
              f"the old plane {r['plane_bytes']} less the counted rows {r['rows_bytes']} = "
              f"{r['plane_bytes'] - r['rows_bytes']}); local_problem_bytes {r['problem_bytes']} "
              f"({card})")


def _held(label, got, want):
    import torch

    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"kernel_probe: {label} differs from its plain twin")


def _turns(calls: dict, reps: int) -> dict:
    """Each call timed in turns, in order and then in reverse -> {name:
    [ms, ms]}."""
    from .poa_cluster_probe import _ms

    out: dict = {}
    for name in list(calls) + list(calls)[::-1]:
        out.setdefault(name, []).append(_ms(calls[name], reps))
    return out


def _exact_section(old_entry, variants, long_k5, main8, card, reps, out):
    """The exact chaining kernel against the version at PATH and its
    edited copies ``variants`` (module docstring); ``main8`` the anchors
    of 8,192 main reads."""
    import torch

    from . import kernels
    from .ops import chain as C

    table = C.make_gap_cost_table(K, 1000)
    entries = {"old": old_entry, "new": kernels.lib().vg_chain_dp_exact}
    main_k5 = [x[:4096].contiguous() for x in main8]
    everyone = {**entries, **variants}
    for label, k5 in (("long", long_k5), ("main", main_k5)):
        want = C.chain_dp_exact_plain(*k5, K, 50, table)
        calls = {}
        for name, entry in everyone.items():
            call, got = _exact_launcher(entry, k5)
            call()
            _held(f"chain_dp_exact ({name}) on the {label} launch",
                  [g.view(torch.int64) if g.dtype == torch.float64 else g for g in got],
                  [w.view(torch.int64) if w.dtype == torch.float64 else w for w in want])
            calls[name] = call
        ms = _turns(calls, reps)
        Bk, A = k5[0].shape
        rows = int((torch.where(k5[3], torch.arange(A, device=k5[3].device), -1).max(dim=1)
                    .values + 1).max())
        out[f"chain_exact_{label}"] = {"B": Bk, "A": A, "rows": rows, "ms": ms}
        print(f"[probe] chain_dp_exact on the {label} launch B {Bk} x A {A} ({rows} rows to the "
              f"last valid anchor at most): both equal to the twin bit for bit; kernels alone in "
              f"turns old {ms['old'][0]:.4f}, new {ms['new'][0]:.4f}, new {ms['new'][1]:.4f}, "
              f"old {ms['old'][1]:.4f} ms; us a row of the longest read: old "
              f"{ms['old'][0] * 1e3 / rows:.3f}/{ms['old'][1] * 1e3 / rows:.3f}, new "
              f"{ms['new'][0] * 1e3 / rows:.3f}/{ms['new'][1] * 1e3 / rows:.3f}; edited copies, "
              f"in the same turns: " + ", ".join(
                  f"{v} {ms[v][0]:.4f}/{ms[v][1]:.4f}" for v in variants) + f" ({card})")
    sweep = {}
    for B in (512, 1024, 2048, 4096, 6144, 8192):
        part = [x[:B].contiguous() for x in main8]
        sweep[B] = _turns({n: _exact_launcher(e, part)[0] for n, e in entries.items()}, reps)
    occ = C.chain_dp_exact_occupancy(50)
    out["chain_exact_sweep"] = sweep
    out["chain_exact_occupancy"] = occ
    print(f"[probe] chain_dp_exact in turns on the first B of 8,192 main reads (B: old, new, "
          f"new, old ms): " + "; ".join(
              f"{B}: {v['old'][0]:.4f}, {v['new'][0]:.4f}, {v['new'][1]:.4f}, {v['old'][1]:.4f}"
              for B, v in sweep.items()) + f"; new: {occ['blocks_an_sm']} blocks an SM of "
          f"{occ['reads_a_block']} reads, {occ['smem']} B a block ({card})")


def main(argv=None) -> dict:
    import torch

    from . import kernels
    from .kernels import BUILD_DIR, CSRC
    from .ops import chain as C
    from .ops import poa_device as PD
    from .poa_cluster_probe import _build

    ap = argparse.ArgumentParser(prog="python -m vgaligner_tpu_torch.kernel_probe")
    ap.add_argument("--old-chain-dp",
                    help="another version of kernels/csrc/chain_dp.cu to time against")
    ap.add_argument("--old-chain-dp-exact",
                    help="another version of kernels/csrc/chain_dp_exact.cu to time against")
    ap.add_argument("--old-local-warp",
                    help="another version of kernels/csrc/poa_local_warp.cu to time against")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", dest="json_path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: needs a CUDA GPU (torch.cuda.is_available() is False)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    with open(os.path.join(CSRC, "poa_local_cluster.cu")) as fh:
        sources = slice_sources(fh.read())
    for name, path in (("old_chain_dp", args.old_chain_dp),
                       ("old_chain_dp_exact", args.old_chain_dp_exact),
                       ("old_local_warp", args.old_local_warp)):
        if path:
            with open(path) as fh:
                sources[name] = fh.read()
    if args.old_chain_dp_exact:
        with open(os.path.join(CSRC, "chain_dp_exact.cu")) as fh:
            sources.update(exact_variant_sources(fh.read()))
    libs = _build(sources, os.path.join(BUILD_DIR, "probe"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (so, _regs) in libs.items():
        if name == "old_chain_dp":
            so.vg_chain_dp.argtypes = [vp] * 4 + [ci] * 5 + [vp] * 4
            so.vg_chain_dp.restype = ci
        elif name.startswith(("old_chain_dp_exact", "exact_")):
            so.vg_chain_dp_exact.argtypes = [vp] * 5 + [ci] * 6 + [vp] * 4
            so.vg_chain_dp_exact.restype = ci
        elif name == "old_local_warp":
            so.vg_poa_local_warp.argtypes = [vp] * 4 + [ci] * 4 + [vp] * 8
            so.vg_poa_local_warp.restype = ci
        else:
            so.vg_poa_local_cluster.argtypes = [vp] * 4 + [ci] * 4 + [vp] * 9
            so.vg_poa_local_cluster.restype = ci
    long_k1, long_k5, main8, batch, main_k7 = _captured_launches(dev, bool(args.old_local_warp))
    out = {"card": card, "registers": {n: regs for n, (_so, regs) in libs.items()}}

    # the local cluster kernel's columns a CTA
    B, V = batch[0].shape
    W, P = batch[3].shape[1] + 1, batch[1].shape[-1]
    want = (*PD.poa_local_plain(*batch),
            PD.backing_rows_plain(batch[1], batch[2], PD.LOCAL_RING, PD.LOCAL_PINS))
    calls = {}
    for s in SLICES:
        call, got = _local_launcher(libs[f"slice{s}"][0], batch)
        call()
        _held(f"the local cluster kernel at {s} columns a CTA", got, want)
        calls[s] = call
    out["local"] = {"B": B, "V": V, "W": W, "P": P, "nv_mean": float(batch[2].float().mean()),
                    "ms": _turns(calls, args.reps)}
    print(f"[probe] local cluster kernel on the long reads' largest rspoa batch B {B} V {V} W {W} "
          f"P {P} (nv mean {out['local']['nv_mean']:.1f}), each width equal to the twin; columns "
          "a CTA in turns, kernels alone: " + ", ".join(
              f"{s}: {ms[0]:.4f}/{ms[1]:.4f}" for s, ms in out["local"]["ms"].items())
          + f" ms ({card})")

    # the fast chaining kernel against the version at PATH
    if args.old_chain_dp:
        main_k1 = _int32_anchors([x[:4096].contiguous() for x in main8])
        for label, k1 in (("long", long_k1), ("main", main_k1)):
            want = C.chain_dp_plain(*k1, K, 50, 1000)
            calls = {}
            for name, entry in (("old", libs["old_chain_dp"][0].vg_chain_dp),
                                ("new", kernels.lib().vg_chain_dp)):
                call, got = _chain_launcher(entry, k1)
                call()
                _held(f"chain_dp ({name}) on the {label} launch", got, want)
                calls[name] = call
            ms = _turns(calls, args.reps)
            Bk, A = k1[0].shape
            out[f"chain_{label}"] = {"B": Bk, "A": A, "ms": ms}
            print(f"[probe] chain_dp on the {label} launch B {Bk} x A {A}: both equal to the twin; "
                  f"in turns old {ms['old'][0]:.4f}, new {ms['new'][0]:.4f}, new "
                  f"{ms['new'][1]:.4f}, old {ms['old'][1]:.4f} ms ({card})")
    # the exact chaining kernel against the version at PATH
    if args.old_chain_dp_exact:
        variants = {n[len("exact_"):]: libs[n][0].vg_chain_dp_exact
                    for n in libs if n.startswith("exact_")}
        _exact_section(libs["old_chain_dp_exact"][0].vg_chain_dp_exact, variants, long_k5, main8,
                       card, args.reps, out)
        print("[probe] ptxas (<false>, <true>): " + "; ".join(
            f"{n}: " + ", ".join(out["registers"][n])
            for n in ["old_chain_dp_exact", *(f"exact_{v}" for v in variants)]))
    # the one-warp local kernel against the version at PATH
    if args.old_local_warp:
        _local_warp_section(libs["old_local_warp"][0].vg_poa_local_warp, main_k7, card,
                            args.reps, out)
    if args.json_path:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_path)), exist_ok=True)
        with open(args.json_path, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
