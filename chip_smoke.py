#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vgaligner_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is not 0:

  1. environment: torch, CUDA and nvcc versions, and the card's name and
     power limit as nvidia-smi reports them;
  2. build: nvcc compiles the kernels from kernels/csrc (one process per
     source, in parallel) into vgaligner_tpu_torch/_build/;
  3. kernels against their plain PyTorch twins on the same CUDA tensors
     (tolerance 0: every value is an integer, an integer-valued f32, or
     an f64 compared as its int64 bit pattern):
       K1 chaining DP (fast) at the main path's shape (4,096 reads x 256
       anchors of real reads) and at A = 16,384 and 65,536; the gap cost
       for g = 0..1000;
       K2 POA DP and K3 traceback on random DAG batches (P in 2/4/8, W in
       128/256, V in 256/2048), at W 2,048/4,096/8,192 (V 256/2048), at
       W 16,384 (the one width of the CLI's ladder they still take; B 4,
       timed), and at the main path's chunk shape (1,024 x 256 x 128);
       K6, the POA DP and traceback in one kernel for rows up to 256
       columns, on batches with far predecessors and more far-referenced
       vertices than it pins (its backing store), P 2/4/8 x W 32/128/256,
       and at the main path's chunk shape, then timed against K2 + K3 on
       the same CUDA tensors in turns (K2 + K3, K6, K6, K2 + K3); the
       lane-padded contract of the JAX package's VMEM-resident Pallas DP
       (poa_global_kernel, 1,024 x 256, L 100), which K6 now runs;
       K8, the POA DP and traceback in one kernel for rows of 512-8,192
       columns, one thread-block cluster a problem, at every width of
       CLUSTER_WIDTHS x P 2/4/8 (V 256, 128 at W 8,192) and at V 8,192 x W
       2,048 and W 8,192 x V 1,024, on batches with far predecessors, pin
       overflow, a predecessor at and past its vertex and nv = 4; its
       cluster size, clusters resident, shared memory a CTA, and ptxas
       registers and spills;
       K4 local POA, one block a problem, on random batches (P 2/4/8, W
       128/256/2048, V 256/2048, problems with no positive cell and
       nv < V), and held and timed at W 16,384, the one width it takes;
       K7 local POA, one warp a problem, for rows up to 256 columns, on
       P 2/4/8 x W 32/64/128/256 x V 64/256/2,048 batches with far
       predecessors past its ring, problems over its pin budget (its
       backing store), a predecessor at and past its vertex, nv far
       below V and nv = 0; its ptxas registers and spills, and its
       occupancy at the rspoa batch shape;
       K9 local POA, one thread-block cluster a problem, for rows of
       512-8,192 columns, at every width x P 2/4/8 with far predecessors,
       pin overflow, a predecessor at and past its vertex and nv = 4 and
       0, and on chains whose best run takes a far edge (pinned, and on
       the backing store) where a CTA's columns start (W 4,096 and
       8,192); its occupancy and ptxas report;
       K5 exact chaining DP on the real anchors at 4,096 x 256 and at
       A = 16,384 and 65,536, then both of its paths (one divide a row;
       one a pair, which a gap table with a negative entry or with scores
       past its 2^41 bound takes) on the real anchors and on reads whose
       valid anchors are scattered, timed at 4,096 x 256 beside K1;
  4. the main path through the CLI entry points: ``index -k 11`` and
     ``map -p abpoa -D -G --precision auto`` over 12,288 100 bp reads of
     a seeded HLA-scale synthetic graph (4,760 nodes, 12 haplotypes):
     K1 and K6 launched (K6 12 times), K2 and K3 not; the chunks' mean
     nv and how many problems took K6's backing store; K6 held against
     K2 + K3 and timed on the largest of those chunks; the first 256
     reads again with ``--device cpu --precision fast`` (the plain
     twins), and both GAFs byte-identical for those reads;
  5. the rspoa path: ``map -p rspoa -D -G --precision exact`` over the
     same reads: K7 and K5 launched, K4, K1 and K2 not, no subgraph GFA
     written, 95 % of reads aligned, and the first 256 reads
     byte-identical to ``--device cpu --precision exact``; on the
     largest batch that run gave the local POA, K7 is held against its
     twin and K4 and K7 are timed in turns (K4, K7, K7, K4), through
     their wrappers and as the kernel alone on buffers allocated once;
  6. long reads: ``map -p abpoa -D -G --precision fast`` over 64 reads
     of 1,500-2,100 bp and one 10 kb read (POA rows of W 2,048/4,096 on
     K8, not K2, K3 or K6, and a subgraph over 8,192 vertices on the
     native host POA), both GAFs byte-identical to ``--device cpu``; K1
     held and timed on the launch that run gave it; K8 held against the
     plain pair on every chunk that run gave it, and K8, K2 and K3 held
     against their twins on the largest and timed there in turns (K2 +
     K3, K8, K8, K2 + K3); then ``map -p rspoa -D -G --precision exact``
     over the same reads (local POA rows of 2,048 and 4,096 columns: K9
     and K5 launched, K4, K7 and K1 not), both GAFs byte-identical to
     ``--device cpu``, each local POA launch's shape and bytes under the
     route's budget, K9 held against its twin on each, K5 held and timed
     on its launch, and K4 and K9 timed in turns on the largest local POA
     batch.
Every CLI phase resets the launch counters just before its run and
reads them just after; a kernel's ``launches`` are those of the path
that runs it (K1 and K6: abPOA; K7 and K5: rspoa; K8: long reads,
abPOA, where K2 and K3 now launch no time; K9, and K4, which launches
no time there now: long reads, rspoa).

Then one JSON line of per-kernel results and, last, the device line.
Each kernel's ``bound_ms`` is the larger of the bytes it must move
(inputs read once, outputs written once, counted from this run's
inputs: rows below each problem's nv, pairs inside the band, walk
steps taken) over 3.35 TB/s and its operations over the peak rate of
their type (67 TFLOP/s f32, counting int32 there too, and 34 TFLOP/s
f64, the H100 SXM's data-sheet rates outside the tensor cores); the
operations per cell, pair or step are counted from the kernels' inner
loops (``_OPS``).  No single PyTorch call computes any of these
functions, so ``library_ms`` is null throughout.
The CLI runs in a temporary directory (the abPOA path writes one
subgraph GFA per chain), which is removed at the end.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N_READS = 12288
READ_LEN = 100
K = 11
CPU_SAMPLE = 256
SEED_GRAPH = 0
N_LONG = 64
MAIN_CHUNKS = 12  # the abPOA path's POA chunks for N_READS reads (1,024 problems each)

# one H100 SXM: memory rate, and peak rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
# operations per unit of work, counted from each kernel's inner loop
_OPS = {
    "chain_pair": 40,  # K1/K5, a pair in the band: filters, lengths, gap cost, compare
    "poa_cell": 40,  # K2/K6, a cell: h_pre, case, slots, scan terms, F1/F2, H, bits
    "poa_cell_slot": 10,  # K2/K6, a cell and slot: two opens, two extends, maxima, M
    "tb_step": 30,  # K3/K6, a walk step: decode, state machine, tape entry
    "local_cell": 10,  # K4/K7, a cell: substitution, floor, cell byte, best
    "local_cell_slot": 3,  # K4/K7, a cell and slot: max, compare, select
}


def _cuda_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of the least time for the bytes
    and the least time for the operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bound_keys(nbytes, ops, ops_per_s):
    ms, by = _bound(nbytes, ops, ops_per_s)
    return dict(bound_ms=ms, bound_by=by, library_ms=None)


def _chain_work(args, exact, bandwidth=50):
    """Bytes and operations of one chaining DP call: inputs qb/tb/te/valid
    and outputs f/pred/curr_max once each; a pair per valid anchor and
    each earlier anchor inside the band."""
    import torch

    qb, _tb, _te, valid = args
    B, A = qb.shape
    band = torch.arange(A, device=qb.device).clamp(max=bandwidth)
    pairs = int((valid.to(torch.int64) * band).sum())
    wide = 8 if exact else 4  # tb/te and f/curr_max
    nbytes = B * A * (4 + 2 * wide + 1) + B * A * (wide + 4) + B * wide
    if exact:
        nbytes += 8 * 1001  # the gap-cost table
    return nbytes, pairs * _OPS["chain_pair"]


def _poa_dp_work(t):
    """Bytes and operations of the POA DP on batch t (vcodes, vpred,
    is_sink, nv, q, nq): the vertex rows below each problem's nv and the
    other inputs once, score/best_sink, and tbits over those rows, which
    is all the DP computes."""
    vcodes, vpred, _sink, nv, q, _nq = t
    B, V, P = vpred.shape
    W = q.shape[1] + 1
    rows = int(nv.sum())
    cells = rows * W
    nbytes = rows * (2 + 4 * P) + B * (W - 1) + 8 * B + 4 * W + 8 * B + 4 * cells
    return nbytes, cells * (_OPS["poa_cell"] + P * _OPS["poa_cell_slot"])


def _walk_work(tlen, B, V, W, reads_bits=True):
    """Bytes and operations of the walks: the decision word and the
    predecessor id of every step taken (when they are inputs), and the
    whole tape and tlen written."""
    steps = int(tlen.sum())
    nbytes = B * (V + W + 1) * 4 + 4 * B + (8 * steps + 8 * B if reads_bits else 0)
    return nbytes, steps * _OPS["tb_step"]


def _local_work(args):
    """Bytes and operations of the local POA: the vertex rows below each
    problem's nv and the other inputs once, the decision byte of every
    cell below nv, the tape and the scalars."""
    vcodes, vpred, nv, q, _nq = args
    B, V, P = vpred.shape
    W = q.shape[1] + 1
    rows = int(nv.sum())
    cells = rows * W
    nbytes = rows * (1 + 4 * P) + B * (W - 1) + 8 * B + cells + 4 * B * W + 12 * B
    return nbytes, cells * (_OPS["local_cell"] + P * _OPS["local_cell_slot"])


def _max_abs_err(a, b):
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def _same_bits(a, b):
    """Equal tensors; f64 compared as int64 bit patterns."""
    import torch

    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return torch.equal(a, b)


def phase_env():
    import torch

    from vgaligner_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0].strip()
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()[-1]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{nvcc}' gpus {torch.cuda.device_count()}")
    print(card)
    return card


def phase_build():
    from vgaligner_tpu_torch import kernels

    t0 = time.monotonic()
    path = kernels.build()
    kernels.lib()
    took = kernels.build_seconds if kernels.build_seconds is not None else time.monotonic() - t0
    print(f"[build] {os.path.relpath(path)} in {took:.1f} s")
    if kernels.build_log.strip():
        print(kernels.build_log.strip())


def _main_path_anchors(index, reads, dev):
    """The chain kernels' input at the main path's shape: the first
    4,096 reads encoded, looked up at a_max 256 and sorted (tb/te int64)."""
    from vgaligner_tpu_torch.index.device_index import device_index
    from vgaligner_tpu_torch.ops.chain import sort_anchors
    from vgaligner_tpu_torch.ops.encode import encode_reads_host, window_kmer_codes
    from vgaligner_tpu_torch.ops.lookup import lookup_and_materialize_anchors
    import torch

    codes, lens = encode_reads_host(reads[:4096], 128)
    dindex = device_index(index, dev)
    w, wv = window_kmer_codes(torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev), K)
    anchors = lookup_and_materialize_anchors(dindex, w, wv, 256)
    _o, qb, tb, te, valid = sort_anchors(anchors.qb, anchors.tb, anchors.te, anchors.valid)
    return qb.contiguous(), tb.contiguous(), te.contiguous(), valid.contiguous()


def _random_sorted_anchors(seed, B, A, dev):
    import torch

    from vgaligner_tpu_torch.ops.chain import sort_anchors

    rng = np.random.default_rng(seed)
    qb = rng.integers(0, 90, (B, A)).astype(np.int32)
    tb = rng.integers(0, 2 * A, (B, A)).astype(np.int64)
    valid = rng.random((B, A)) < 0.9
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    _o, qb_s, tb_s, te_s, v_s = sort_anchors(t(qb), t(tb), t(tb + K), t(valid))
    return qb_s.contiguous(), tb_s.contiguous(), te_s.contiguous(), v_s.contiguous()


def _fast_args(args):
    """(qb, tb, te, valid) with tb/te as the fast kernel's int32."""
    import torch

    qb, tb, te, valid = args
    return qb, tb.to(torch.int32).contiguous(), te.to(torch.int32).contiguous(), valid


def _check_equal(label, names, got, want, errs):
    import torch

    torch.cuda.synchronize()
    for name, g, w in zip(names, got, want):
        if not _same_bits(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"{label}: {name} differs in {bad} places")
        errs.append(_max_abs_err(g, w))


def phase_chain_kernels(index, reads, dev, results):
    import torch

    from vgaligner_tpu_torch.ops import chain as C

    table = C.make_gap_cost_table(K, 1000)
    cases = [("main 4096x256", _main_path_anchors(index, reads, dev)),
             ("A=16384", _random_sorted_anchors(1, 4, 16384, dev)),
             ("A=65536", _random_sorted_anchors(2, 2, 65536, dev))]
    names = ("f", "pred", "curr_max")
    errs, errs_x = [], []
    for label, args in cases:
        fa = _fast_args(args)
        got = C.chain_dp(*fa, K, 50, 1000)
        _check_equal(f"chain_dp {label}", names, got, C.chain_dp_plain(*fa, K, 50, 1000), errs)
        got = C.chain_dp_exact(*args, K, 50, table)
        _check_equal(f"chain_dp_exact {label}", names, got,
                     C.chain_dp_exact_plain(*args, K, 50, table), errs_x)
        print(f"[kernels] chain_dp and chain_dp_exact {label}: f/pred/curr_max equal, "
              f"f64 bit for bit ({int(args[3].sum())} valid anchors)")
    main = cases[0][1]
    _exact_paths(main, table, errs_x, dev)
    fa = _fast_args(main)
    ms = _cuda_ms(lambda: C.chain_dp(*fa, K, 50, 1000), 10)
    plain_ms = _cuda_ms(lambda: C.chain_dp_plain(*fa, K, 50, 1000), 1)
    ms_x = _cuda_ms(lambda: C.chain_dp_exact(*main, K, 50, table), 10)
    plain_x = _cuda_ms(lambda: C.chain_dp_exact_plain(*main, K, 50, table), 1)
    # a row's latency: the read with the most rows to its last valid anchor,
    # alone, each kernel through its C entry (the wrapper's host time would
    # exceed so short a launch)
    A = main[0].shape[1]
    last = torch.where(main[3], torch.arange(A, device=dev), -1).max(dim=1).values + 1
    b = int(last.argmax())
    one = [x[b : b + 1].contiguous() for x in main]
    one_x = _cuda_ms(_chain_kernel_only(one, table, exact=True), 20)
    one_k1 = _cuda_ms(_chain_kernel_only(_fast_args(one), table, exact=False), 20)
    print(f"[kernels] the longest read alone, kernels alone ({int(last[b])} rows to its last "
          f"valid anchor): K5 {one_x:.4f} ms ({one_x * 1e3 / int(last[b]):.3f} us a row), K1 "
          f"{one_k1:.4f} ms ({A} rows, {one_k1 * 1e3 / A:.3f} us a row)")
    results["chain_dp"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                               **_bound_keys(*_chain_work(fa, False), F32_OPS_PER_S))
    results["chain_dp_exact"] = dict(max_abs_err=max(errs_x), ms=ms_x, plain_ms=plain_x,
                                     **_bound_keys(*_chain_work(main, True), F64_OPS_PER_S))
    print(f"[kernels] chaining 4096x256: K1 fast {ms:.3f} ms (plain {plain_ms:.3f} ms), "
          f"K5 exact {ms_x:.3f} ms (plain {plain_x:.3f} ms)")

    gaps = torch.arange(0, 1001, dtype=torch.int32)
    g_dev = C.gap_cost_scaled_i32(gaps.to(dev), K).cpu()
    g_cpu = C.gap_cost_scaled_i32_plain(gaps, K)
    g_f64 = torch.from_numpy(np.floor(table * 1000.0 + 0.5).astype(np.int64))
    if not torch.equal(g_dev, g_cpu) or not torch.equal(g_dev.to(torch.int64), g_f64):
        raise AssertionError("gap cost on the card differs from the CPU / f64 table")
    print("[kernels] gap cost g=0..1000: card == CPU plain == rounded f64 table")


def _chain_kernel_only(args, table, exact):
    """One launch of K5 (``exact``: one divide a row) or K1 through its
    C entry on outputs allocated once."""
    import torch

    from vgaligner_tpu_torch import kernels
    from vgaligner_tpu_torch.ops import chain as C

    qb, tb, te, valid = args
    B, A = qb.shape
    dev = qb.device
    wide = torch.float64 if exact else torch.int32
    f = torch.empty((B, A), dtype=wide, device=dev)
    pred = torch.empty((B, A), dtype=torch.int32, device=dev)
    cmax = torch.empty(B, dtype=wide, device=dev)
    so = kernels.lib()
    ins = [qb.data_ptr(), tb.data_ptr(), te.data_ptr(), valid.data_ptr()]
    outs = [f.data_ptr(), pred.data_ptr(), cmax.data_ptr(), kernels.stream_ptr(dev)]
    if exact:
        tab = C._device_gap_table(table, K, dev)
        ptrs = [*ins, tab.data_ptr(), B, A, K, 50, len(table) - 1, 1, *outs]
        fn = lambda: kernels.check(so.vg_chain_dp_exact(*ptrs), "chain_dp_exact")  # noqa: E731
    else:
        ptrs = [*ins, B, A, K, 50, 1000, *outs]
        fn = lambda: kernels.check(so.vg_chain_dp(*ptrs), "chain_dp")  # noqa: E731
    return fn


def _scattered_anchors(seed, B, A, dev):
    """Anchors in target-end order whose valid slots are scattered, not a
    prefix, and a read with none."""
    import torch

    rng = np.random.default_rng(seed)
    te = np.sort(rng.integers(0, 3 * A, (B, A)), axis=1).astype(np.int64) + K
    qb = rng.integers(0, 90, (B, A)).astype(np.int32)
    valid = rng.random((B, A)) < 0.5
    valid[1] = False
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return t(qb), t(te - K), t(te), t(valid)


def _exact_paths(main, table, errs, dev):
    """K5's paths bit for bit against the plain twin, on the main anchors
    and on scattered valid anchors: one divide a row with the CLI's
    table, one a pair with a table that has a negative entry, and one a
    pair with a table whose scores pass the 2^41 bound."""
    import torch

    from vgaligner_tpu_torch.ops import chain as C

    names = ("f", "pred", "curr_max")
    A = main[0].shape[1]
    negative = table.copy()
    negative[1::7] *= -1.0
    big = -table * 1e8
    if not C.exact_divide_once(A, K, table):
        raise AssertionError("the main anchors do not take one divide a row")
    if C.exact_divide_once(A, K, negative) or C.exact_divide_once(A, K, big):
        raise AssertionError("a negative or too large gap table takes one divide a row")
    scattered = _scattered_anchors(3, 64, 256, dev)
    for label, args in (("main 4096x256", main), ("scattered valid 64x256", scattered)):
        for path, tab in (("a row", table), ("a pair, negative table", negative),
                          ("a pair, over the bound", big)):
            want = C.chain_dp_exact_plain(*args, K, 50, tab)
            _check_equal(f"chain_dp_exact {label} {path}", names,
                         C.chain_dp_exact(*args, K, 50, tab), want, errs)
    last = torch.where(main[3], torch.arange(A, device=dev), -1).max(dim=1).values + 1
    print(f"[kernels] K5 paths (one divide a row; one a pair with a negative table and over "
          f"the bound, max |curr_max| {float(want[2].abs().max()):.4g}) on the main anchors and "
          f"on scattered valid anchors: f/pred/curr_max equal bit for bit; rows to the last "
          f"valid anchor: mean {float(last.float().mean()):.2f} of {A}")


def phase_poa_kernels(dev, results):
    import torch

    from vgaligner_tpu_torch import kernels
    from vgaligner_tpu_torch.ops import poa_device as PD
    from vgaligner_tpu_torch.testing import random_poa_batch

    dp_err, tb_err = [], []

    def run_batch(seed, B, V, P, W):
        arrs = random_poa_batch(seed, B, V, P, W - 1)
        t = [torch.from_numpy(a).to(dev) for a in arrs]
        init = torch.from_numpy(PD.make_init_row(W - 1)).to(dev)
        s_k, k_k, tb_k = PD.poa_dp(*t, init)
        tape_k, tl_k = PD.poa_traceback(tb_k, t[1], k_k, t[5])
        torch.cuda.synchronize()
        s_p, k_p, tb_p = PD.poa_dp_plain(*t, init)
        tape_p, tl_p = PD.poa_traceback_plain(tb_k, t[1], k_k, t[5])
        torch.cuda.synchronize()
        if not (torch.equal(s_k, s_p) and torch.equal(k_k, k_p)):
            raise AssertionError(f"poa_dp P={P} W={W} V={V}: score/best_sink differ")
        nv = arrs[3]
        for b in range(B):
            if not torch.equal(tb_k[b, : nv[b]], tb_p[b, : nv[b]]):
                raise AssertionError(f"poa_dp P={P} W={W} V={V}: tbits differ (problem {b})")
        if not torch.equal(tl_k, tl_p):
            raise AssertionError(f"poa_traceback P={P} W={W} V={V}: tlen differs")
        for b in range(B):
            n = int(tl_k[b])
            if not torch.equal(tape_k[b, :n], tape_p[b, :n]):
                raise AssertionError(f"poa_traceback P={P} W={W} V={V}: tape differs ({b})")
        dp_err.append(_max_abs_err(s_k, s_p))
        tb_err.append(_max_abs_err(tl_k, tl_p))
        print(f"[kernels] poa_dp + poa_traceback P={P} W={W} V={V} B={B}: "
              "score/best_sink/tbits[:nv]/tape[:tlen]/tlen equal")
        return t, init, tb_k, k_k

    for P in (2, 4, 8):
        for W in (128, 256):
            for V, B in ((256, 32), (2048, 8)):
                run_batch(100 + P * 10 + W + V, B, V, P, W)
    # rows over 1,024 columns (reads over 1,023 bp): several columns a thread
    for W in (2048, 4096, 8192):
        for V, B in ((256, 64), (2048, 64 if W < 8192 else 32)):
            run_batch(200 + W + V, B, V, 2, W)
    # rows of 16,384 columns (reads of 8,192-16,383 bp), which only K2 + K3 take
    t16, init16, tb16, k16 = run_batch(220, 4, 128, 4, 16384)
    k2_16 = _cuda_ms(lambda: PD.poa_dp(*t16, init16), 5)
    k3_16 = _cuda_ms(lambda: PD.poa_traceback(tb16, t16[1], k16, t16[5]), 5)
    print(f"[kernels] W 16,384 (B 4, V 128, P 4): K2 {k2_16:.4f} ms, K3 {k3_16:.4f} ms")
    t, init, tbits, sinks = run_batch(7, 1024, 256, 2, 128)
    plain_dp = _cuda_ms(lambda: PD.poa_dp_plain(*t, init), 1)
    plain_tb = _cuda_ms(lambda: PD.poa_traceback_plain(tbits, t[1], sinks, t[5]), 1)
    print(f"[kernels] poa 1024x256x128 P=2 equal; plain poa_dp {plain_dp:.3f} ms, "
          f"plain poa_traceback {plain_tb:.3f} ms")

    # the lane-padded contract of the JAX package's VMEM-resident DP
    arrs = random_poa_batch(8, 1024, 256, 2, 100)
    tp = [torch.from_numpy(a).to(dev) for a in arrs]
    initp = torch.from_numpy(PD.make_init_row(100)).to(dev)
    before = kernels.LAUNCHES["poa_dp_tb"]
    got = PD.poa_global_kernel(*tp, initp)
    if kernels.LAUNCHES["poa_dp_tb"] != before + 1:
        raise AssertionError("poa_global_kernel at l_w 128 did not run poa_dp_tb")
    q_w, init_w = PD.lane_pad(tp[4], initp)
    s_p, k_p, tb_p = PD.poa_dp_plain(*tp[:4], q_w, tp[5], init_w)
    want = (s_p,) + PD.poa_traceback_plain(tb_p, tp[1], k_p, tp[5])
    _check_equal("poa_global_kernel 1024x256 L=100", ("score", "tape", "tlen"), got, want,
                 dp_err)
    print(f"[kernels] poa_global_kernel 1024x256 L=100 (l_w {q_w.shape[1] + 1}, on "
          "poa_dp_tb): score/tape/tlen equal to the plain chain")
    _tape, tlen = PD.poa_traceback(tbits, t[1], sinks, t[5])
    results["poa_dp"] = dict(max_abs_err=max(dp_err), plain_ms=plain_dp,
                             **_bound_keys(*_poa_dp_work(t), F32_OPS_PER_S))
    results["poa_traceback"] = dict(
        max_abs_err=max(tb_err), plain_ms=plain_tb,
        **_bound_keys(*_walk_work(tlen, *tbits.shape), F32_OPS_PER_S))
    return t, init


def _fused_check(t, init, label, errs, fused=None):
    """K6 (or ``fused``, K8) against poa_dp_plain + poa_traceback_plain on
    the same CUDA tensors: score, best_sink, tape, tlen and tbits below nv
    bit for bit, and n_backing equal to backing_rows_plain.  Returns
    n_backing."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    score, sink, tbits, tape, tlen, n_backing = (fused or PD.poa_dp_tb)(*t, init)
    torch.cuda.synchronize()
    ws, wk, wtb = PD.poa_dp_plain(*t, init)
    wtape, wtl = PD.poa_traceback_plain(wtb, t[1], wk, t[5])
    _check_equal(label, ("score", "best_sink", "tape", "tlen", "n_backing"),
                 (score, sink, tape, tlen, n_backing),
                 (ws, wk, wtape, wtl, PD.backing_rows_plain(t[1], t[3])), errs)
    below_nv = torch.arange(tbits.shape[1], device=tbits.device)[None, :] < t[3][:, None]
    if not torch.equal(tbits[below_nv], wtb[below_nv]):
        raise AssertionError(f"{label}: tbits differ below nv")
    return n_backing


def _time_in_turns(t, init, reps=10, fused=None):
    """K2 + K3 and a fused kernel (K6, or ``fused``) on the same CUDA
    tensors, after a warm-up, in turns K2 + K3, fused, fused, K2 + K3:
    lists of K2, K3 and fused ms, two turns each."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    fused = fused or PD.poa_dp_tb
    _s, sinks, tbits = PD.poa_dp(*t, init)
    PD.poa_traceback(tbits, t[1], sinks, t[5])
    fused(*t, init)
    torch.cuda.synchronize()
    k2, k3, k6 = [], [], []
    for turn in ("old", "new", "new", "old"):
        if turn == "old":
            k2.append(_cuda_ms(lambda: PD.poa_dp(*t, init), reps))
            k3.append(_cuda_ms(lambda: PD.poa_traceback(tbits, t[1], sinks, t[5]), reps))
        else:
            k6.append(_cuda_ms(lambda: fused(*t, init), reps))
    return k2, k3, k6


def _turns_line(k2, k3, k6, name="K6"):
    return (f"K2 + K3 {k2[0]:.4f} + {k3[0]:.4f}, {name} {k6[0]:.4f}, {name} {k6[1]:.4f}, "
            f"K2 + K3 {k2[1]:.4f} + {k3[1]:.4f} ms")


def phase_fused_kernel(dev, results, main_t, main_init):
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD
    from vgaligner_tpu_torch.testing import random_poa_batch

    errs = []
    for P in (2, 4, 8):
        for W in (32, 128, 256):
            far = random_poa_batch(300 + P + W, 48, 256, P, W - 1, far_frac=0.3)
            near = random_poa_batch(301 + P + W, 16, 256, P, W - 1, far_frac=0.0)
            t = [torch.from_numpy(np.concatenate(x)).to(dev) for x in zip(far, near)]
            init = torch.from_numpy(PD.make_init_row(W - 1)).to(dev)
            nb = _fused_check(t, init, f"poa_dp_tb P={P} W={W}", errs).cpu()
            if not bool((nb[:48] > 0).any()) or bool((nb[48:] != 0).any()):
                raise AssertionError(f"poa_dp_tb P={P} W={W}: batch lacks its edge cases")
            print(f"[kernels] poa_dp_tb P={P} W={W} V=256 B=64: equal to the plain pair; "
                  f"{int((nb > 0).sum())} problems on the backing store (max "
                  f"{int(nb.max())} rows)")
    nb = _fused_check(main_t, main_init, "poa_dp_tb 1024x256x128", errs)
    warps, blocks, smem = PD.poa_dp_tb_occupancy(2, 128, 256)
    print(f"[kernels] poa_dp_tb 1024x256x128 P=2: equal to the plain pair "
          f"({int((nb > 0).sum())} problems on the backing store); {warps} problems a "
          f"block, {blocks} blocks an SM, {smem} B shared memory a block: "
          f"{warps * blocks * torch.cuda.get_device_properties(dev).multi_processor_count} "
          "problems resident")
    k2, k3, k6 = _time_in_turns(main_t, main_init)
    plain = _cuda_ms(lambda: _plain_pair(main_t, main_init), 1)
    tlen = PD.poa_dp_tb(*main_t, main_init)[4]
    dp_bytes, dp_ops = _poa_dp_work(main_t)
    tb_bytes, tb_ops = _walk_work(tlen, *main_t[1].shape[:2], main_init.shape[0], False)
    results["poa_dp"]["ms"] = sum(k2) / 2
    results["poa_traceback"]["ms"] = sum(k3) / 2
    results["poa_dp_tb"] = dict(max_abs_err=max(errs), ms=sum(k6) / 2, plain_ms=plain,
                                **_bound_keys(dp_bytes + tb_bytes, dp_ops + tb_ops,
                                              F32_OPS_PER_S))
    print(f"[kernels] 1024x256x128 P=2 in turns: {_turns_line(k2, k3, k6)}; K6 plain pair "
          f"{plain:.3f} ms, bound {results['poa_dp_tb']['bound_ms']:.4f} ms "
          f"({results['poa_dp_tb']['bound_by']})")


def phase_cluster_kernel(dev, results):
    """K8 at every width of CLUSTER_WIDTHS x P 2/4/8 on far and near
    batches (far predecessors, pin overflow, a predecessor at and past its
    vertex, nv = 4), at V 8,192 x W 2,048, and at W 8,192 x V 1,024; its
    cluster occupancy and ptxas report."""
    import torch

    from vgaligner_tpu_torch import kernels
    from vgaligner_tpu_torch.ops import poa_device as PD
    from vgaligner_tpu_torch.testing import random_poa_batch, with_poa_edge_cases

    errs, on_backing = [], 0
    cases = [(P, W, 256 if W < 8192 else 128, 8) for W in PD.CLUSTER_WIDTHS for P in (2, 4, 8)]
    cases += [(2, 2048, 8192, 8), (2, 8192, 1024, 8)]
    for P, W, V, B in cases:
        seed = 700 + P + W + V
        far = with_poa_edge_cases(random_poa_batch(seed, B - 2, V, P, W - 1, far_frac=0.3),
                                  empty=False)
        near = random_poa_batch(seed + 1, 2, V, P, W - 1, far_frac=0.0)
        t = [torch.from_numpy(np.concatenate(x)).to(dev) for x in zip(far, near)]
        init = torch.from_numpy(PD.make_init_row(W - 1)).to(dev)
        nb = _fused_check(t, init, f"poa_dp_tb_cluster P={P} W={W} V={V}", errs,
                          PD.poa_dp_tb_cluster).cpu()
        if not bool((nb[: B - 2] > 0).any()) or bool((nb[B - 2 :] != 0).any()):
            raise AssertionError(f"poa_dp_tb_cluster P={P} W={W} V={V}: batch lacks its edge "
                                 "cases")
        on_backing += int((nb > 0).sum())
        ctas, clusters, smem = PD.poa_dp_tb_cluster_occupancy(P, W, V)
        print(f"[kernels] poa_dp_tb_cluster (K8) P={P} W={W} V={V} B={B}: equal to the plain "
              f"pair; {int((nb > 0).sum())} problems on the backing store (max {int(nb.max())} "
              f"rows); {ctas} CTAs a cluster, {clusters} clusters resident, {smem} B shared "
              "memory a CTA")
    regs = _ptxas(kernels.build_log, "poa_dp_tb_cluster_kernel")
    print(f"[kernels] K8: {on_backing} problems of the grid on the backing store; ptxas (P: "
          "registers, spill store/load bytes): " + "; ".join(
              f"{a}: {r}, {st}/{ld}" for a, r, st, ld in regs))
    results["poa_dp_tb_cluster"] = dict(max_abs_err=max(errs))


def _plain_pair(t, init):
    from vgaligner_tpu_torch.ops import poa_device as PD

    _s, sinks, tbits = PD.poa_dp_plain(*t, init)
    return PD.poa_traceback_plain(tbits, t[1], sinks, t[5])


def phase_local_kernel(dev, results):
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD
    from vgaligner_tpu_torch.testing import (random_local_batch, random_poa_batch,
                                             with_local_edge_cases)

    errs = []
    for P in (2, 4, 8):
        for W in (128, 256, 2048):
            for V in (256, 2048):
                vcodes, vpred, _sink, nv, q, nq = random_poa_batch(P + W + V, 32, V, P, W - 1)
                q[0] = 4  # no positive cell
                n = min(V, W - 1) // 2
                q[1:, :n] = vcodes[1:, :n]  # long local matches
                t = [torch.from_numpy(a).to(dev) for a in (vcodes, vpred, nv, q, nq)]
                got = PD.poa_local_block(*t)
                want = PD.poa_local_plain(*t)
                _check_equal(f"poa_local P={P} W={W} V={V}", ("best", "tape", "tlen", "qend"),
                             got, want, errs)
                if float(got[0][0]) != 0.0 or not bool((nv < V).any()):
                    raise AssertionError("poa_local batch lacks its edge cases")
                print(f"[kernels] poa_local (K4) P={P} W={W} V={V} B=32: best/tape/tlen/qend "
                      f"equal (max tlen {int(got[2].max())})")
    # rows of 16,384 columns (reads of 8,192-16,383 bp), the one width of
    # the CLI's ladder K4 still takes: held and timed
    t = [torch.from_numpy(a).to(dev)
         for a in with_local_edge_cases(random_local_batch(16, 8, 128, 4, 16383, far_frac=0.3))]
    want = PD.poa_local_plain(*t)
    _check_equal("poa_local (K4) W=16384", ("best", "tape", "tlen", "qend"),
                 PD.poa_local(*t), want, errs)
    ms = _cuda_ms(lambda: PD.poa_local_block(*t), 10)
    alone = _cuda_ms(_local_kernel_only(t, "block"), 10)
    plain_ms = _cuda_ms(lambda: PD.poa_local_plain(*t), 1)
    results["poa_local"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                                **_bound_keys(*_local_work(t), F32_OPS_PER_S))
    print(f"[kernels] poa_local (K4) W 16,384 (B 8, V 128, P 4, through poa_local): equal to the "
          f"twin; {ms:.4f} ms through its wrapper, {alone:.4f} ms alone (bound "
          f"{results['poa_local']['bound_ms']:.4f}, {results['poa_local']['bound_by']}; plain "
          f"{plain_ms:.3f})")


def _ptxas(log, kernel):
    """ptxas's (template arguments, registers, spill store and load
    bytes) of every instance of ``kernel`` in the build log."""
    import re

    out, cur, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            args = "/".join(re.findall(r"L[ib](\d+)E", cur.split(kernel, 1)[1]))
            out.append((args, int(m.group(1)), *spills))
            cur, spills = None, (0, 0)
    return out


def phase_local_warp_kernel(dev, results):
    import torch

    from vgaligner_tpu_torch import kernels
    from vgaligner_tpu_torch.ops import poa_device as PD
    from vgaligner_tpu_torch.testing import random_local_batch, with_local_edge_cases

    errs, on_backing = [], 0
    for P in (2, 4, 8):
        for W in (32, 64, 128, 256):
            for V in (64, 256, 2048):
                seed = 500 + P * 3 + W + V
                far = with_local_edge_cases(random_local_batch(seed, 24, V, P, W - 1,
                                                               far_frac=0.3))
                near = random_local_batch(seed + 1, 8, V, P, W - 1, far_frac=0.0)
                t = [torch.from_numpy(np.concatenate(x)).to(dev) for x in zip(far, near)]
                got = PD.poa_local_warp(*t)
                want = PD.poa_local_plain(*t)
                _check_equal(f"poa_local_warp P={P} W={W} V={V}",
                             ("best", "tape", "tlen", "qend", "n_backing"), got,
                             (*want, PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING,
                                                           PD.LOCAL_PINS)), errs)
                nb = got[4].cpu()
                if not bool((nb[:24] > 0).any()) or bool((nb[24:] != 0).any()):
                    raise AssertionError(f"poa_local_warp P={P} W={W} V={V}: batch lacks its "
                                         "edge cases")
                on_backing += int((nb > 0).sum())
                print(f"[kernels] poa_local_warp (K7) P={P} W={W} V={V} B=32: best/tape/tlen/"
                      f"qend/n_backing equal; {int((nb > 0).sum())} problems on the backing "
                      f"store (max {int(nb.max())} rows), max tlen {int(got[2].max())}")
    regs = _ptxas(kernels.build_log, "poa_local_warp_kernel")
    print("[kernels] K7 ptxas (P/C/NW: registers, spill store/load bytes): " + "; ".join(
        f"{a}: {r}, {st}/{ld}" for a, r, st, ld in regs))
    warps, blocks, smem = PD.poa_local_warp_occupancy(2, 128, 256)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[kernels] K7 at P 2, W 128, V 256: {warps} problems a block, {blocks} blocks an SM, "
          f"{smem} B shared memory a block: {warps * blocks * sms} problems resident; "
          f"{on_backing} problems of the grid on the backing store")
    results["poa_local_warp"] = dict(max_abs_err=max(errs))


def phase_local_cluster_kernel(dev, results):
    """K9 at every width of CLUSTER_WIDTHS x P 2/4/8 on far and near
    batches (far predecessors past the ring, pin overflow, a predecessor
    at and past its vertex, nv = 4 and 0), and on chains whose best run
    takes a far edge, pinned and on the backing store, exactly where a
    CTA's columns start (W 4,096 and 8,192); its cluster occupancy and
    ptxas report."""
    import torch

    from vgaligner_tpu_torch import kernels
    from vgaligner_tpu_torch.ops import poa_device as PD
    from vgaligner_tpu_torch.testing import (far_jump_local_batch, random_local_batch,
                                             with_local_edge_cases)

    errs, on_backing = [], 0
    names = ("best", "tape", "tlen", "qend", "n_backing")

    def check(label, t):
        got = PD.poa_local_cluster(*t)
        want = (*PD.poa_local_plain(*t),
                PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING, PD.LOCAL_PINS))
        _check_equal(label, names, got, want, errs)
        return got[4].cpu()

    for W in PD.CLUSTER_WIDTHS:
        for P in (2, 4, 8):
            V, seed = (256 if W < 8192 else 128), 900 + P + W
            far = with_local_edge_cases(random_local_batch(seed, 6, V, P, W - 1, far_frac=0.3))
            near = random_local_batch(seed + 1, 2, V, P, W - 1, far_frac=0.0)
            t = [torch.from_numpy(np.concatenate(x)).to(dev) for x in zip(far, near)]
            nb = check(f"poa_local_cluster P={P} W={W} V={V}", t)
            if not bool((nb[:6] > 0).any()) or bool((nb[6:] != 0).any()):
                raise AssertionError(f"poa_local_cluster P={P} W={W}: batch lacks its edge cases")
            on_backing += int((nb > 0).sum())
            ctas, clusters, smem = PD.poa_local_cluster_occupancy(P, W, V)
            print(f"[kernels] poa_local_cluster (K9) P={P} W={W} V={V} B=8: best/tape/tlen/qend/"
                  f"n_backing equal; {int((nb > 0).sum())} problems on the backing store; "
                  f"{ctas} CTAs a cluster, {clusters} clusters resident, {smem} B shared memory "
                  "a CTA")
    for W, boundary in ((4096, 2048), (8192, 4096)):
        ctas = PD.poa_local_cluster_occupancy(2, W, boundary + 200)[0]
        if boundary % (W // ctas) != 0:
            raise AssertionError(f"column {boundary} does not start a CTA at W {W}")
        t = [torch.from_numpy(a).to(dev)
             for a in far_jump_local_batch(W, boundary, boundary + 200)]
        nb = check(f"poa_local_cluster far edge at column {boundary} W={W}", t)
        if nb.tolist() != [1, 0]:
            raise AssertionError("the far-edge batch lost its backing row or its pin")
    regs = _ptxas(kernels.build_log, "poa_local_cluster_kernel")
    print(f"[kernels] K9: {on_backing} problems of the grid on the backing store; a best run "
          "over a far edge at a CTA's first column (2,048 of W 4,096, 4,096 of W 8,192), pinned "
          "and on the backing store, equal; ptxas (P: registers, spill store/load bytes): "
          + "; ".join(f"{a}: {r}, {st}/{ld}" for a, r, st, ld in regs))
    results["poa_local_cluster"] = dict(max_abs_err=max(errs))


def _rows_for(path, names):
    with open(path, "rb") as fh:
        lines = fh.read().splitlines(keepends=True)
    return b"".join(ln for ln in lines if ln.split(b"\t", 1)[0] in names)


def _map(prefix, fasta, gfa, out, argv):
    from vgaligner_tpu_torch import cli

    os.makedirs(os.path.dirname(out))
    os.chdir(os.path.dirname(out))
    cli.main(["map", "-i", prefix, "-f", fasta, "-G", gfa, "-D", "-o", out, *argv])


def _drive(label, prefix, fasta, gfa, out, argv, must, must_not=()):
    """One CLI run on the card with the launch counters reset just
    before it and read just after."""
    import torch

    from vgaligner_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    _map(prefix, fasta, gfa, out, argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    took = time.monotonic() - t0
    launches = kernels.launch_counts()
    for name in must:
        if launches[name] <= 0:
            raise AssertionError(f"{label} never launched {name}: {launches}")
    for name in must_not:
        if launches[name] != 0:
            raise AssertionError(f"{label} launched {name}: {launches}")
    return took, launches


def _check_gaf(out, n_reads, read_lens):
    with open(out + "-alignments.gaf", "rb") as fh:
        aln = fh.read().splitlines()
    with open(out + "-chains.gaf", "rb") as fh:
        chains = fh.read().splitlines()
    if len(aln) != n_reads or len(chains) < n_reads:
        raise AssertionError(f"{len(aln)} alignment rows, {len(chains)} chain rows "
                             f"for {n_reads} reads")
    mapped = 0
    for row in aln:
        cols = row.split(b"\t")
        if len(cols) != 13:
            raise AssertionError(f"malformed GAF row {row[:80]!r}")
        if cols[5] != b"*":
            mapped += 1
            name = cols[0].decode()
            if int(cols[1]) != read_lens[name] or int(cols[6]) <= 0:
                raise AssertionError(f"implausible alignment row {row[:120]!r}")
    if mapped < 0.95 * n_reads:
        raise AssertionError(f"only {mapped} of {n_reads} path-sampled reads aligned")
    return len(chains), mapped


def _cpu_rerun(work, name, prefix, gfa, reads, out, argv, sample=CPU_SAMPLE):
    """The first ``sample`` reads on the plain twins; both GAFs equal to
    the card run's rows for those reads."""
    sample_fa = os.path.join(work, f"{name}-sample.fa")
    with open(sample_fa, "w") as fh:
        for i in range(min(sample, len(reads))):
            fh.write(f">read{i}\n{reads[i]}\n")
    cpu_out = os.path.join(work, f"{name}-cpu", "smoke")
    _map(prefix, sample_fa, gfa, cpu_out, argv + ["--device", "cpu"])
    names = {f"read{i}".encode() for i in range(min(sample, len(reads)))}
    for kind in ("chains", "alignments"):
        card_rows = _rows_for(f"{out}-{kind}.gaf", names)
        with open(f"{cpu_out}-{kind}.gaf", "rb") as fh:
            cpu_rows = fh.read()
        if card_rows != cpu_rows:
            raise AssertionError(f"{name}: {kind} GAF of the first {len(names)} reads differs "
                                 "between the card and the CPU plain path")
    return len(names)


def phase_main_path(work, prefix, gfa, fasta, reads, card, results):
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD
    from vgaligner_tpu_torch.poa_chunk_stats import chunk_stats

    chunks = []
    real = PD.poa_dp_tb

    def keep(*args):
        out = real(*args)
        chunks.append((args, out[5]))
        return out

    out = os.path.join(work, "card", "smoke")
    PD.poa_dp_tb = keep
    try:
        took, launches = _drive("the main path", prefix, fasta, gfa, out,
                                ["-p", "abpoa", "--precision", "auto"],
                                ("chain_dp", "poa_dp_tb"),
                                ("poa_dp", "poa_traceback", "poa_dp_tb_cluster",
                                 "poa_local_cluster"))
    finally:
        PD.poa_dp_tb = real
    if launches["poa_dp_tb"] != MAIN_CHUNKS:
        raise AssertionError(f"poa_dp_tb launched {launches['poa_dp_tb']} times, "
                             f"not once per chunk ({MAIN_CHUNKS})")
    print(f"[main] map -p abpoa -D on {N_READS} reads: {took:.2f} s, {N_READS / took:.1f} "
          f"reads/s streamed map+align ({card}); launches {launches}")
    n_chains, mapped = _check_gaf(out, N_READS, {f"read{i}": READ_LEN for i in range(N_READS)})
    print(f"[main] {n_chains} chain rows, {mapped}/{N_READS} reads aligned")

    stats = [chunk_stats(a[1].cpu().numpy(), a[3].cpu().numpy(), int((a[3] > 0).sum()))
             for a, _nb in chunks]
    if not all(c["topological"] for c in stats):
        raise AssertionError("a main-path chunk has a predecessor at or past its vertex")
    problems = sum(c["problems"] for c in stats)
    on_backing = sum(int((nb > 0).sum()) for _a, nb in chunks)
    print(f"[main] poa_dp_tb chunks: {len(chunks)}, {problems} problems, mean nv "
          f"{sum(c['nv_sum'] for c in stats) / problems:.2f}, every predecessor before its "
          f"vertex, far vertices per problem max {max(c['far8_max'] for c in stats)} (ring 8) "
          f"/ {max(c['far16_max'] for c in stats)} (ring 16); {on_backing} problems took the "
          "backing store")
    args = max((a for a, _nb in chunks), key=lambda a: int(a[3].sum()))
    errs = []
    _fused_check(args[:6], args[6], "poa_dp_tb on the main reads' largest chunk", errs)
    k2, k3, k6 = _time_in_turns(args[:6], args[6])
    results["poa_dp_tb"]["max_abs_err"] = max(results["poa_dp_tb"]["max_abs_err"], *errs)
    print(f"[main] largest chunk B={args[0].shape[0]} V={args[0].shape[1]} "
          f"W={args[6].shape[0]} mean nv {float(args[3].float().mean()):.1f}: equal to the "
          f"plain pair; in turns {_turns_line(k2, k3, k6)}")
    torch.cuda.synchronize()

    n = _cpu_rerun(work, "main", prefix, gfa, reads, out, ["-p", "abpoa", "--precision", "fast"])
    print(f"[main] first {n} reads: chains and alignments GAF byte-identical "
          "to the --device cpu run")
    return launches


def _local_kernel_only(args, kind):
    """One launch of K7 (``kind`` "warp"), K9 ("cluster") or K4
    ("block") through its C entry on buffers allocated once
    (K4's H and cell plane zeroed once): the kernel's own time, without
    the wrapper's allocations and K4's zero-fill."""
    import torch

    from vgaligner_tpu_torch import kernels
    from vgaligner_tpu_torch.ops import poa_device as PD

    vcodes, vpred, nv, q, _nq = args
    B, V = vcodes.shape
    P, L = vpred.shape[-1], q.shape[1]
    W, dev = L + 1, vcodes.device
    so = kernels.lib()
    outs = [torch.empty(B, dtype=torch.float32, device=dev),
            torch.empty((B, W), dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev)]
    ins = [a.data_ptr() for a in (vcodes, vpred, nv, q)]
    stream = kernels.stream_ptr(dev)
    if kind == "cluster":
        off = torch.from_numpy(PD._back_offsets(vpred, nv, None)).to(dev)
        scratch = [off, torch.empty((max(int(off[-1]), 1), W), dtype=torch.int16, device=dev),
                   torch.empty((B, V, W), dtype=torch.uint8, device=dev)]
        nb = torch.empty(B, dtype=torch.int32, device=dev)
        ptrs = [*ins, B, V, P, L, *(x.data_ptr() for x in scratch + outs), nb.data_ptr(), stream]
        return lambda: kernels.check(so.vg_poa_local_cluster(*ptrs), "poa_local_cluster")
    if kind == "warp":
        scratch = [torch.empty((B, V, W), dtype=torch.int16, device=dev),
                   torch.empty((B, V, W), dtype=torch.uint8, device=dev)]
        nb = torch.empty(B, dtype=torch.int32, device=dev)
        ptrs = [*ins, B, V, P, L, *(x.data_ptr() for x in scratch + outs), nb.data_ptr(), stream]
        return lambda: kernels.check(so.vg_poa_local_warp(*ptrs), "poa_local_warp")
    scratch = [torch.zeros((B, V + 1, W), dtype=torch.float32, device=dev),
               torch.zeros((B, V, W), dtype=torch.uint8, device=dev)]
    ptrs = [*ins, B, V, P, L, *(x.data_ptr() for x in scratch + outs), stream]
    return lambda: kernels.check(so.vg_poa_local(*ptrs), "poa_local")


def _local_turns(args, new="K7", reps=10):
    """K4 and ``new`` (K7, or K9 with the host's backing-row counts) on
    the same CUDA tensors, after a warm-up, in turns K4, new, new, K4:
    through their wrappers, then as kernels alone.  Returns {(kernel,
    how): [ms, ms]} and the line that reports them."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    if new == "K7":
        wrapper = lambda: PD.poa_local_warp(*args)  # noqa: E731
    else:
        back = PD.backing_rows_plain(args[1], args[2], PD.LOCAL_RING, PD.LOCAL_PINS).cpu().numpy()
        wrapper = lambda: PD.poa_local_cluster(*args, back)  # noqa: E731
    fns = {("K4", "wrapper"): lambda: PD.poa_local_block(*args),
           (new, "wrapper"): wrapper,
           ("K4", "kernel"): _local_kernel_only(args, "block"),
           (new, "kernel"): _local_kernel_only(args, "warp" if new == "K7" else "cluster")}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    out = {key: [] for key in fns}
    parts = {"wrapper": [], "kernel": []}
    for how in ("wrapper", "kernel"):
        for name in ("K4", new, new, "K4"):
            out[name, how].append(_cuda_ms(fns[name, how], reps))
            parts[how].append(f"{name} {out[name, how][-1]:.4f}")
    line = (f"through the wrappers {', '.join(parts['wrapper'])}; kernels alone "
            f"{', '.join(parts['kernel'])}")
    return out, line


def phase_rspoa_path(work, prefix, gfa, fasta, reads, card, dev, results):
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    captured = {}
    real = _keep_largest(PD, "poa_local", lambda a: a[0].shape[0], captured)
    out = os.path.join(work, "rspoa", "smoke")
    try:
        took, launches = _drive("the rspoa path", prefix, fasta, gfa, out,
                                ["-p", "rspoa", "--precision", "exact"],
                                ("chain_dp_exact", "poa_local_warp"),
                                ("chain_dp", "poa_dp", "poa_local", "poa_dp_tb_cluster",
                                 "poa_local_cluster"))
    finally:
        PD.poa_local = real
    print(f"[rspoa] map -p rspoa -D --precision exact on {N_READS} reads: {took:.2f} s, "
          f"{N_READS / took:.1f} reads/s ({card}); launches {launches}")
    exported = [f for _r, _d, fs in os.walk(os.path.dirname(out)) for f in fs
                if "-subgraph-" in f]
    if exported:
        raise AssertionError(f"the rspoa route wrote {len(exported)} subgraph GFAs")
    n_chains, mapped = _check_gaf(out, N_READS, {f"read{i}": READ_LEN for i in range(N_READS)})
    print(f"[rspoa] {n_chains} chain rows, {mapped}/{N_READS} reads aligned, "
          "no subgraph GFA written")
    n = _cpu_rerun(work, "rspoa", prefix, gfa, reads, out, ["-p", "rspoa", "--precision", "exact"])
    print(f"[rspoa] first {n} reads: chains and alignments GAF byte-identical "
          "to the --device cpu --precision exact run")

    args = captured["poa_local"][0]
    want = PD.poa_local_plain(*args)
    got = PD.poa_local_warp(*args)
    names = ("best", "tape", "tlen", "qend", "n_backing")
    errs, errs4 = [], []
    _check_equal("poa_local_warp on the main reads' batch", names, got,
                 (*want, PD.backing_rows_plain(args[1], args[2], PD.LOCAL_RING, PD.LOCAL_PINS)),
                 errs)
    _check_equal("poa_local (K4) on the main reads' batch", names[:4],
                 PD.poa_local_block(*args), want, errs4)
    turns, line = _local_turns(args)
    plain_ms = _cuda_ms(lambda: PD.poa_local_plain(*args), 1)
    B, V = args[0].shape
    W, P = args[3].shape[1] + 1, args[1].shape[-1]
    bound = _bound_keys(*_local_work(args), F32_OPS_PER_S)
    print(f"[rspoa] local POA on the main reads' largest batch B={B} V={V} W={W} P={P}, mean "
          f"nv {float(args[2].float().mean()):.2f}: K7 and K4 equal to the twin, "
          f"{int((got[4] > 0).sum())} problems on K7's backing store; in turns {line} ms; "
          f"plain {plain_ms:.3f} ms; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}) "
          f"({card})")
    results["poa_local"]["max_abs_err"] = max(results["poa_local"]["max_abs_err"], *errs4)
    results["poa_local_warp"].update(
        max_abs_err=max(results["poa_local_warp"]["max_abs_err"], *errs),
        ms=sum(turns["K7", "wrapper"]) / 2, plain_ms=plain_ms, **bound)
    torch.cuda.synchronize()
    return launches


def _keep_largest(module, name, work, captured):
    """Wrap ``module.name`` so that ``captured[name]`` keeps the arguments
    of its call with the most ``work(args)``; returns the real function."""
    real = getattr(module, name)

    def keep(*args, **kw):
        w = work(args)
        if name not in captured or w > captured[name][1]:
            captured[name] = (args, w)
        return real(*args, **kw)

    setattr(module, name, keep)
    return real


def _long_chain_launch(label, args, exact, card):
    """The chaining kernel (K5 with ``exact``, else K1) on the launch the
    long-read run gave it: held against its plain twin and timed through
    its wrapper; the rows each read has to its last valid anchor."""
    import torch

    from vgaligner_tpu_torch.ops import chain as C

    fn, plain = (C.chain_dp_exact, C.chain_dp_exact_plain) if exact else (C.chain_dp,
                                                                          C.chain_dp_plain)
    errs = []
    _check_equal(f"{label} on the long reads' launch", ("f", "pred", "curr_max"), fn(*args),
                 plain(*args), errs)
    ms = _cuda_ms(lambda: fn(*args), 10)
    bound = _bound_keys(*_chain_work(args[:4], exact), F64_OPS_PER_S if exact else F32_OPS_PER_S)
    B, A = args[0].shape
    last = torch.where(args[3], torch.arange(A, device=args[3].device), -1).max(dim=1).values + 1
    print(f"[long] {label} on the long reads' launch B {B} x A {A}: equal to the twin; "
          f"{ms:.4f} ms through its wrapper, bound {bound['bound_ms']:.4f} ({bound['bound_by']}); "
          f"rows to the last valid anchor max {int(last.max())}, mean "
          f"{float(last.float().mean()):.1f}, {int(args[3].sum())} valid anchors ({card})")


def phase_long_reads(work, prefix, gfa, graph, card, results):
    from vgaligner_tpu_torch.ops import chain as C
    from vgaligner_tpu_torch.ops import poa_device as PD
    from vgaligner_tpu_torch.testing import long_reads, write_fasta

    reads = long_reads(graph, N_LONG)
    fasta = os.path.join(work, "long.fa")
    write_fasta(fasta, reads)
    out = os.path.join(work, "long-card", "smoke")
    argv = ["-p", "abpoa", "--precision", "fast"]
    captured, chunks = {}, []
    real = PD.poa_dp_tb_cluster

    def keep(*args):
        chunks.append(args)
        return real(*args)

    PD.poa_dp_tb_cluster = keep
    real_k1 = _keep_largest(C, "chain_dp", lambda a: a[0].numel(), captured)
    try:
        took, launches = _drive("the long-read path", prefix, fasta, gfa, out, argv,
                                ("chain_dp", "poa_dp_tb_cluster"),
                                ("poa_dp", "poa_traceback", "poa_dp_tb", "poa_local_cluster"))
    finally:
        PD.poa_dp_tb_cluster = real
        C.chain_dp = real_k1
    n_chains, mapped = _check_gaf(out, len(reads),
                                  {f"read{i}": len(r) for i, r in enumerate(reads)})
    t0 = time.monotonic()
    n = _cpu_rerun(work, "long", prefix, gfa, reads, out, argv, len(reads))
    cpu_took = time.monotonic() - t0
    print(f"[long] map -p abpoa -D on {N_LONG} reads of 1,500-2,100 bp and one of 10 kb: "
          f"card {took:.2f} s ({card}); {mapped}/{len(reads)} aligned; all {n} reads again on "
          f"the CPU plain path ({cpu_took:.2f} s), chains and alignments GAF byte-identical; "
          f"launches {launches}")
    _long_chain_launch("K1", captured["chain_dp"][0], False, card)
    # each chunk's real problems (nv > 0), the ones its drain decodes: a
    # padding problem's walk reads rows past its nv, which only the plain
    # pair computes
    errs = []
    for i, args in enumerate(chunks):
        real = args[3] > 0
        _fused_check([x[real].contiguous() for x in args[:6]], args[6],
                     f"poa_dp_tb_cluster on the long reads' chunk {i}", errs, PD.poa_dp_tb_cluster)
    k8 = results["poa_dp_tb_cluster"]
    k8["max_abs_err"] = max(k8["max_abs_err"], *errs)
    print(f"[long] K8 equal to the plain pair on the real problems of each of the {len(chunks)} "
          "chunks (real problems, B, V, W): " + ", ".join(
              str((int((a[3] > 0).sum()), a[0].shape[0], a[0].shape[1], a[6].shape[0]))
              for a in chunks))
    _long_chunk_kernels(max(chunks, key=lambda a: int(a[3].sum()) * a[4].shape[1]), card,
                        results)
    return launches, _long_rspoa(work, prefix, gfa, fasta, reads, card, results)


def _long_rspoa(work, prefix, gfa, fasta, reads, card, results):
    """The rspoa route over the long reads, whose local POA rows are of
    512-8,192 columns: K9 and K5 launched, K4, K7 and K1 not; both GAFs
    byte-identical to the CPU plain path; each launch's shape and bytes
    under the route's budget, and K9 held against its twin on each; K5
    held and timed on its launch; K9 and K4 timed in turns on the largest
    local POA batch."""
    import numpy as np

    from vgaligner_tpu_torch.ops import chain as C
    from vgaligner_tpu_torch.ops import poa_device as PD

    captured, batches = {}, []
    real = PD.poa_local

    def keep(*args, back_rows=None):
        B, V = args[0].shape
        W, P = args[3].shape[1] + 1, args[1].shape[-1]
        back = np.zeros(B) if back_rows is None else np.asarray(back_rows)
        batches.append((args, (B, V, W, P, int(args[2].sum()), int(back.sum()),
                               int(PD.local_problem_bytes(V, W, P, back).sum()))))
        return real(*args, back_rows=back_rows)

    PD.poa_local = keep
    real_k5 = _keep_largest(C, "chain_dp_exact", lambda a: a[0].numel(), captured)
    out = os.path.join(work, "long-rspoa", "smoke")
    argv = ["-p", "rspoa", "--precision", "exact"]
    try:
        took, launches = _drive("the long-read rspoa path", prefix, fasta, gfa, out, argv,
                                ("chain_dp_exact", "poa_local_cluster"),
                                ("poa_local", "poa_local_warp", "chain_dp", "poa_dp",
                                 "poa_traceback", "poa_dp_tb", "poa_dp_tb_cluster"))
    finally:
        PD.poa_local = real
        C.chain_dp_exact = real_k5
    _n_chains, mapped = _check_gaf(out, len(reads),
                                   {f"read{i}": len(r) for i, r in enumerate(reads)})
    t0 = time.monotonic()
    n = _cpu_rerun(work, "long-rspoa", prefix, gfa, reads, out, argv, len(reads))
    print(f"[long] map -p rspoa -D --precision exact on the same reads: card {took:.2f} s "
          f"({card}); {mapped}/{len(reads)} aligned; all {n} reads again on the CPU plain path "
          f"({time.monotonic() - t0:.2f} s), chains and alignments GAF byte-identical; launches "
          f"{launches}")
    print(f"[long] rspoa local POA launches under the budget of {PD._LOCAL_BUDGET} bytes "
          "(B, V, W, P, nv sum, backing rows, bytes): " + "; ".join(str(b) for _a, b in batches))
    _long_chain_launch("K5", captured["chain_dp_exact"][0], True, card)
    _long_local_batches([a for a, _b in batches], card, results)
    return launches


def _long_local_batches(batches, card, results):
    """K9 held against the twin on every batch of the long-read rspoa
    leg; on the largest, K4 held too, K4 and K9 timed in turns, and K9's
    bound from that batch."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    names = ("best", "tape", "tlen", "qend", "n_backing")
    errs9, errs4, on_backing = [], [], 0
    for i, args in enumerate(batches):
        back = PD.backing_rows_plain(args[1], args[2], PD.LOCAL_RING, PD.LOCAL_PINS)
        _check_equal(f"poa_local_cluster (K9) on the long reads' batch {i}", names,
                     PD.poa_local_cluster(*args), (*PD.poa_local_plain(*args), back), errs9)
        on_backing += int((back > 0).sum())
    args = max(batches, key=lambda a: int(a[2].sum()) * a[3].shape[1])
    _check_equal("poa_local (K4) on the long reads' largest batch", names[:4],
                 PD.poa_local_block(*args), PD.poa_local_plain(*args), errs4)
    turns, line = _local_turns(args, "K9")
    plain_ms = _cuda_ms(lambda: PD.poa_local_plain(*args), 1)
    bound = _bound_keys(*_local_work(args), F32_OPS_PER_S)
    results["poa_local"]["max_abs_err"] = max(results["poa_local"]["max_abs_err"], *errs4)
    results["poa_local_cluster"].update(
        max_abs_err=max(results["poa_local_cluster"]["max_abs_err"], *errs9),
        ms=sum(turns["K9", "wrapper"]) / 2, plain_ms=plain_ms, **bound)
    B, V = args[0].shape
    W, P = args[3].shape[1] + 1, args[1].shape[-1]
    ctas, clusters, smem = PD.poa_local_cluster_occupancy(P, W, V)
    torch.cuda.synchronize()
    print(f"[long] K9 equal to the twin on each of the {len(batches)} rspoa batches "
          f"({on_backing} problems on its backing store); largest B={B} V={V} W={W} P={P} mean nv "
          f"{float(args[2].float().mean()):.1f} (max {int(args[2].max())}): K4 equal to the "
          f"twin; K4 and K9 in turns {line} ms; K9 {ctas} CTAs a cluster, {clusters} clusters "
          f"resident, {smem} B shared memory a CTA; bound {bound['bound_ms']:.4f} "
          f"({bound['bound_by']}); plain {plain_ms:.3f} ms ({card})")


def _long_chunk_kernels(args, card, results):
    """K8, and K2 + K3, on the long-read path's largest chunk: held against
    the twins (score, best_sink, tbits below nv; tape and tlen), timed in
    turns (K2 + K3, K8, K8, K2 + K3), and bounded from that chunk."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    t, init = args[:6], args[6]
    errs, errs8 = [], []
    nb = _fused_check(t, init, "poa_dp_tb_cluster on the long reads' largest chunk", errs8,
                      PD.poa_dp_tb_cluster)
    score, sinks, tbits = PD.poa_dp(*t, init)
    tape, tlen = PD.poa_traceback(tbits, t[1], sinks, t[5])
    torch.cuda.synchronize()
    ws, wk, wtb = PD.poa_dp_plain(*t, init)
    _check_equal("poa_dp on the long reads' largest chunk", ("score", "best_sink"),
                 (score, sinks), (ws, wk), errs)
    below_nv = torch.arange(tbits.shape[1], device=tbits.device)[None, :] < t[3][:, None]
    if not torch.equal(tbits[below_nv], wtb[below_nv]):
        raise AssertionError("poa_dp on the long reads' largest chunk: tbits differ below nv")
    wtape, wtl = PD.poa_traceback_plain(tbits, t[1], sinks, t[5])
    _check_equal("poa_traceback on the long reads' largest chunk", ("tape", "tlen"),
                 (tape, tlen), (wtape, wtl), errs)
    k2, k3, k8 = _time_in_turns(t, init, fused=PD.poa_dp_tb_cluster)
    plain_dp = _cuda_ms(lambda: PD.poa_dp_plain(*t, init), 1)
    plain_tb = _cuda_ms(lambda: PD.poa_traceback_plain(tbits, t[1], sinks, t[5]), 1)
    B, V, W = tbits.shape
    P = t[1].shape[-1]
    dp_bytes, dp_ops = _poa_dp_work(t)
    tb_bytes, tb_ops = _walk_work(tlen, B, V, W, False)
    results["poa_dp"].update(ms=sum(k2) / 2, plain_ms=plain_dp,
                             max_abs_err=max(results["poa_dp"]["max_abs_err"], *errs),
                             **_bound_keys(dp_bytes, dp_ops, F32_OPS_PER_S))
    results["poa_traceback"].update(ms=sum(k3) / 2, plain_ms=plain_tb,
                                    **_bound_keys(*_walk_work(tlen, B, V, W), F32_OPS_PER_S))
    results["poa_dp_tb_cluster"].update(
        ms=sum(k8) / 2, plain_ms=plain_dp + plain_tb,
        max_abs_err=max(results["poa_dp_tb_cluster"]["max_abs_err"], *errs8),
        **_bound_keys(dp_bytes + tb_bytes, dp_ops + tb_ops, F32_OPS_PER_S))
    ctas, clusters, smem = PD.poa_dp_tb_cluster_occupancy(P, W, V)
    k8r = results["poa_dp_tb_cluster"]
    print(f"[long] largest chunk B={B} V={V} W={W} P={P} mean nv {float(t[3].float().mean()):.1f} "
          f"(max {int(t[3].max())}), {int((nb > 0).sum())} problems on K8's backing store: K8, K2 "
          f"and K3 equal to the twins; in turns {_turns_line(k2, k3, k8, 'K8')}; K8 bound "
          f"{k8r['bound_ms']:.4f} ({k8r['bound_by']}), {ctas} CTAs a cluster, {B * ctas} CTAs, "
          f"{clusters} clusters resident, {smem} B shared memory a CTA; K2 bound "
          f"{results['poa_dp']['bound_ms']:.4f} ({results['poa_dp']['bound_by']}; plain "
          f"{plain_dp:.3f}), K3 bound {results['poa_traceback']['bound_ms']:.4f} "
          f"({results['poa_traceback']['bound_by']}; plain {plain_tb:.3f}) ({card})")


def kernel_line(results, launches, launches_rspoa, launches_long, launches_long_rspoa):
    """The per-kernel result line: each kernel with the launches of the
    path that runs it and its measured and bound times."""
    k2_replaces = "vgaligner_tpu/ops/poa_pallas2.py:434, vgaligner_tpu/ops/poa_pallas.py:258"
    k3_replaces = "vgaligner_tpu/ops/poa_device.py:325"
    other = "(rows of 16,384 columns, and lane-padded widths off the power-of-two ladder)"
    sources = {
        "chain_dp": ("chain_dp.cu", "vgaligner_tpu/ops/chain_pallas.py:187", launches),
        "poa_dp": ("poa_dp.cu", f"{k2_replaces} {other}", launches_long),
        "poa_traceback": ("poa_traceback.cu", f"{k3_replaces} {other}", launches_long),
        "poa_dp_tb": ("poa_dp_tb.cu", f"{k2_replaces}, {k3_replaces} (rows up to 256 "
                      "columns)", launches),
        "poa_dp_tb_cluster": ("poa_dp_tb_cluster.cu", f"{k2_replaces}, {k3_replaces} (rows of "
                              "512-8,192 columns)", launches_long),
        "poa_local": ("poa_local.cu", "vgaligner_tpu/ops/poa_device.py:1075 (rows of 16,384 "
                      "columns)", launches_long_rspoa),
        "poa_local_warp": ("poa_local_warp.cu", "vgaligner_tpu/ops/poa_device.py:1075 (rows up "
                           "to 256 columns)", launches_rspoa),
        "poa_local_cluster": ("poa_local_cluster.cu", "vgaligner_tpu/ops/poa_device.py:1075 "
                              "(rows of 512-8,192 columns)", launches_long_rspoa),
        "chain_dp_exact": ("chain_dp_exact.cu", "vgaligner_tpu/ops/chain.py:102-177",
                           launches_rspoa),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"kernels": [
        dict(name=name, route="cuda", source=f"vgaligner_tpu_torch/kernels/csrc/{src}",
             replaces=rep, launches=counts[name], **{k: results[name][k] for k in keys})
        for name, (src, rep, counts) in sources.items()
    ]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vgaligner_tpu_torch import cli
    from vgaligner_tpu_torch.graph import graph_from_gfa
    from vgaligner_tpu_torch.index import Index
    from vgaligner_tpu_torch.testing import sample_reads, write_fasta, write_synthetic_gfa

    t_start = time.monotonic()
    card = phase_env()
    dev = torch.device("cuda", 0)
    phase_build()

    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="vg_chip_smoke_")
    results = {}
    try:
        gfa = os.path.join(work, "graph.gfa")
        shape = write_synthetic_gfa(gfa, seed=SEED_GRAPH)
        graph = graph_from_gfa(gfa)
        reads = sample_reads(graph, N_READS, READ_LEN, seed=77)
        fasta = os.path.join(work, "reads.fa")
        write_fasta(fasta, reads)
        print(f"[data] synthetic graph {shape}, {len(reads)} reads of {READ_LEN} bp")
        index = Index.build(graph, K, 100, 100)
        prefix = os.path.join(work, "graph")
        cli.main(["index", "-i", gfa, "-k", str(K), "-o", prefix])

        def timed(name, fn, *args):
            out = fn(*args)
            print(f"[time] {name} done at {time.monotonic() - t_start:.1f} s")
            return out

        timed("chain kernels", phase_chain_kernels, index, reads, dev, results)
        main_t, main_init = timed("POA kernels", phase_poa_kernels, dev, results)
        timed("K6", phase_fused_kernel, dev, results, main_t, main_init)
        timed("K8", phase_cluster_kernel, dev, results)
        timed("K4", phase_local_kernel, dev, results)
        timed("K7", phase_local_warp_kernel, dev, results)
        timed("K9", phase_local_cluster_kernel, dev, results)
        launches = timed("abPOA CLI", phase_main_path, work, prefix, gfa, fasta, reads, card,
                         results)
        launches_rspoa = timed("rspoa CLI", phase_rspoa_path, work, prefix, gfa, fasta, reads,
                               card, dev, results)
        launches_long, launches_long_rspoa = timed("long-read CLI", phase_long_reads, work,
                                                   prefix, gfa, graph, card, results)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)

    line = kernel_line(results, launches, launches_rspoa, launches_long, launches_long_rspoa)
    print(f"[done] smoke took {time.monotonic() - t_start:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
