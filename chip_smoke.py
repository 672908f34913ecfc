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
       K6, the POA DP and traceback in one kernel for rows up to 256
       columns, on batches with far predecessors and more far-referenced
       vertices than it pins (its backing store), P 2/4/8 x W 32/128/256,
       and at the main path's chunk shape (1,024 x 256 x 128), where it is
       timed beside the plain pair on the same CUDA tensors; the
       lane-padded contract of the JAX package's VMEM-resident Pallas DP
       (poa_global_kernel, 1,024 x 256, L 100), which K6 runs;
       K8, the POA DP and traceback in one kernel for rows of 512-16,384
       columns, one thread-block cluster a problem (512 columns a CTA, 1,024
       at W 16,384), at every width of CLUSTER_WIDTHS x P 2/4/8 (V 256, 128
       from W 8,192; timed at W 16,384) and at V 8,192 x W 2,048 and W
       8,192 x V 1,024, on batches with far predecessors, pin overflow, a
       predecessor at and past its vertex and nv = 4; at V 8,192 x W
       16,384 (B 2, nv near 8,192, far predecessors: the largest problem
       the device route has), held to the plain pair and timed beside it;
       its cluster size, clusters resident, shared memory a CTA, and ptxas
       registers and spills of each instance;
       K7 local POA, one warp a problem, for rows up to 256 columns, with
       the host's backing-row counts, on P 2/4/8 x W 32/64/128/256 x V
       64/256/2,048 batches with far predecessors past its ring, problems
       over its pin budget (its backing store), a predecessor at and past
       its vertex, nv far below V and nv = 0, and at V 2,048 and 8,192 on
       a chain whose best run takes a far edge whose backing row ranks
       behind far rows in every bitmap word; given one backing row too
       few, tlen -1 on each problem short of rows, and the rspoa route
       (``align_local_batch``) raises; its ptxas registers and spills,
       and its occupancy at the rspoa batch shape;
       K9 local POA, one thread-block cluster a problem, for rows of
       512-16,384 columns, at every width x P 2/4/8 with far predecessors,
       pin overflow, a predecessor at and past its vertex and nv = 4 and
       0, and on chains whose best run takes a far edge (pinned, and on
       the backing store) where a CTA's columns start (W 4,096, 8,192 and
       16,384); at W 16,384 (B 8 x V 128, and V 8,192) through
       ``poa_local``, held to the twin and timed beside it; its occupancy
       and ptxas report;
       K5 exact chaining DP on the real anchors at 4,096 x 256 and at
       A = 16,384 and 65,536, then both of its paths (one divide a row;
       one a pair, which a gap table with a negative entry or with scores
       past its 2^41 bound takes) on the real anchors and on reads whose
       valid anchors are scattered, timed at 4,096 x 256 beside K1; its
       ptxas registers and spills, shared memory a block and reads
       resident an SM beside that launch (and beside the long reads'
       launch, below);
  4. the main path through the CLI entry points: ``index -k 11`` and
     ``map -p abpoa -D -G --precision auto`` over 12,288 100 bp reads of
     a seeded HLA-scale synthetic graph (4,760 nodes, 12 haplotypes),
     with ``-t 0`` (one rank on the one card, no process spawned):
     K1 and K6 launched (K6 twice: one launch of real problems under the
     route's byte budget for each stream batch of 8,192 and 4,096 reads),
     K8 not; the launches' mean nv and how many problems took K6's
     backing store; K6 held against the plain pair and timed on the
     largest of those launches, and that launch timed in turns against
     the ladder plan it replaced (chunks of 1,024 problems), both on K6
     with the host's backing-row counts; the first 256 reads again with
     ``--device cpu --precision fast`` (the plain twins), and both GAFs
     byte-identical for those reads;
  5. the sharded path: the same reads through ``stream_map_align`` with
     ``Mapper(mesh=..., shard_index=True, precision="fast")`` and an
     abPOA ``PoaAligner(mesh=...)`` in a world-size-1 NCCL group on the
     card (bucket agreement, the position gather's all-gather and
     reduce-scatter, the per-batch GAF merge): both GAFs byte-identical
     to phase 4's, K1 and K6 launched, and the collectives counted (one
     all-reduce a batch, an all-gather and a reduce-scatter a mapping
     launch, two all-gathers a merge); no CPU fallback: without NCCL the
     smoke fails;
  6. the rspoa path: ``map -p rspoa -D -G --precision exact`` over the
     same reads: K7 and K5 launched, K1, K6 and K9 not, no subgraph GFA
     written, 95 % of reads aligned, and the first 256 reads
     byte-identical to ``--device cpu --precision exact``; on the
     largest batch that run gave the local POA, K7 (with the host's
     backing-row counts, as the route called it) is held against its
     twin and timed, through its wrapper and as the kernel alone on
     buffers allocated once, beside the twin;
     that launch's backing rows, its device bytes by
     ``local_problem_bytes`` and K7's peak device memory on it, held
     under the route's byte budget;
  7. long reads: ``map -p abpoa -D -G --precision fast`` over 64 reads
     of 1,500-2,100 bp and one 10 kb read (POA rows of W 2,048/4,096 on
     K8, not K6, and a subgraph over 8,192 vertices on the
     native host POA), both GAFs byte-identical to ``--device cpu``; K1
     held and timed on the launch that run gave it; K8 launched 3 times,
     once a (V, W) bucket, on real problems only, and held against the
     plain pair on every launch, timed beside the plain pair on the
     largest, and that launch timed in turns against the ladder plan it
     replaced (chunks of 32 problems); then ``map -p rspoa -D -G --precision exact``
     over the same reads (local POA rows of 2,048 and 4,096 columns: K9
     and K5 launched, K7 and K1 not), both GAFs byte-identical to
     ``--device cpu``, each local POA launch's shape and bytes under the
     route's budget, K9 held against its twin on each, K5 held and timed
     on its launch, and K9 timed beside the twin on the largest local POA
     batch.
  8. the Python subgraph route: the 12,288 reads mapped on the card by
     ``Mapper(index, precision="fast")`` with no device (the card by
     default), every selected chain's subgraph built by the Python route
     (``PoaAligner._range_for_chain``, ``find_nodes_edges``) and held to
     the native extractor's in corridor mode (and in id mode with bubble
     closure on a seeded 1,024-read sample), then ``align_global_batch``
     on the card: K6 once a (V, L) bucket, K8 not; every
     PoaResult and GAF row equal to the native CLI route's, and a seeded
     256-problem sample equal on the CPU; then the same on the long
     reads (K8 launched, the 10 kb read's subgraph on the native host
     POA, a seeded sample of 8 on the CPU); the host's seconds a chain
     and the card's problems/s;
  9. rows of 16,384 columns: ``align_global_batch`` and
     ``align_local_batch`` on the card over five problems of 8.3-14 kb
     queries on subgraphs under 8,192 base vertices: K8 and K9 launched
     at W 16,384, K6 and K7 not, every result equal to the host
     oracle and the smallest problem's to the CPU route, K8 and K9 at
     most 3 launches each; the largest problem (V 8,192 x W 16,384)
     alone through ``align_global_batch`` with its peak device memory
     read around the call and held under the route's byte budget; then
     two 8.4 kb
     reads through the CLI (abPOA, and rspoa + exact; one's POA on K8 and
     K9 at W 16,384, the other's over the vertex cap on the host): K8
     held to the plain pair on its launch, the rspoa GAFs byte-identical
     to the CPU run;
 10. the suite runner: ``run_suite.run_dataset`` on two synthetic
     datasets (seeds 0 and 1) at 512 reads of 100 bp, abPOA, fast, on the
     card (K1 and K6 launched) and on the CPU: every report field but the
     timings equal (reads_found, avg_jaccard, exact_rate); the card's
     map_align_rps.
Every CLI phase resets the launch counters just before its run and
reads them just after; a kernel's ``launches`` are those of the path
that runs it (K1 and K6: abPOA; K7 and K5: rspoa; K8: long reads,
abPOA; K9: long reads, rspoa; K8 and K9 at W 16,384: the library calls
of phase 9).

Then one JSON line of per-kernel results and, last, the device line.
Each kernel's ``ms`` is its mean over two timings through its wrapper,
``plain_ms`` its plain PyTorch twin's on the same CUDA tensors, and
``bound_ms`` the least time of the launch it was timed on as the
benchmark counts it (``vgbench.work``: the problem's own bytes and
operations, whatever implements it, over one H100's memory rate and
peak rates).  No single PyTorch call computes any of these functions,
so ``library_ms`` is null throughout.
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

from vgbench.work import F32_OPS_PER_S, F64_OPS_PER_S, bound_s, chain_work, global_work, local_work

N_READS = 12288
READ_LEN = 100
K = 11
CPU_SAMPLE = 256
SEED_GRAPH = 0
N_LONG = 64
# K6's launches on the abPOA path for N_READS reads: one a stream batch of
# 8,192 and 4,096 reads (real problems only, under the route's byte budget)
MAIN_LAUNCHES = 2
LONG_LAUNCHES = 3  # K8's on the long reads' abPOA path: one a (V, W) bucket
# the ladder plan the byte budget replaced: chunks of at most 1,024
# problems (K6's rows), and of 32 at V 2,048 x W 2,048 (K8's)
LADDER_CHUNK = {"poa_dp_tb": 1024, "poa_dp_tb_cluster": 32}

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


def _bound_keys(work, ops_per_s=F32_OPS_PER_S):
    """A result's bound_ms and bound_by from ``vgbench.work``'s (bytes,
    operations) of a launch, and its library_ms (none)."""
    s, by = bound_s(*work, ops_per_s)
    return dict(bound_ms=s * 1e3, bound_by=by, library_ms=None)


def _chain_bound(args, exact):
    """The bound keys of a chaining launch on (qb, tb, te, valid)."""
    work = chain_work(args[3].sum(dim=1).cpu().numpy(), 50, exact)
    return _bound_keys(work, F64_OPS_PER_S if exact else F32_OPS_PER_S)


def _global_bound(t, tlen):
    """The bound keys of a global POA launch on t (vcodes, vpred, is_sink,
    nv, q, nq) whose walks took ``tlen`` steps."""
    return _bound_keys(global_work(*(x.cpu().numpy() for x in (t[1], t[3], t[5], tlen))))


def _local_bound(args, tlen):
    """The bound keys of a local POA launch on args (vcodes, vpred, nv, q,
    nq) whose walks took ``tlen`` steps."""
    return _bound_keys(local_work(*(x.cpu().numpy() for x in (args[1], args[2], args[4], tlen))))


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
    _k5_residency("the main launch", main[0].shape[0], dev)
    results["chain_dp"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                               **_chain_bound(fa, False))
    results["chain_dp_exact"] = dict(max_abs_err=max(errs_x), ms=ms_x, plain_ms=plain_x,
                                     **_chain_bound(main, True))
    print(f"[kernels] chaining 4096x256: K1 fast {ms:.3f} ms (plain {plain_ms:.3f} ms), "
          f"K5 exact {ms_x:.3f} ms (plain {plain_x:.3f} ms)")

    gaps = torch.arange(0, 1001, dtype=torch.int32)
    g_dev = C.gap_cost_scaled_i32(gaps.to(dev), K).cpu()
    g_cpu = C.gap_cost_scaled_i32_plain(gaps, K)
    g_f64 = torch.from_numpy(np.floor(table * 1000.0 + 0.5).astype(np.int64))
    if not torch.equal(g_dev, g_cpu) or not torch.equal(g_dev.to(torch.int64), g_f64):
        raise AssertionError("gap cost on the card differs from the CPU / f64 table")
    print("[kernels] gap cost g=0..1000: card == CPU plain == rounded f64 table")


def _c_call(entry, ptrs, name, *buffers):
    """A call of the C entry ``entry`` on ``ptrs`` that holds ``buffers``,
    the tensors behind those pointers, for as long as the call lives: a
    closure over the pointers alone would let the allocator hand their
    memory to the next tensor while the kernel still writes there."""
    from vgaligner_tpu_torch import kernels

    def call():
        kernels.check(entry(*ptrs), name)
        return buffers

    return call


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
        return _c_call(so.vg_chain_dp_exact, ptrs, "chain_dp_exact", f, pred, cmax, tab)
    ptrs = [*ins, B, A, K, 50, 1000, *outs]
    return _c_call(so.vg_chain_dp, ptrs, "chain_dp", f, pred, cmax)


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


def _k5_residency(label, B, dev):
    """K5's ptxas report of each instance, and its residency on this
    card beside a launch of B reads."""
    import torch

    from vgaligner_tpu_torch import kernels
    from vgaligner_tpu_torch.ops import chain as C

    regs = _ptxas(kernels.build_log, "chain_dp_exact_kernel")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    occ = C.chain_dp_exact_occupancy(50)
    per_sm = occ["blocks_an_sm"] * occ["reads_a_block"]
    print(f"[kernels] K5 ptxas (DIV_ONCE: registers, spill store/load bytes): " + "; ".join(
        f"{a}: {r}, {st}/{ld}" for a, r, st, ld in regs) + f"; {occ['reads_a_block']} reads "
        f"(two warps each) a block, {occ['smem']} B shared memory a block, "
        f"{occ['blocks_an_sm']} blocks an SM: {per_sm} reads resident an SM, {per_sm * sms} on "
        f"the card, against {B} reads at {label} ({-(-B // (per_sm * sms))} wave(s))")


def _plain_pair(t, init):
    """poa_dp_plain then poa_traceback_plain on t: (score, best_sink,
    tbits, tape, tlen)."""
    from vgaligner_tpu_torch.ops import poa_device as PD

    score, sinks, tbits = PD.poa_dp_plain(*t, init)
    return (score, sinks, tbits, *PD.poa_traceback_plain(tbits, t[1], sinks, t[5]))


def _fused_check(t, init, label, errs, fused=None, want=None):
    """K6 (or ``fused``, K8) against poa_dp_plain + poa_traceback_plain on
    the same CUDA tensors (``want``: their outputs, run already): score,
    best_sink, tape, tlen and tbits below nv bit for bit, and n_backing
    equal to backing_rows_plain.  Returns n_backing."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    score, sink, tbits, tape, tlen, n_backing = (fused or PD.poa_dp_tb)(*t, init)
    torch.cuda.synchronize()
    ws, wk, wtb, wtape, wtl = want or _plain_pair(t, init)
    _check_equal(label, ("score", "best_sink", "tape", "tlen", "n_backing"),
                 (score, sink, tape, tlen, n_backing),
                 (ws, wk, wtape, wtl, PD.backing_rows_plain(t[1], t[3])), errs)
    below_nv = torch.arange(tbits.shape[1], device=tbits.device)[None, :] < t[3][:, None]
    if not torch.equal(tbits[below_nv], wtb[below_nv]):
        raise AssertionError(f"{label}: tbits differ below nv")
    return n_backing


def _fused_ms(t, init, fused, reps):
    """A fused kernel (K6 or K8) through its wrapper with the host's
    backing-row counts, after a warm-up, timed twice on t: ([ms, ms],
    tlen)."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    back = PD.backing_rows_plain(t[1], t[3]).cpu().numpy()
    tlen = fused(*t, init, back)[4]
    torch.cuda.synchronize()
    return [_cuda_ms(lambda: fused(*t, init, back), reps) for _ in range(2)], tlen


def _fused_timed(t, init, fused, reps=10, plain_ms=None):
    """``_fused_ms`` beside the plain pair (``plain_ms``, or timed here
    once).  Returns the kernel's result entry (ms, plain_ms, bound) and
    the line that reports it."""
    ms, tlen = _fused_ms(t, init, fused, reps)
    if plain_ms is None:
        plain_ms = _cuda_ms(lambda: _plain_pair(t, init), 1)
    entry = dict(ms=sum(ms) / 2, plain_ms=plain_ms, **_global_bound(t, tlen))
    line = (f"{ms[0]:.4f}, {ms[1]:.4f} ms, plain pair {plain_ms:.3f} ms, bound "
            f"{entry['bound_ms']:.4f} ({entry['bound_by']})")
    return entry, line


def _plan_turns(t, init, fused, chunk, reps=10):
    """One launch of ``fused`` (K6 or K8) over the whole batch t, the byte
    budget's plan, against the ladder plan it replaced, launches of at
    most ``chunk`` of the same real problems (without the zeroed pads
    that plan added to its last chunk), both with the host's backing-row
    counts, in turns ladder, one, one, ladder.  Returns (one launch ms,
    ladder ms, the ladder's launches), two turns each."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    back = PD.backing_rows_plain(t[1], t[3]).cpu().numpy()
    B = t[0].shape[0]
    cuts = [(s, min(s + chunk, B)) for s in range(0, B, chunk)]

    def ladder():
        for s, e in cuts:
            fused(*(x[s:e] for x in t), init, back[s:e])

    ladder()
    fused(*t, init, back)
    torch.cuda.synchronize()
    one, old = [], []
    for turn in ("old", "new", "new", "old"):
        if turn == "old":
            old.append(_cuda_ms(ladder, reps))
        else:
            one.append(_cuda_ms(lambda: fused(*t, init, back), reps))
    return one, old, len(cuts)


def phase_fused_kernel(dev, results):
    import torch

    from vgaligner_tpu_torch import kernels
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
    # the main path's chunk shape
    t = [torch.from_numpy(a).to(dev) for a in random_poa_batch(7, 1024, 256, 2, 127)]
    init = torch.from_numpy(PD.make_init_row(127)).to(dev)
    nb = _fused_check(t, init, "poa_dp_tb 1024x256x128", errs)
    warps, blocks, smem = PD.poa_dp_tb_occupancy(2, 128, 256)
    print(f"[kernels] poa_dp_tb 1024x256x128 P=2: equal to the plain pair "
          f"({int((nb > 0).sum())} problems on the backing store); {warps} problems a "
          f"block, {blocks} blocks an SM, {smem} B shared memory a block: "
          f"{warps * blocks * torch.cuda.get_device_properties(dev).multi_processor_count} "
          "problems resident")
    entry, line = _fused_timed(t, init, PD.poa_dp_tb)
    print(f"[kernels] K6 1024x256x128 P=2: {line}")

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
    _check_equal("poa_global_kernel 1024x256 L=100", ("score", "tape", "tlen"), got, want, errs)
    print(f"[kernels] poa_global_kernel 1024x256 L=100 (l_w {q_w.shape[1] + 1}, on "
          "poa_dp_tb): score/tape/tlen equal to the plain chain")
    results["poa_dp_tb"] = dict(max_abs_err=max(errs), **entry)


def phase_cluster_kernel(dev, results):
    """K8 at every width of CLUSTER_WIDTHS x P 2/4/8 on far and near
    batches (far predecessors, pin overflow, a predecessor at and past its
    vertex, nv = 4), at V 8,192 x W 2,048, and at W 8,192 x V 1,024, timed
    alone at W 16,384 (16 CTAs of 1,024 columns); at V 8,192 x W 16,384 held to
    the plain pair and timed beside it; its cluster occupancy and ptxas
    report of each instance (P / columns a CTA)."""
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
        if W == 16384:
            ms, _tlen = _fused_ms(t, init, PD.poa_dp_tb_cluster, 5)
            print(f"[kernels] K8 P={P} W={W} V={V} B={B}: {ms[0]:.4f}, {ms[1]:.4f} ms")
    regs = _ptxas(kernels.build_log, "poa_dp_tb_cluster_kernel")
    print(f"[kernels] K8: {on_backing} problems of the grid on the backing store; ptxas (P/"
          "columns a CTA: registers, spill store/load bytes): " + "; ".join(
              f"{a}: {r}, {st}/{ld}" for a, r, st, ld in regs))
    results["poa_dp_tb_cluster"] = dict(max_abs_err=max(errs))
    # the largest problem the device route gives rows of 16,384 columns
    # (reads of 8,192-16,383 bp): V 8,192 x W 16,384, nv near V, far
    # predecessors past the pins
    t = [torch.from_numpy(a).to(dev)
         for a in random_poa_batch(230, 2, 8192, 4, 16383, far_frac=0.3, min_nv=8000)]
    init = torch.from_numpy(PD.make_init_row(16383)).to(dev)
    out, errs = {}, []
    plain_ms = _cuda_ms(lambda: out.update(want=_plain_pair(t, init)), 1)
    label = f"V 8,192 x W 16,384 (B 2, P 4, nv {t[3].tolist()}, far predecessors)"
    nb = _fused_check(t, init, f"poa_dp_tb_cluster {label}", errs, PD.poa_dp_tb_cluster,
                      out.pop("want"))
    entry, line = _fused_timed(t, init, PD.poa_dp_tb_cluster, 2, plain_ms)
    results["poa_dp_tb_cluster_w16384"] = dict(max_abs_err=max(errs), **entry)
    ctas, clusters, smem = PD.poa_dp_tb_cluster_occupancy(4, 16384, 8192)
    print(f"[kernels] {label}: K8 equal to the plain pair ({int((nb > 0).sum())} problems on "
          f"its backing store); {line}; {ctas} CTAs a cluster, {clusters} clusters resident, "
          f"{smem} B shared memory a CTA")


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


def _k7_short_of_rows(dev):
    """K7 given one backing row too few on each problem that needs rows:
    tlen -1 on those, the others as the twin gives them; then the rspoa
    route (``align_local_batch``, its launches given one row too few)
    raises rather than decode."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD
    from vgaligner_tpu_torch.testing import random_local_batch, with_local_edge_cases

    t = [torch.from_numpy(a).to(dev) for a in
         with_local_edge_cases(random_local_batch(571, 8, 256, 4, 127, far_frac=0.3))]
    back = PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING, PD.LOCAL_PINS).cpu().numpy()
    tlen = PD.poa_local_warp(*t, np.maximum(back - 1, 0))[2].cpu().numpy()
    want = PD.poa_local_plain(*t)[2].cpu().numpy()
    if not (back > 0).any() or (tlen[back > 0] != -1).any() or \
            (tlen[back == 0] != want[back == 0]).any():
        raise AssertionError(f"poa_local_warp one backing row short: tlen {tlen.tolist()}, "
                             f"rows {back.tolist()}, the twin's tlen {want.tolist()}")
    nodes = ["ACGT"[c] for c in np.random.default_rng(572).integers(0, 4, 120)]
    edges = [(b - 1, b) for b in range(1, 120)] + [(b - 12, b) for b in range(12, 120, 3)]
    real = PD.local_chunks

    def one_short(*args, **kw):
        for s, e, arrs, rows in real(*args, **kw):
            yield s, e, arrs, np.maximum(rows - 1, 0)

    PD.local_chunks = one_short
    try:
        PD.align_local_batch([(nodes, edges, "".join(nodes[:100]))] * 3, dev)
    except RuntimeError as e:
        if "backing rows" not in str(e):
            raise
        said = str(e)
    else:
        raise AssertionError("the rspoa route decoded a problem K7 marked short of rows")
    finally:
        PD.local_chunks = real
    print(f"[kernels] K7 one backing row short: tlen -1 on the {int((back > 0).sum())} problems "
          f"that need rows, the other {int((back == 0).sum())} as the twin; the rspoa route "
          f"raised: {said}")


def phase_local_warp_kernel(dev, results):
    import torch

    from vgaligner_tpu_torch import kernels
    from vgaligner_tpu_torch.ops import poa_device as PD
    from vgaligner_tpu_torch.testing import (far_rows_local_batch, random_local_batch,
                                             with_local_edge_cases)

    errs, on_backing = [], 0
    names = ("best", "tape", "tlen", "qend", "n_backing")

    def check(label, t):
        back = PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING, PD.LOCAL_PINS)
        got = PD.poa_local_warp(*t, back.cpu().numpy())
        _check_equal(label, names, got, (*PD.poa_local_plain(*t), back), errs)
        return got

    for P in (2, 4, 8):
        for W in (32, 64, 128, 256):
            for V in (64, 256, 2048):
                seed = 500 + P * 3 + W + V
                far = with_local_edge_cases(random_local_batch(seed, 24, V, P, W - 1,
                                                               far_frac=0.3))
                near = random_local_batch(seed + 1, 8, V, P, W - 1, far_frac=0.0)
                t = [torch.from_numpy(np.concatenate(x)).to(dev) for x in zip(far, near)]
                got = check(f"poa_local_warp P={P} W={W} V={V}", t)
                nb = got[4].cpu()
                if not bool((nb[:24] > 0).any()) or bool((nb[24:] != 0).any()):
                    raise AssertionError(f"poa_local_warp P={P} W={W} V={V}: batch lacks its "
                                         "edge cases")
                on_backing += int((nb > 0).sum())
                print(f"[kernels] poa_local_warp (K7) P={P} W={W} V={V} B=32, the host's "
                      f"backing rows: best/tape/tlen/qend/n_backing equal; "
                      f"{int((nb > 0).sum())} problems on the backing store (max "
                      f"{int(nb.max())} rows), max tlen {int(got[2].max())}")
    for V in (2048, 8192):
        nb = check(f"poa_local_warp far rows in the last bitmap words V={V}",
                   [torch.from_numpy(a).to(dev) for a in far_rows_local_batch(V, 256)])[4]
        if nb[0] <= 50 or nb[1] != 0:
            raise AssertionError(f"the far-row batch at V {V} lost its backing rows or its pin")
        print(f"[kernels] poa_local_warp (K7) V={V} W=256 P=2: a best run over a far edge in "
              f"the last of {V // 32} bitmap words, its row on the backing store behind far rows "
              f"in the words before ({int(nb[0])} rows), and over a pinned one: equal to the twin")
    _k7_short_of_rows(dev)
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
    CTA's columns start (W 4,096, 8,192 and 16,384); its cluster
    occupancy and ptxas report; at W 16,384 (B 8 x V 128 through
    ``poa_local``, and V 8,192 x W 16,384) held to the twin and timed
    beside it."""
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
    for W, boundary in ((4096, 2048), (8192, 4096), (16384, 14336)):
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
          "over a far edge at a CTA's first column (2,048 of W 4,096, 4,096 of W 8,192, 14,336 "
          "of W 16,384), pinned and on the backing store, equal; ptxas (P: registers, spill "
          "store/load bytes): "
          + "; ".join(f"{a}: {r}, {st}/{ld}" for a, r, st, ld in regs))
    results["poa_local_cluster"] = dict(max_abs_err=max(errs))
    # rows of 16,384 columns (reads of 8,192-16,383 bp) through the route:
    # 8 CTAs of 2,048 columns
    names, errs = names[:4], []
    t = [torch.from_numpy(a).to(dev)
         for a in with_local_edge_cases(random_local_batch(16, 8, 128, 4, 16383, far_frac=0.3))]
    want = PD.poa_local_plain(*t)
    _check_equal("poa_local (K9 through the route) W=16384", names, PD.poa_local(*t), want, errs)
    times, line = _local_timed(t, "K9")
    plain_ms = _cuda_ms(lambda: PD.poa_local_plain(*t), 1)
    bound = _local_bound(t, want[2])
    print(f"[kernels] poa_local W 16,384 (B 8, V 128, P 4): K9 (through poa_local) equal to the "
          f"twin; {line} ms (bound {bound['bound_ms']:.4f}, {bound['bound_by']}; plain "
          f"{plain_ms:.3f})")
    # the largest problem the device route gives them: V 8,192 x W 16,384
    t = [torch.from_numpy(a).to(dev)
         for a in random_local_batch(17, 2, 8192, 4, 16383, far_frac=0.3, min_nv=8000)]
    out = {}
    plain_ms = _cuda_ms(lambda: out.update(want=PD.poa_local_plain(*t)), 1)
    _check_equal("poa_local_cluster (K9) V 8,192 x W 16,384", names,
                 PD.poa_local_cluster(*t)[:4], out["want"], errs)
    times, line = _local_timed(t, "K9", reps=3)
    P = t[1].shape[-1]
    ctas, clusters, smem = PD.poa_local_cluster_occupancy(P, 16384, 8192)
    results["poa_local_cluster_w16384"] = k9 = dict(
        max_abs_err=max(errs), ms=sum(times["wrapper"]) / 2, plain_ms=plain_ms,
        **_local_bound(t, out["want"][2]))
    print(f"[kernels] poa_local V 8,192 x W 16,384 (B 2, P {P}, nv {t[2].tolist()}, max tlen "
          f"{int(out['want'][2].max())}): K9 equal to the twin; {line} ms; bound "
          f"{k9['bound_ms']:.4f} ({k9['bound_by']}), {ctas} CTAs a cluster, {clusters} clusters "
          f"resident, {smem} B shared memory a CTA; plain {plain_ms:.3f} ms")


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


def _no_spawn(*args, **kw):
    raise AssertionError("map -t 0 on one card spawned ranks")


def phase_main_path(work, prefix, gfa, fasta, reads, card, results):
    import torch
    import torch.multiprocessing  # noqa: F401  (the spawn the main leg must not call)

    from vgaligner_tpu_torch import cli
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
    spawn = torch.multiprocessing.spawn
    torch.multiprocessing.spawn = _no_spawn
    try:
        took, launches = _drive("the main path", prefix, fasta, gfa, out,
                                ["-p", "abpoa", "--precision", "auto", "-t", "0"],
                                ("chain_dp", "poa_dp_tb"),
                                ("poa_dp_tb_cluster", "poa_local_cluster"))
    finally:
        PD.poa_dp_tb = real
        torch.multiprocessing.spawn = spawn
    if cli.resolve_ranks(0, "cuda") != 1 or torch.distributed.is_initialized():
        raise AssertionError("-t 0 on the one card did not resolve to one rank")
    if launches["poa_dp_tb"] != MAIN_LAUNCHES:
        raise AssertionError(f"poa_dp_tb launched {launches['poa_dp_tb']} times, "
                             f"not once a stream batch ({MAIN_LAUNCHES})")
    print(f"[main] map -p abpoa -D on {N_READS} reads: {took:.2f} s, {N_READS / took:.1f} "
          f"reads/s streamed map+align ({card}); launches {launches}")
    n_chains, mapped = _check_gaf(out, N_READS, {f"read{i}": READ_LEN for i in range(N_READS)})
    print(f"[main] {n_chains} chain rows, {mapped}/{N_READS} reads aligned")

    stats = [chunk_stats(a[1].cpu().numpy(), a[3].cpu().numpy(), a[3].shape[0])
             for a, _nb in chunks]
    if not all(c["topological"] for c in stats):
        raise AssertionError("a main-path launch has a predecessor at or past its vertex")
    if not all(bool((a[3] > 0).all()) for a, _nb in chunks):
        raise AssertionError("a main-path launch holds a padding problem")
    problems = sum(c["problems"] for c in stats)
    on_backing = sum(int((nb > 0).sum()) for _a, nb in chunks)
    print(f"[main] poa_dp_tb launches: {len(chunks)} of {[a[0].shape[0] for a, _nb in chunks]} "
          f"real problems, {problems} in all, mean nv "
          f"{sum(c['nv_sum'] for c in stats) / problems:.2f}, every predecessor before its "
          f"vertex, far vertices per problem max {max(c['far8_max'] for c in stats)} (ring 8) "
          f"/ {max(c['far16_max'] for c in stats)} (ring 16); {on_backing} problems took the "
          "backing store")
    args = max((a for a, _nb in chunks), key=lambda a: int(a[3].sum()))
    t, init = args[:6], args[6]
    errs = []
    _fused_check(t, init, "poa_dp_tb on the main reads' largest launch", errs)
    entry, line = _fused_timed(t, init, PD.poa_dp_tb)
    one, ladder, n_ladder = _plan_turns(t, init, PD.poa_dp_tb, LADDER_CHUNK["poa_dp_tb"])
    B, V = t[0].shape
    warps, blocks, smem = PD.poa_dp_tb_occupancy(t[1].shape[-1], init.shape[0], V)
    sms = torch.cuda.get_device_properties(t[0].device).multi_processor_count
    results["poa_dp_tb"].update(
        max_abs_err=max(results["poa_dp_tb"]["max_abs_err"], *errs), **entry)
    print(f"[main] largest launch B={B} V={V} W={init.shape[0]} P={t[1].shape[-1]} mean nv "
          f"{float(t[3].float().mean()):.1f}: equal to the plain pair; K6 {line}; {warps} "
          f"problems a block, {blocks} blocks an SM, {smem} B shared memory a block, "
          f"{min(B, warps * blocks * sms)} of {B} problems resident at once "
          f"({min(B, warps * blocks * sms) / sms:.2f} warps an SM); one launch against the "
          f"ladder plan's {n_ladder} launches of at most {LADDER_CHUNK['poa_dp_tb']}, in turns: "
          f"ladder {ladder[0]:.4f}, one {one[0]:.4f}, one {one[1]:.4f}, ladder {ladder[1]:.4f} "
          f"ms ({card})")
    torch.cuda.synchronize()

    n = _cpu_rerun(work, "main", prefix, gfa, reads, out, ["-p", "abpoa", "--precision", "fast"])
    print(f"[main] first {n} reads: chains and alignments GAF byte-identical "
          "to the --device cpu run")
    return launches, out


def phase_sharded(work, prefix, gfa, fasta, main_out, card):
    """The main path's reads over the sharded path, in a world-size-1
    NCCL group on the card: both GAFs byte-identical to the main leg's,
    K1 and K6 launched, the collectives counted."""
    import datetime

    import torch
    import torch.distributed as dist

    from vgaligner_tpu_torch import kernels, parallel
    from vgaligner_tpu_torch.graph import graph_from_gfa
    from vgaligner_tpu_torch.index import Index
    from vgaligner_tpu_torch.io.fastx import read_seqs_from_file
    from vgaligner_tpu_torch.models.mapper import Mapper
    from vgaligner_tpu_torch.models.poa_aligner import PoaAligner, PoaEngine
    from vgaligner_tpu_torch.models.stream import DEFAULT_BATCH, stream_map_align

    index = Index.load_from_prefix(prefix)
    queries = read_seqs_from_file(fasta)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(work, 'rendezvous')}",
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = parallel.make_mesh(1)
        mapper = Mapper(index, mesh=mesh, shard_index=True, precision="fast")
        aligner = PoaAligner(index, mesh=mesh, engine=PoaEngine.ABPOA, export_subgraphs=False,
                             graph=graph_from_gfa(gfa))
        got = {"chains": [], "alignments": []}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        parallel.reset_collective_counts()
        t0 = time.monotonic()
        stream_map_align(mapper, queries, aligner, batch_size=DEFAULT_BATCH,
                         on_chains=lambda b: got["chains"].append(b.blob),
                         on_alignments=lambda b: got["alignments"].append(b.blob), mesh=mesh)
        torch.cuda.synchronize()
        took = time.monotonic() - t0
        launches = kernels.launch_counts()
        colls = parallel.collective_counts()
    finally:
        dist.destroy_process_group()
    for kind in ("chains", "alignments"):
        with open(f"{main_out}-{kind}.gaf", "rb") as fh:
            if b"".join(got[kind]) != fh.read():
                raise AssertionError(f"the sharded path's {kind} GAF differs from the main leg's")
    for name in ("chain_dp", "poa_dp_tb"):
        if launches[name] <= 0:
            raise AssertionError(f"the sharded path never launched {name}: {launches}")
    n_batches = -(-len(queries) // DEFAULT_BATCH)
    maps = launches["chain_dp"]
    want = {"all_reduce": n_batches, "reduce_scatter_tensor": maps,
            "all_gather_into_tensor": maps + 4 * n_batches, "broadcast": 0}
    if colls != want:
        raise AssertionError(f"collectives {colls}, expected {want}")
    nccl = torch.cuda.nccl.version()
    nccl = ".".join(map(str, nccl)) if isinstance(nccl, tuple) else str(nccl)
    print(f"[sharded] stream_map_align, Mapper(mesh, shard_index=True, fast) + abPOA over NCCL "
          f"{nccl} at world size 1 on {len(queries)} "
          f"reads: {took:.2f} s, {len(queries) / took:.1f} reads/s ({card}); chains and "
          f"alignments GAF byte-identical to the main leg; collectives {colls}; launches "
          f"{launches}")


def _local_kernel_only(args, kind):
    """One launch of K7 (``kind`` "warp") or K9 ("cluster") through its C
    entry on buffers allocated once, its backing rows those the host
    counts: the kernel's own time, without the wrapper's allocations."""
    import torch

    from vgaligner_tpu_torch import kernels
    from vgaligner_tpu_torch.ops import poa_device as PD

    vcodes, vpred, nv, q, _nq = args
    B, V = vcodes.shape
    P, L = vpred.shape[-1], q.shape[1]
    W, dev = L + 1, vcodes.device
    outs = [torch.empty(B, dtype=torch.float32, device=dev),
            torch.empty((B, W), dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev)]
    off = torch.from_numpy(PD._back_offsets(vpred, nv, None)).to(dev)
    scratch = [off, torch.empty((max(int(off[-1]), 1), W), dtype=torch.int16, device=dev),
               torch.empty((B, V, W), dtype=torch.uint8, device=dev)]
    nb = torch.empty(B, dtype=torch.int32, device=dev)
    ptrs = [*(a.data_ptr() for a in (vcodes, vpred, nv, q)), B, V, P, L,
            *(x.data_ptr() for x in scratch + outs), nb.data_ptr(), kernels.stream_ptr(dev)]
    name = f"poa_local_{kind}"
    return _c_call(getattr(kernels.lib(), f"vg_{name}"), ptrs, name, scratch, outs, nb)


def _local_timed(args, new="K7", reps=10):
    """K7 or K9 (``new``, with the host's backing-row counts) on the same
    CUDA tensors, after a warm-up, timed twice through its wrapper and
    twice as the kernel alone.  Returns {how: [ms, ms]} and the line that
    reports them."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    back = PD.backing_rows_plain(args[1], args[2], PD.LOCAL_RING, PD.LOCAL_PINS).cpu().numpy()
    kernel = PD.poa_local_warp if new == "K7" else PD.poa_local_cluster
    fns = {"wrapper": lambda: kernel(*args, back),
           "kernel": _local_kernel_only(args, "warp" if new == "K7" else "cluster")}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    out = {how: [_cuda_ms(fn, reps) for _ in range(2)] for how, fn in fns.items()}
    line = (f"{new} through its wrapper {out['wrapper'][0]:.4f}, {out['wrapper'][1]:.4f}; "
            f"kernel alone {out['kernel'][0]:.4f}, {out['kernel'][1]:.4f}")
    return out, line


def phase_rspoa_path(work, prefix, gfa, fasta, reads, card, dev, results):
    from vgaligner_tpu_torch.ops import poa_device as PD

    captured = {}
    real = _keep_largest(PD, "poa_local", lambda a: a[0].shape[0], captured)
    out = os.path.join(work, "rspoa", "smoke")
    try:
        took, launches = _drive("the rspoa path", prefix, fasta, gfa, out,
                                ["-p", "rspoa", "--precision", "exact"],
                                ("chain_dp_exact", "poa_local_warp"),
                                ("chain_dp", "poa_dp_tb", "poa_dp_tb_cluster",
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

    args, _w, kw = captured["poa_local"]
    back = np.asarray(kw["back_rows"])
    want = PD.poa_local_plain(*args)
    got = PD.poa_local_warp(*args, back)
    names = ("best", "tape", "tlen", "qend", "n_backing")
    errs = []
    _check_equal("poa_local_warp on the main reads' batch", names, got,
                 (*want, PD.backing_rows_plain(args[1], args[2], PD.LOCAL_RING, PD.LOCAL_PINS)),
                 errs)  # n_backing: the kernel's count, equal to the host's back
    if got[4].cpu().numpy().tolist() != back.tolist():
        raise AssertionError("poa_local_warp on the main reads' batch: the route's back_rows "
                             "differ from the kernel's count")
    times, line = _local_timed(args)
    plain_ms = _cuda_ms(lambda: PD.poa_local_plain(*args), 1)
    B, V = args[0].shape
    W, P = args[3].shape[1] + 1, args[1].shape[-1]
    bound = _local_bound(args, want[2])
    print(f"[rspoa] local POA on the main reads' largest batch B={B} V={V} W={W} P={P}, mean "
          f"nv {float(args[2].float().mean()):.2f}: K7 equal to the twin, "
          f"{int((got[4] > 0).sum())} problems on K7's backing store; {line} ms; "
          f"plain {plain_ms:.3f} ms; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}) "
          f"({card})")
    results["poa_local_warp"].update(
        max_abs_err=max(results["poa_local_warp"]["max_abs_err"], *errs),
        ms=sum(times["wrapper"]) / 2, plain_ms=plain_ms, **bound)
    _local_warp_memory(args, back, card)
    return launches


def _local_warp_memory(args, back, card):
    """The main rspoa launch's backing rows, its device bytes by
    ``local_problem_bytes``, and K7's peak device memory on it (above what
    was allocated before the call), held under the route's byte budget."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    B, V = args[0].shape
    W, P = args[3].shape[1] + 1, args[1].shape[-1]
    planned = int(PD.local_problem_bytes(V, W, P, back).sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = PD.poa_local_warp(*args, back)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    if peak >= PD._LOCAL_BUDGET or planned >= PD._LOCAL_BUDGET:
        raise AssertionError(f"K7 on the main rspoa launch: {peak} bytes at its peak, "
                             f"{planned} planned, against a budget of {PD._LOCAL_BUDGET}")
    print(f"[rspoa] the main launch B={B} V={V} W={W} P={P}: {int(back.sum())} backing rows in "
          f"{int((back > 0).sum())} problems ({2 * W * int(back.sum())} B; a whole int16 plane "
          f"would be {2 * B * V * W} B); local_problem_bytes {planned} B; K7's peak device "
          f"memory {peak} B above the {before} allocated before it, under the budget of "
          f"{PD._LOCAL_BUDGET} ({card})")


def _keep_largest(module, name, work, captured):
    """Wrap ``module.name`` so that ``captured[name]`` keeps the arguments
    of its call with the most ``work(args)`` (args, work, keyword
    arguments); returns the real function."""
    real = getattr(module, name)

    def keep(*args, **kw):
        w = work(args)
        if name not in captured or w > captured[name][1]:
            captured[name] = (args, w, kw)
        return real(*args, **kw)

    setattr(module, name, keep)
    return real


def _long_chain_launch(label, args, exact, card):
    """The chaining kernel (K5 with ``exact``, else K1) on the launch the
    long-read run gave it: held against its plain twin and timed through
    its wrapper (K5: and its residency there); the rows each read has to
    its last valid anchor."""
    import torch

    from vgaligner_tpu_torch.ops import chain as C

    fn, plain = (C.chain_dp_exact, C.chain_dp_exact_plain) if exact else (C.chain_dp,
                                                                          C.chain_dp_plain)
    errs = []
    _check_equal(f"{label} on the long reads' launch", ("f", "pred", "curr_max"), fn(*args),
                 plain(*args), errs)
    if exact:
        _k5_residency("the long launch", args[0].shape[0], args[0].device)
    ms = _cuda_ms(lambda: fn(*args), 10)
    bound = _chain_bound(args[:4], exact)
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
                                ("poa_dp_tb", "poa_local_cluster"))
    finally:
        PD.poa_dp_tb_cluster = real
        C.chain_dp = real_k1
    if launches["poa_dp_tb_cluster"] != LONG_LAUNCHES:
        raise AssertionError(f"the long-read path launched poa_dp_tb_cluster "
                             f"{launches['poa_dp_tb_cluster']} times, not once a bucket "
                             f"({LONG_LAUNCHES})")
    if not all(bool((a[3] > 0).all()) for a in chunks):
        raise AssertionError("a long-read K8 launch holds a padding problem")
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
    errs = []
    for i, args in enumerate(chunks):
        _fused_check(args[:6], args[6], f"poa_dp_tb_cluster on the long reads' launch {i}", errs,
                     PD.poa_dp_tb_cluster)
    k8 = results["poa_dp_tb_cluster"]
    k8["max_abs_err"] = max(k8["max_abs_err"], *errs)
    print(f"[long] K8 equal to the plain pair on each of the {len(chunks)} launches (B, V, W, "
          "device bytes): " + ", ".join(
              str((a[0].shape[0], a[0].shape[1], a[6].shape[0], int(PD.global_problem_bytes(
                  a[0].shape[1], a[6].shape[0], a[1].shape[-1], a[7]).sum())))
              for a in chunks))
    _long_chunk_kernels(max(chunks, key=lambda a: int(a[3].sum()) * a[4].shape[1]), card,
                        results)
    return launches, _long_rspoa(work, prefix, gfa, fasta, reads, card, results)


def _long_rspoa(work, prefix, gfa, fasta, reads, card, results):
    """The rspoa route over the long reads, whose local POA rows are of
    512-8,192 columns: K9 and K5 launched, K7, K1, K6 and K8 not; both GAFs
    byte-identical to the CPU plain path; each launch's shape and bytes
    under the route's budget, and K9 held against its twin on each; K5
    held and timed on its launch; K9 timed beside the twin on the largest
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
                                ("poa_local_warp", "chain_dp", "poa_dp_tb",
                                 "poa_dp_tb_cluster"))
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
    leg; on the largest, K9 timed beside the twin and its bound from
    that batch."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    names = ("best", "tape", "tlen", "qend", "n_backing")
    errs, on_backing = [], 0
    for i, args in enumerate(batches):
        back = PD.backing_rows_plain(args[1], args[2], PD.LOCAL_RING, PD.LOCAL_PINS)
        _check_equal(f"poa_local_cluster (K9) on the long reads' batch {i}", names,
                     PD.poa_local_cluster(*args), (*PD.poa_local_plain(*args), back), errs)
        on_backing += int((back > 0).sum())
    args = max(batches, key=lambda a: int(a[2].sum()) * a[3].shape[1])
    times, line = _local_timed(args, "K9")
    out = {}
    plain_ms = _cuda_ms(lambda: out.update(want=PD.poa_local_plain(*args)), 1)
    bound = _local_bound(args, out["want"][2])
    results["poa_local_cluster"].update(
        max_abs_err=max(results["poa_local_cluster"]["max_abs_err"], *errs),
        ms=sum(times["wrapper"]) / 2, plain_ms=plain_ms, **bound)
    B, V = args[0].shape
    W, P = args[3].shape[1] + 1, args[1].shape[-1]
    ctas, clusters, smem = PD.poa_local_cluster_occupancy(P, W, V)
    torch.cuda.synchronize()
    print(f"[long] K9 equal to the twin on each of the {len(batches)} rspoa batches "
          f"({on_backing} problems on its backing store); largest B={B} V={V} W={W} P={P} mean nv "
          f"{float(args[2].float().mean()):.1f} (max {int(args[2].max())}): {line} ms; K9 "
          f"{ctas} CTAs a cluster, {clusters} clusters resident, {smem} B shared memory a CTA; "
          f"bound {bound['bound_ms']:.4f} ({bound['bound_by']}); plain {plain_ms:.3f} ms ({card})")


def _long_chunk_kernels(args, card, results):
    """K8 on the long-read path's largest launch: held against the plain
    pair (score, best_sink, tbits below nv; tape and tlen), timed beside
    it and against the ladder plan (``_plan_turns``), and bounded from
    that launch."""
    from vgaligner_tpu_torch.ops import poa_device as PD

    t, init = args[:6], args[6]
    errs = []
    nb = _fused_check(t, init, "poa_dp_tb_cluster on the long reads' largest launch", errs,
                      PD.poa_dp_tb_cluster)
    entry, line = _fused_timed(t, init, PD.poa_dp_tb_cluster)
    one, ladder, n_ladder = _plan_turns(t, init, PD.poa_dp_tb_cluster,
                                        LADDER_CHUNK["poa_dp_tb_cluster"])
    B, V = t[0].shape
    W, P = init.shape[0], t[1].shape[-1]
    results["poa_dp_tb_cluster"].update(
        max_abs_err=max(results["poa_dp_tb_cluster"]["max_abs_err"], *errs), **entry)
    ctas, clusters, smem = PD.poa_dp_tb_cluster_occupancy(P, W, V)
    print(f"[long] largest launch B={B} V={V} W={W} P={P} mean nv {float(t[3].float().mean()):.1f} "
          f"(max {int(t[3].max())}), {int((nb > 0).sum())} problems on K8's backing store: K8 "
          f"equal to the plain pair; K8 {line}; {ctas} CTAs a cluster, {B * ctas} CTAs, "
          f"{clusters} clusters resident, {smem} B shared memory a CTA; K8 in one launch "
          f"against the ladder plan's {n_ladder} launches of at most "
          f"{LADDER_CHUNK['poa_dp_tb_cluster']}, in turns: ladder {ladder[0]:.4f}, one "
          f"{one[0]:.4f}, one {one[1]:.4f}, ladder {ladder[1]:.4f} ms ({card})")


def phase_wide_route(work, prefix, gfa, graph, dev, card):
    """Rows of 16,384 columns through the entry points a user calls:
    ``align_global_batch`` and ``align_local_batch`` on the card over
    ``testing.wide_route_problems`` (subgraphs of 1,096-7,909 base
    vertices, queries of 8.3-14 kb), each with the launch counters reset
    just before it and read just after: K8 and K9 launched, at W 16,384
    only, K6 and K7 not; every result equal to the host
    oracle (``poa_global_host_native``, ``align_local_no_gap_host``), and
    the smallest problem's to the ``device="cpu"`` route, and at most 3
    launches of each kernel (one a (V, W) bucket); the largest problem
    alone, its peak device memory under the route's byte budget
    (``_lone_wide_problem``).  Then
    ``testing.wide_reads`` (8.4 kb: a 3 kb path window and an inserted
    stretch) through the CLI, abPOA and rspoa + exact, with where each
    read's POA ran: one read's corridor subgraph lands under the
    8,192-vertex cap (K8 and K9 at W 16,384), the other over it (the host
    POA).  The rspoa run's GAFs are held to the CPU run's; the abPOA
    run's K8 launch is held to the plain pair on the card (a CPU run of
    that launch, V 8,192 x W 16,384 on the host, is not made).  Returns
    the launches of the two library calls."""
    import torch

    from vgaligner_tpu_torch import kernels
    from vgaligner_tpu_torch.models import poa_aligner as PA
    from vgaligner_tpu_torch.native import poa_global_host_native
    from vgaligner_tpu_torch.ops import poa as OP
    from vgaligner_tpu_torch.ops import poa_device as PD
    from vgaligner_tpu_torch.testing import wide_reads, wide_route_problems, write_fasta

    t0 = time.monotonic()
    problems = wide_route_problems(graph)
    shapes = [(sum(len(x) for x in n), len(q)) for n, _e, q in problems]
    seen = []
    real = PD.poa_dp_tb_cluster, PD.poa_local_cluster, PA.poa_global_host_native, \
        OP.align_local_no_gap_host

    k8_args = []

    def k8(*a):
        seen.append(("K8", a[0].shape[1], a[4].shape[1] + 1))
        k8_args.append(a)
        return real[0](*a)

    def k9(*a, **kw):
        seen.append(("K9", a[0].shape[1], a[3].shape[1] + 1))
        return real[1](*a, **kw)

    def host_global(*a):
        seen.append(("host", sum(len(x) for x in a[0]), len(a[2]) + 1))
        return real[2](*a)

    def host_local(*a):
        seen.append(("host", sum(len(x) for x in a[0]), len(a[2]) + 1))
        return real[3](*a)

    legs = {}
    others = ("poa_dp_tb", "poa_local_warp")
    PD.poa_dp_tb_cluster, PD.poa_local_cluster = k8, k9
    try:
        for name, fn, want in (("align_global_batch", PD.align_global_batch,
                                "poa_dp_tb_cluster"),
                               ("align_local_batch", PD.align_local_batch, "poa_local_cluster")):
            del seen[:]
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t1 = time.monotonic()
            got = fn(problems, dev)
            torch.cuda.synchronize()
            took = time.monotonic() - t1
            launches = kernels.launch_counts()
            if launches[want] <= 0 or any(launches[k] for k in others):
                raise AssertionError(f"[wide route] {name}: launches {launches}")
            if not seen or any(w != 16384 for _k, _v, w in seen):
                raise AssertionError(f"[wide route] {name}: launches at {seen}, not W 16,384")
            if launches[want] > 3:
                raise AssertionError(f"[wide route] {name}: {launches[want]} launches of {want} "
                                     "for three (V, W) buckets")
            legs[name] = (got, took, launches, list(seen))
    finally:
        PD.poa_dp_tb_cluster, PD.poa_local_cluster = real[:2]
    t1 = time.monotonic()
    for i, p in enumerate(problems):
        if legs["align_global_batch"][0][i] != poa_global_host_native(*p):
            raise AssertionError(f"[wide route] align_global_batch problem {i} differs from "
                                 "poa_global_host_native")
        if legs["align_local_batch"][0][i] != OP.align_local_no_gap_host(*p):
            raise AssertionError(f"[wide route] align_local_batch problem {i} differs from "
                                 "align_local_no_gap_host")
    oracle_s = time.monotonic() - t1
    small = min(range(len(problems)), key=lambda i: shapes[i][0])
    t1 = time.monotonic()
    if (PD.align_global_batch([problems[small]], "cpu")[0] != legs["align_global_batch"][0][small]
            or PD.align_local_batch([problems[small]], torch.device("cpu"))[0]
            != legs["align_local_batch"][0][small]):
        raise AssertionError(f"[wide route] problem {small} differs between the card and the "
                             "CPU route")
    cpu_s = time.monotonic() - t1
    for name, (got, took, launches, calls) in legs.items():
        print(f"[wide route] {name} on the card over {len(problems)} problems (base vertices, "
              f"query bp) {shapes}: {took:.2f} s ({card}); launches (kernel, V, W) {calls}; "
              f"counters {launches}; scores {[r.best_score for r in got]}")
    print(f"[wide route] every result equal to the host oracle ({oracle_s:.2f} s) and problem "
          f"{small} to the CPU route ({cpu_s:.2f} s)")
    _lone_wide_problem(problems, shapes, legs["align_global_batch"][0], dev, card)

    reads = wide_reads(graph)
    fasta = os.path.join(work, "wide.fa")
    write_fasta(fasta, reads)
    lens = {f"read{i}": len(r) for i, r in enumerate(reads)}
    for engine, argv, must in (("abpoa", ["-p", "abpoa", "--precision", "fast"],
                                "poa_dp_tb_cluster"),
                               ("rspoa", ["-p", "rspoa", "--precision", "exact"],
                                "poa_local_cluster")):
        out = os.path.join(work, f"wide-{engine}", "smoke")
        del seen[:], k8_args[:]
        PD.poa_dp_tb_cluster, PD.poa_local_cluster = k8, k9
        PA.poa_global_host_native, OP.align_local_no_gap_host = host_global, host_local
        try:
            took, launches = _drive(f"the wide reads' {engine} path", prefix, fasta, gfa, out,
                                    argv, (must,), others)
        finally:
            PD.poa_dp_tb_cluster, PD.poa_local_cluster = real[:2]
            PA.poa_global_host_native, OP.align_local_no_gap_host = real[2:]
        if not any(k != "host" and w == 16384 for k, _v, w in seen):
            raise AssertionError(f"[wide route] the {engine} CLI launched no cluster kernel at "
                                 f"W 16,384: {seen}")
        calls = list(seen)
        _check_gaf(out, len(reads), lens)
        t1 = time.monotonic()
        if engine == "abpoa":
            errs = []
            for a in k8_args:
                _fused_check(a[:6], a[6], "poa_dp_tb_cluster on the wide reads' launch", errs,
                             PD.poa_dp_tb_cluster)
            held = "K8 equal to the plain pair on the card on its launch"
        else:
            n = _cpu_rerun(work, f"wide-{engine}", prefix, gfa, reads, out, argv, len(reads))
            held = f"chains and alignments GAF of all {n} reads byte-identical to the CPU run"
        print(f"[wide route] map -p {engine} -D on {len(reads)} reads of "
              f"{sorted(set(lens.values()))} bp: card {took:.2f} s ({card}); POA calls (kernel or "
              f"host, V, W) {calls}; {held} ({time.monotonic() - t1:.2f} s); launches "
              f"{launches}")
    print(f"[wide route] done in {time.monotonic() - t0:.2f} s ({card})")
    return legs["align_global_batch"][2], legs["align_local_batch"][2]


def _lone_wide_problem(problems, shapes, want, dev, card):
    """The largest of the wide problems (V 8,192 x W 16,384) alone through
    ``align_global_batch`` on the card: one K8 launch, the result of the
    batched call, and the call's peak device memory above what was
    allocated before it (``reset_peak_memory_stats``,
    ``max_memory_allocated``) under the route's byte budget."""
    import torch

    from vgaligner_tpu_torch import kernels
    from vgaligner_tpu_torch.ops import poa_device as PD

    big = max(range(len(problems)), key=lambda i: shapes[i][0])
    V, L = PD._next_pow2(max(shapes[big][0], 256)), PD._l_pad_for(shapes[big][1])
    if (V, PD.global_route(L + 1)[1]) != (8192, 16384):
        raise AssertionError(f"[wide route] the largest problem is at V {V} x L {L}")
    captured = []
    real = PD.poa_dp_tb_cluster

    def keep(*args):
        captured.append((args[1].shape[-1], int(args[7][0])))
        return real(*args)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    PD.poa_dp_tb_cluster = keep
    try:
        got = PD.align_global_batch([problems[big]], dev)[0]
        torch.cuda.synchronize()
    finally:
        PD.poa_dp_tb_cluster = real
    peak = torch.cuda.max_memory_allocated()
    launches = kernels.launch_counts()
    if launches["poa_dp_tb_cluster"] != 1 or got != want[big]:
        raise AssertionError(f"[wide route] the lone problem: launches {launches}, result equal "
                             f"to the batched call's: {got == want[big]}")
    P, back = captured[0]
    planned = int(PD.global_problem_bytes(V, L + 1, P, [back])[0])
    if peak - before >= PD._HBM_BUDGET:
        raise AssertionError(f"[wide route] the lone V 8,192 x W 16,384 problem took "
                             f"{peak - before} bytes of device memory, over {PD._HBM_BUDGET}")
    print(f"[wide route] lone problem {big} ({shapes[big][0]} base vertices, {shapes[big][1]} bp: "
          f"V {V} x W 16,384) through align_global_batch: one K8 launch, equal to the batched "
          f"call; {back} backing rows; peak device memory {peak - before} bytes above the "
          f"{before} allocated before it ({peak} in all), under the budget of {PD._HBM_BUDGET} "
          f"(the route's plan at P {P}: {planned}) ({card})")


def _route_problems(index, aligner, chains):
    """The Python route's ranges and problems of ``chains``, held equal
    to the native extractor's (``_extract``): handles, trimmed labels,
    edges and trim starts.  Returns (ranges, problems, the Python
    route's seconds)."""
    from vgaligner_tpu_torch.models.poa_aligner import find_nodes_edges

    t0 = time.monotonic()
    ranges = [aligner._range_for_chain(c) for c in chains]
    subgraphs = [find_nodes_edges(index, r) for r in ranges]
    took = time.monotonic() - t0
    sub = aligner._extract(chains)
    for i, (rng, (nodes, edges)) in enumerate(zip(ranges, subgraphs)):
        trims = rng.label_trims or {}
        lbase = sub.lbase[sub.handle_off[i] : sub.handle_off[i + 1]].tolist()
        if (sub.handles(i) != rng.handles or sub.nodes(i) != nodes or sub.edges(i) != edges
                or lbase != [trims.get(h, (0, 0))[0] for h in rng.handles]):
            raise AssertionError(f"{aligner.range_mode} mode: the Python route's subgraph of "
                                 f"chain {i} ({chains[i].query.name}) differs from the native "
                                 "extractor's")
    return ranges, [(n, e, c.query.seq) for (n, e), c in zip(subgraphs, chains)], took


def _route_leg(label, index, aligner, queries, dev, must, must_not, cpu_sample, card):
    """Map ``queries`` on the card, build every selected chain's problem
    by the Python route (held to the native extractor), run
    ``align_global_batch`` on the card with the launch counters reset
    just before it and read just after, and hold each result and its GAF
    row to the native CLI route's (``_finish_chains(_dispatch_chains())``)
    and a seeded sample of ``cpu_sample`` problems to the CPU run.
    Returns (launches, problems, each read's chains, the base vertices of
    each problem the host POA took, the (V, L) buckets of the rest)."""
    import dataclasses

    import torch

    from vgaligner_tpu_torch import kernels, native
    from vgaligner_tpu_torch.io.gaf import GAFAlignment
    from vgaligner_tpu_torch.models.mapper import Mapper
    from vgaligner_tpu_torch.models.poa_aligner import _rebase_trimmed_offsets
    from vgaligner_tpu_torch.ops import poa_device as PD

    mapper = Mapper(index, precision="fast")  # no device: the card by default
    if mapper.device != dev or aligner.device != dev:
        raise AssertionError(f"Mapper/PoaAligner without a device run on {mapper.device}/"
                             f"{aligner.device}, not {dev}")
    per_read = mapper.map_reads(queries)
    chains = [c for cs in per_read for c in aligner._chains_for_alignment(cs, 1)
              if not c.is_placeholder]
    ranges, problems, route_s = _route_problems(index, aligner, chains)
    host_calls = []
    real_host = native.poa_global_host_native

    def host_poa(*args):
        host_calls.append(sum(len(x) for x in args[0]))
        return real_host(*args)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    native.poa_global_host_native = host_poa
    t0 = time.monotonic()
    try:
        got = PD.align_global_batch(problems, dev)
        torch.cuda.synchronize()
    finally:
        native.poa_global_host_native = real_host
    took = time.monotonic() - t0
    launches = kernels.launch_counts()
    for name in must:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: align_global_batch never launched {name}: {launches}")
    for name in must_not:
        if launches[name] != 0:
            raise AssertionError(f"{label}: align_global_batch launched {name}: {launches}")
    pick = np.random.default_rng(5).choice(len(problems), min(cpu_sample, len(problems)),
                                           replace=False)
    pick = sorted(int(i) for i in pick)
    t1 = time.monotonic()
    cpu = PD.align_global_batch([problems[i] for i in pick], "cpu")
    cpu_s = time.monotonic() - t1
    for i, res in zip(pick, cpu):
        if res != got[i]:
            raise AssertionError(f"{label}: align_global_batch of problem {i} differs between "
                                 "the card and the CPU")
    want = aligner._finish_chains(aligner._dispatch_chains(chains))
    for i, (res, rng, chain, (w, handles)) in enumerate(zip(got, ranges, chains, want)):
        res = dataclasses.replace(res)
        _rebase_trimmed_offsets(res, rng)
        if res != w:
            raise AssertionError(f"{label}: align_global_batch of chain {i} differs from the "
                                 "native route's PoaResult")
        if (GAFAlignment.from_abpoa_result(res, chain, rng.handles).to_string()
                != GAFAlignment.from_abpoa_result(w, chain, handles).to_string()):
            raise AssertionError(f"{label}: the GAF row of chain {i} differs from the native "
                                 "route's")
    print(f"[python route] {label}: {len(chains)} chains; the Python route's subgraphs equal "
          f"to the native extractor's ({route_s:.2f} s on the host, "
          f"{route_s / max(len(chains), 1) * 1e3:.3f} ms a chain); align_global_batch on the "
          f"card {took:.2f} s, {len(problems) / took:.1f} problems/s ({card}), every PoaResult "
          f"and GAF row equal to the native route's; {len(host_calls)} on the host POA "
          f"(base vertices {host_calls}); {len(pick)} problems again on the CPU ({cpu_s:.2f} s), "
          f"equal; launches {launches}")
    buckets = {(PD._next_pow2(max(v, 256)), PD._l_pad_for(len(q))) for v, q in (
        (sum(len(x) for x in n), q) for n, _e, q in problems) if v <= 8192}
    return launches, len(problems), per_read, host_calls, len(buckets)


def phase_python_route(index, graph, reads, dev, card):
    """The Python subgraph route and ``align_global_batch`` on the smoke's
    graph: the 12,288 reads (K6 once a (V, L) bucket, K8 not; id mode
    with bubble closure on a seeded 1,024-read sample), then the long
    reads (K8; the 10 kb read's subgraph on the native host POA)."""
    from vgaligner_tpu_torch.io.fastx import QuerySequence
    from vgaligner_tpu_torch.models.poa_aligner import PoaAligner
    from vgaligner_tpu_torch.testing import long_reads

    t0 = time.monotonic()
    aligner = PoaAligner(index)  # abPOA, corridor, and the card by default
    queries = [QuerySequence.from_name_and_string(f"read{i}", r) for i, r in enumerate(reads)]
    launches, n_problems, per_read, _host, buckets = _route_leg(
        "100 bp reads", index, aligner, queries, dev, ("poa_dp_tb",),
        ("poa_dp_tb_cluster",), CPU_SAMPLE, card)
    if launches["poa_dp_tb"] != buckets:
        raise AssertionError(f"align_global_batch launched poa_dp_tb {launches['poa_dp_tb']} "
                             f"times for {n_problems} problems, not once a bucket ({buckets})")
    print(f"[python route] poa_dp_tb launched {buckets} times for {n_problems} problems, once a "
          f"(V, L) bucket (the main leg: {MAIN_LAUNCHES}, one a stream batch)")
    by_id = PoaAligner(index, range_mode="id", bubble_closure=True)
    pick = np.random.default_rng(11).choice(len(queries), min(1024, len(queries)), replace=False)
    id_chains = [c for i in sorted(int(x) for x in pick)
                 for c in by_id._chains_for_alignment(per_read[i], 1) if not c.is_placeholder]
    _r, _p, id_s = _route_problems(index, by_id, id_chains)
    print(f"[python route] id mode with bubble closure, {len(id_chains)} chains of a seeded "
          f"1,024-read sample: the Python route's subgraphs equal to the native extractor's "
          f"({id_s:.2f} s on the host)")
    long_q = [QuerySequence.from_name_and_string(f"read{i}", r)
              for i, r in enumerate(long_reads(graph, N_LONG))]
    launches_long, _n, _per_read, host, buckets = _route_leg(
        "long reads", index, aligner, long_q, dev, ("poa_dp_tb_cluster",),
        (), 8, card)
    if not any(v > 8192 for v in host):
        raise AssertionError("the 10 kb read's subgraph did not take the native host POA")
    if launches_long["poa_dp_tb"] + launches_long["poa_dp_tb_cluster"] != buckets:
        raise AssertionError(f"align_global_batch on the long reads launched {launches_long}, "
                             f"not once a bucket ({buckets})")
    print(f"[python route] done in {time.monotonic() - t0:.2f} s ({card})")
    return launches, launches_long


def phase_suite(work, card):
    """``run_suite.run_dataset`` on two synthetic datasets (seeds 0 and 1)
    on the card, then on the CPU: every report field but the timings
    equal, K1 and K6 launched on the card."""
    import torch

    from vgaligner_tpu_torch import kernels
    from vgaligner_tpu_torch.experiments.run_suite import run_dataset
    from vgaligner_tpu_torch.testing import write_synthetic_gfa

    timings = ("index_build_s", "map_s", "align_s", "map_align_rps")
    all_launches = []
    for seed in (0, 1):
        name = f"synthetic-{seed}"
        os.makedirs(os.path.join(work, "datasets", name))
        gfa = os.path.join(work, "datasets", name, "graph.gfa")
        write_synthetic_gfa(gfa, seed=seed)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        on_card = run_dataset(gfa, name, 512, READ_LEN, K, "fast", "abpoa", device="cuda")
        torch.cuda.synchronize()
        card_s = time.monotonic() - t0
        launches = kernels.launch_counts()
        for want in ("chain_dp", "poa_dp_tb"):
            if launches[want] <= 0:
                raise AssertionError(f"[suite] {name} never launched {want}: {launches}")
        if launches["chain_dp_exact"] != 0:
            raise AssertionError(f"[suite] {name} launched chain_dp_exact: {launches}")
        on_cpu = run_dataset(gfa, name, 512, READ_LEN, K, "fast", "abpoa", device="cpu")
        a = {k: v for k, v in vars(on_card).items() if k not in timings}
        b = {k: v for k, v in vars(on_cpu).items() if k not in timings}
        if a != b:
            raise AssertionError(f"[suite] {name}: the card's report {a} differs from the "
                                 f"CPU's {b}")
        all_launches.append(launches)
        print(f"[suite] {name} ({on_card.n_nodes} nodes, {on_card.n_kmers} k-mers), 512 reads "
              f"of {READ_LEN} bp, abPOA, fast: reads_found {on_card.reads_found}, avg_jaccard "
              f"{on_card.avg_jaccard}, exact_rate {on_card.exact_rate}, equal to the CPU run; "
              f"card map {on_card.map_s} s + align {on_card.align_s} s, map_align_rps "
              f"{on_card.map_align_rps} ({card}; the CPU {on_cpu.map_align_rps}); the card "
              f"run {card_s:.2f} s with its warm-up; launches {launches}")
    return all_launches


def kernel_line(results, launches, launches_rspoa, launches_long, launches_long_rspoa,
                launches_wide, launches_wide_local):
    """The per-kernel result line: each kernel (K8 and K9 once more at W
    16,384, with the launches of the 16,384-column route leg) with the
    launches of the path that runs it and its measured and bound times."""
    dp_replaces = "vgaligner_tpu/ops/poa_pallas2.py:434, vgaligner_tpu/ops/poa_pallas.py:258"
    tb_replaces = "vgaligner_tpu/ops/poa_device.py:325"
    local_replaces = "vgaligner_tpu/ops/poa_device.py:1075"
    wide = "(rows of 16,384 columns, and widths off the power-of-two ladder padded to the next)"
    sources = {
        "chain_dp": ("chain_dp.cu", "vgaligner_tpu/ops/chain_pallas.py:187", launches),
        "poa_dp_tb": ("poa_dp_tb.cu", f"{dp_replaces}, {tb_replaces} (rows up to 256 "
                      "columns)", launches),
        "poa_dp_tb_cluster": ("poa_dp_tb_cluster.cu", f"{dp_replaces}, {tb_replaces} (rows of "
                              "512-8,192 columns)", launches_long),
        "poa_dp_tb_cluster_w16384": ("poa_dp_tb_cluster.cu", f"{dp_replaces}, {tb_replaces} "
                                     f"{wide}", launches_wide, "poa_dp_tb_cluster"),
        "poa_local_warp": ("poa_local_warp.cu", f"{local_replaces} (rows up to 256 columns)",
                           launches_rspoa),
        "poa_local_cluster": ("poa_local_cluster.cu", f"{local_replaces} (rows of 512-8,192 "
                              "columns)", launches_long_rspoa),
        "poa_local_cluster_w16384": ("poa_local_cluster.cu", f"{local_replaces} {wide}",
                                     launches_wide_local, "poa_local_cluster"),
        "chain_dp_exact": ("chain_dp_exact.cu", "vgaligner_tpu/ops/chain.py:102-177",
                           launches_rspoa),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"kernels": [
        dict(name=name, route="cuda", source=f"vgaligner_tpu_torch/kernels/csrc/{src[0]}",
             replaces=src[1], launches=src[2][src[3] if len(src) > 3 else name],
             **{k: results[name][k] for k in keys})
        for name, src in sources.items()
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
        timed("K6", phase_fused_kernel, dev, results)
        timed("K8", phase_cluster_kernel, dev, results)
        timed("K7", phase_local_warp_kernel, dev, results)
        timed("K9", phase_local_cluster_kernel, dev, results)
        launches, main_out = timed("abPOA CLI", phase_main_path, work, prefix, gfa, fasta,
                                   reads, card, results)
        timed("sharded", phase_sharded, work, prefix, gfa, fasta, main_out, card)
        launches_rspoa = timed("rspoa CLI", phase_rspoa_path, work, prefix, gfa, fasta, reads,
                               card, dev, results)
        launches_long, launches_long_rspoa = timed("long-read CLI", phase_long_reads, work,
                                                   prefix, gfa, graph, card, results)
        timed("python route", phase_python_route, index, graph, reads, dev, card)
        launches_wide, launches_wide_local = timed("wide route", phase_wide_route, work, prefix,
                                                   gfa, graph, dev, card)
        timed("suite", phase_suite, work, card)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)

    line = kernel_line(results, launches, launches_rspoa, launches_long, launches_long_rspoa,
                       launches_wide, launches_wide_local)
    print(f"[done] smoke took {time.monotonic() - t_start:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
