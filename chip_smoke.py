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
       128/256, V in 256/2048), at W 2,048/4,096/8,192 (V 256/2048), and
       at the main path's chunk shape (1,024 x 256 x 128);
       K6, the POA DP and traceback in one kernel for rows up to 256
       columns, on batches with far predecessors and more far-referenced
       vertices than it pins (its backing store), P 2/4/8 x W 32/128/256,
       and at the main path's chunk shape, then timed against K2 + K3 on
       the same CUDA tensors in turns (K2 + K3, K6, K6, K2 + K3); the
       lane-padded contract of the JAX package's VMEM-resident Pallas DP
       (poa_global_kernel, 1,024 x 256, L 100), which K6 now runs;
       K4 local POA on random batches (P 2/4/8, W 128/256/2048, V
       256/2048, problems with no positive cell and nv < V);
       K5 exact chaining DP on the real anchors at 4,096 x 256 and at
       A = 16,384 and 65,536, beside K1's time at the same shape;
  4. the main path through the CLI entry points: ``index -k 11`` and
     ``map -p abpoa -D -G --precision auto`` over 12,288 100 bp reads of
     a seeded HLA-scale synthetic graph (4,760 nodes, 12 haplotypes):
     K1 and K6 launched (K6 12 times), K2 and K3 not; the chunks' mean
     nv and how many problems took K6's backing store; K6 held against
     K2 + K3 and timed on the largest of those chunks; the first 256
     reads again with ``--device cpu --precision fast`` (the plain
     twins), and both GAFs byte-identical for those reads;
  5. the rspoa path: ``map -p rspoa -D -G --precision exact`` over the
     same reads: K4 and K5 launched, K1 not, no subgraph GFA written,
     95 % of reads aligned, and the first 256 reads byte-identical to
     ``--device cpu --precision exact``; K4 is then timed against its
     twin on the largest batch that run gave it;
  6. long reads: ``map -p abpoa -D -G --precision fast`` over 64 reads
     of 1,500-2,100 bp and one 10 kb read (POA rows of W 2,048/4,096 on
     K2 and K3, not K6, and a subgraph over 8,192 vertices on the native
     host POA), card and ``--device cpu`` byte-identical.
Every CLI phase resets the launch counters just before its run and
reads them just after; a kernel's ``launches`` are those of the path
that runs it (K1 and K6: abPOA; K4 and K5: rspoa; K2 and K3: long
reads).

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
    "local_cell": 10,  # K4, a cell: substitution, floor, cell byte, best
    "local_cell_slot": 3,  # K4, a cell and slot: max, compare, select
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
    is_sink, nv, q, nq): inputs once, score/best_sink, and tbits over the
    rows below each problem's nv, which is all the DP computes."""
    vcodes, vpred, _sink, nv, q, _nq = t
    B, V, P = vpred.shape
    W = q.shape[1] + 1
    cells = int(nv.sum()) * W
    nbytes = B * V * (2 + 4 * P) + B * (W - 1) + 8 * B + 4 * W + 8 * B + 4 * cells
    return nbytes, cells * (_OPS["poa_cell"] + P * _OPS["poa_cell_slot"])


def _walk_work(tlen, B, V, W, reads_bits=True):
    """Bytes and operations of the walks: the decision word and the
    predecessor id of every step taken (when they are inputs), and the
    whole tape and tlen written."""
    steps = int(tlen.sum())
    nbytes = B * (V + W + 1) * 4 + 4 * B + (8 * steps + 8 * B if reads_bits else 0)
    return nbytes, steps * _OPS["tb_step"]


def _local_work(args):
    """Bytes and operations of the local POA: inputs once, the decision
    byte of every cell below nv, the tape and the scalars."""
    vcodes, vpred, nv, q, _nq = args
    B, V, P = vpred.shape
    W = q.shape[1] + 1
    cells = int(nv.sum()) * W
    nbytes = B * V * (1 + 4 * P) + B * (W - 1) + 8 * B + cells + 4 * B * W + 12 * B
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
    fa = _fast_args(main)
    ms = _cuda_ms(lambda: C.chain_dp(*fa, K, 50, 1000), 10)
    plain_ms = _cuda_ms(lambda: C.chain_dp_plain(*fa, K, 50, 1000), 1)
    ms_x = _cuda_ms(lambda: C.chain_dp_exact(*main, K, 50, table), 10)
    plain_x = _cuda_ms(lambda: C.chain_dp_exact_plain(*main, K, 50, table), 1)
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


def _fused_check(t, init, label, errs):
    """K6 against poa_dp_plain + poa_traceback_plain on the same CUDA
    tensors: score, best_sink, tape, tlen and tbits below nv bit for bit,
    and n_backing equal to backing_rows_plain.  Returns n_backing."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    score, sink, tbits, tape, tlen, n_backing = PD.poa_dp_tb(*t, init)
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


def _time_in_turns(t, init, reps=10):
    """K2 + K3 and K6 on the same CUDA tensors, after a warm-up, in turns
    K2 + K3, K6, K6, K2 + K3: lists of K2, K3 and K6 ms, two turns each."""
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    _s, sinks, tbits = PD.poa_dp(*t, init)
    PD.poa_traceback(tbits, t[1], sinks, t[5])
    PD.poa_dp_tb(*t, init)
    torch.cuda.synchronize()
    k2, k3, k6 = [], [], []
    for turn in ("old", "new", "new", "old"):
        if turn == "old":
            k2.append(_cuda_ms(lambda: PD.poa_dp(*t, init), reps))
            k3.append(_cuda_ms(lambda: PD.poa_traceback(tbits, t[1], sinks, t[5]), reps))
        else:
            k6.append(_cuda_ms(lambda: PD.poa_dp_tb(*t, init), reps))
    return k2, k3, k6


def _turns_line(k2, k3, k6):
    return (f"K2 + K3 {k2[0]:.4f} + {k3[0]:.4f}, K6 {k6[0]:.4f}, K6 {k6[1]:.4f}, "
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


def _plain_pair(t, init):
    from vgaligner_tpu_torch.ops import poa_device as PD

    _s, sinks, tbits = PD.poa_dp_plain(*t, init)
    return PD.poa_traceback_plain(tbits, t[1], sinks, t[5])


def phase_local_kernel(dev, results):
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD
    from vgaligner_tpu_torch.testing import random_poa_batch

    errs = []
    for P in (2, 4, 8):
        for W in (128, 256, 2048):
            for V in (256, 2048):
                vcodes, vpred, _sink, nv, q, nq = random_poa_batch(P + W + V, 32, V, P, W - 1)
                q[0] = 4  # no positive cell
                n = min(V, W - 1) // 2
                q[1:, :n] = vcodes[1:, :n]  # long local matches
                t = [torch.from_numpy(a).to(dev) for a in (vcodes, vpred, nv, q, nq)]
                got = PD.poa_local(*t)
                want = PD.poa_local_plain(*t)
                _check_equal(f"poa_local P={P} W={W} V={V}", ("best", "tape", "tlen", "qend"),
                             got, want, errs)
                if float(got[0][0]) != 0.0 or not bool((nv < V).any()):
                    raise AssertionError("poa_local batch lacks its edge cases")
                print(f"[kernels] poa_local P={P} W={W} V={V} B=32: best/tape/tlen/qend equal "
                      f"(max tlen {int(got[2].max())})")
    results["poa_local"] = dict(max_abs_err=max(errs))


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


def _cpu_rerun(work, name, prefix, gfa, reads, out, argv):
    """The first CPU_SAMPLE reads on the plain twins; both GAFs equal to
    the card run's rows for those reads."""
    sample_fa = os.path.join(work, f"{name}-sample.fa")
    with open(sample_fa, "w") as fh:
        for i in range(min(CPU_SAMPLE, len(reads))):
            fh.write(f">read{i}\n{reads[i]}\n")
    cpu_out = os.path.join(work, f"{name}-cpu", "smoke")
    _map(prefix, sample_fa, gfa, cpu_out, argv + ["--device", "cpu"])
    names = {f"read{i}".encode() for i in range(min(CPU_SAMPLE, len(reads)))}
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
                                ("chain_dp", "poa_dp_tb"), ("poa_dp", "poa_traceback"))
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


def phase_rspoa_path(work, prefix, gfa, fasta, reads, card, dev, results):
    import torch

    from vgaligner_tpu_torch.ops import poa_device as PD

    captured = {}
    real = PD.poa_local

    def keep_largest(*args):
        if not captured or args[0].shape[0] > captured["args"][0].shape[0]:
            captured["args"] = args
        return real(*args)

    out = os.path.join(work, "rspoa", "smoke")
    PD.poa_local = keep_largest
    try:
        took, launches = _drive("the rspoa path", prefix, fasta, gfa, out,
                                ["-p", "rspoa", "--precision", "exact"],
                                ("chain_dp_exact", "poa_local"), ("chain_dp", "poa_dp"))
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

    args = captured["args"]
    got = real(*args)
    want = PD.poa_local_plain(*args)
    errs = []
    _check_equal("poa_local on the main reads' batch", ("best", "tape", "tlen", "qend"), got,
                 want, errs)
    ms = _cuda_ms(lambda: real(*args), 5)
    plain_ms = _cuda_ms(lambda: PD.poa_local_plain(*args), 1)
    B, V = args[0].shape
    print(f"[rspoa] poa_local on the main reads' largest batch B={B} V={V} "
          f"W={args[3].shape[1] + 1} P={args[1].shape[-1]}: equal; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    results["poa_local"].update(max_abs_err=max(results["poa_local"]["max_abs_err"], *errs),
                                ms=ms, plain_ms=plain_ms,
                                **_bound_keys(*_local_work(args), F32_OPS_PER_S))
    torch.cuda.synchronize()
    return launches


def phase_long_reads(work, prefix, gfa, graph, card):
    from vgaligner_tpu_torch.testing import sample_reads, write_fasta

    rng = np.random.default_rng(3)
    lens = [int(x) for x in rng.integers(1500, 2101, N_LONG)] + [10000]
    reads = [sample_reads(graph, 1, n, seed=1000 + i, sub_rate=0.01)[0]
             for i, n in enumerate(lens)]
    fasta = os.path.join(work, "long.fa")
    write_fasta(fasta, reads)
    out = os.path.join(work, "long-card", "smoke")
    argv = ["-p", "abpoa", "--precision", "fast"]
    took, launches = _drive("the long-read path", prefix, fasta, gfa, out, argv,
                            ("chain_dp", "poa_dp", "poa_traceback"), ("poa_dp_tb",))
    n_chains, mapped = _check_gaf(out, len(reads),
                                  {f"read{i}": len(r) for i, r in enumerate(reads)})
    cpu_out = os.path.join(work, "long-cpu", "smoke")
    t0 = time.monotonic()
    _map(prefix, fasta, gfa, cpu_out, argv + ["--device", "cpu"])
    cpu_took = time.monotonic() - t0
    for kind in ("chains", "alignments"):
        with open(f"{out}-{kind}.gaf", "rb") as a, open(f"{cpu_out}-{kind}.gaf", "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"long reads: {kind} GAF differs between card and CPU")
    print(f"[long] map -p abpoa -D on {N_LONG} reads of 1,500-2,100 bp and one of 10 kb: "
          f"card {took:.2f} s ({card}), CPU plain {cpu_took:.2f} s; {mapped}/{len(reads)} "
          f"aligned; chains and alignments GAF byte-identical; launches {launches}")
    return launches


def kernel_line(results, launches, launches_rspoa, launches_long):
    """The per-kernel result line: each kernel with the launches of the
    path that runs it and its measured and bound times."""
    k2_replaces = "vgaligner_tpu/ops/poa_pallas2.py:434, vgaligner_tpu/ops/poa_pallas.py:258"
    k3_replaces = "vgaligner_tpu/ops/poa_device.py:325"
    sources = {
        "chain_dp": ("chain_dp.cu", "vgaligner_tpu/ops/chain_pallas.py:187", launches),
        "poa_dp": ("poa_dp.cu", f"{k2_replaces} (rows over 256 columns)", launches_long),
        "poa_traceback": ("poa_traceback.cu", f"{k3_replaces} (rows over 256 columns)",
                          launches_long),
        "poa_dp_tb": ("poa_dp_tb.cu", f"{k2_replaces}, {k3_replaces} (rows up to 256 "
                      "columns)", launches),
        "poa_local": ("poa_local.cu", "vgaligner_tpu/ops/poa_device.py:1075", launches_rspoa),
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
        phase_chain_kernels(index, reads, dev, results)
        main_t, main_init = phase_poa_kernels(dev, results)
        phase_fused_kernel(dev, results, main_t, main_init)
        phase_local_kernel(dev, results)
        launches = phase_main_path(work, prefix, gfa, fasta, reads, card, results)
        launches_rspoa = phase_rspoa_path(work, prefix, gfa, fasta, reads, card, dev, results)
        launches_long = phase_long_reads(work, prefix, gfa, graph, card)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)

    line = kernel_line(results, launches, launches_rspoa, launches_long)
    print(f"[done] smoke took {time.monotonic() - t_start:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
