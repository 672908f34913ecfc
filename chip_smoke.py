#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vgaligner_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is not 0:

  1. environment: torch, CUDA and nvcc versions, and the card's name and
     power limit as nvidia-smi reports them;
  2. build: nvcc compiles the three kernels from kernels/csrc into
     vgaligner_tpu_torch/_build/;
  3. kernels against their plain PyTorch twins on the same CUDA tensors
     (tolerance 0: every value is an integer or an integer-valued f32):
     the chaining DP at the main path's shape (4,096 reads x 256
     anchors of real reads) and at A = 16,384 and 65,536; the gap cost
     for g = 0..1000; the POA DP and traceback on random DAG batches
     (P in 2/4/8, W in 128/256, V in 256/2048) and at the main path's
     chunk shape (1,024 x 256 x 128), with kernel and twin times;
  4. the main path through the CLI entry points: ``index -k 11`` and
     ``map -p abpoa -D -G --precision auto`` over 12,288 100 bp reads
     of a seeded HLA-scale synthetic graph (4,760 nodes, 12 haplotypes),
     with every launch counter reset before the map and read after it;
     the first 256 reads are mapped again with ``--device cpu
     --precision fast`` (the plain twins) and both GAFs must be
     byte-identical to the card run's rows for those reads.

Then one JSON line of per-kernel results and, last, the device line.
The CLI runs in a temporary directory (it writes one subgraph GFA per
chain), which is removed at the end.
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


def _max_abs_err(a, b):
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


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
    """The chain kernel's input at the main path's shape: the first
    4,096 reads encoded, looked up at a_max 256 and sorted."""
    import torch

    from vgaligner_tpu_torch.index.device_index import device_index
    from vgaligner_tpu_torch.ops.chain import sort_anchors
    from vgaligner_tpu_torch.ops.encode import encode_reads_host, window_kmer_codes
    from vgaligner_tpu_torch.ops.lookup import lookup_and_materialize_anchors

    codes, lens = encode_reads_host(reads[:4096], 128)
    dindex = device_index(index, dev)
    w, wv = window_kmer_codes(torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev), K)
    anchors = lookup_and_materialize_anchors(dindex, w, wv, 256)
    _o, qb, tb, te, valid = sort_anchors(anchors.qb, anchors.tb, anchors.te, anchors.valid)
    return (qb.contiguous(), tb.to(torch.int32).contiguous(),
            te.to(torch.int32).contiguous(), valid.contiguous())


def _random_sorted_anchors(seed, B, A, dev):
    import torch

    from vgaligner_tpu_torch.ops.chain import sort_anchors

    rng = np.random.default_rng(seed)
    qb = rng.integers(0, 90, (B, A)).astype(np.int32)
    tb = rng.integers(0, 2 * A, (B, A)).astype(np.int64)
    valid = rng.random((B, A)) < 0.9
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    _o, qb_s, tb_s, te_s, v_s = sort_anchors(t(qb), t(tb), t(tb + K), t(valid))
    return (qb_s.contiguous(), tb_s.to(torch.int32).contiguous(),
            te_s.to(torch.int32).contiguous(), v_s.contiguous())


def phase_kernels(index, reads, dev):
    import torch

    from vgaligner_tpu_torch.ops import chain as C
    from vgaligner_tpu_torch.ops import poa_device as PD
    from vgaligner_tpu_torch.testing import random_poa_batch

    results = {}

    # ---- K1: chaining DP
    errs = []
    cases = [("main 4096x256", _main_path_anchors(index, reads, dev)),
             ("A=16384", _random_sorted_anchors(1, 4, 16384, dev)),
             ("A=65536", _random_sorted_anchors(2, 2, 65536, dev))]
    for label, args in cases:
        got = C.chain_dp(*args, K, 50, 1000)
        torch.cuda.synchronize()
        want = C.chain_dp_plain(*args, K, 50, 1000)
        torch.cuda.synchronize()
        for name, g, w in zip(("f", "pred", "curr_max"), got, want):
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"chain_dp {label}: {name} differs in {bad} places")
            errs.append(_max_abs_err(g, w))
        print(f"[kernels] chain_dp {label}: f/pred/curr_max equal "
              f"({int(args[3].sum())} valid anchors)")
    main_args = cases[0][1]
    ms = _cuda_ms(lambda: C.chain_dp(*main_args, K, 50, 1000), 10)
    plain_ms = _cuda_ms(lambda: C.chain_dp_plain(*main_args, K, 50, 1000), 1)
    results["chain_dp"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)
    print(f"[kernels] chain_dp 4096x256: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")

    gaps = torch.arange(0, 1001, dtype=torch.int32)
    g_dev = C.gap_cost_scaled_i32(gaps.to(dev), K).cpu()
    g_cpu = C.gap_cost_scaled_i32_plain(gaps, K)
    table = C.make_gap_cost_table(K, 1000)
    g_f64 = torch.from_numpy(np.floor(table * 1000.0 + 0.5).astype(np.int64))
    if not torch.equal(g_dev, g_cpu) or not torch.equal(g_dev.to(torch.int64), g_f64):
        raise AssertionError("gap cost on the card differs from the CPU / f64 table")
    print("[kernels] gap cost g=0..1000: card == CPU plain == rounded f64 table")

    # ---- K2 + K3: POA DP and traceback
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
        return t, init, tb_k, k_k

    for P in (2, 4, 8):
        for W in (128, 256):
            for V, B in ((256, 32), (2048, 8)):
                run_batch(100 + P * 10 + W + V, B, V, P, W)
                print(f"[kernels] poa_dp + poa_traceback P={P} W={W} V={V} B={B}: "
                      "score/best_sink/tbits[:nv]/tape[:tlen]/tlen equal")
    t, init, tbits, sinks = run_batch(7, 1024, 256, 2, 128)
    ms_dp = _cuda_ms(lambda: PD.poa_dp(*t, init), 5)
    plain_dp = _cuda_ms(lambda: PD.poa_dp_plain(*t, init), 1)
    ms_tb = _cuda_ms(lambda: PD.poa_traceback(tbits, t[1], sinks, t[5]), 5)
    plain_tb = _cuda_ms(lambda: PD.poa_traceback_plain(tbits, t[1], sinks, t[5]), 1)
    print(f"[kernels] poa 1024x256x128 P=2 equal; poa_dp kernel {ms_dp:.3f} ms, "
          f"plain {plain_dp:.3f} ms; poa_traceback kernel {ms_tb:.3f} ms, "
          f"plain {plain_tb:.3f} ms")
    results["poa_dp"] = dict(max_abs_err=max(dp_err), ms=ms_dp, plain_ms=plain_dp)
    results["poa_traceback"] = dict(max_abs_err=max(tb_err), ms=ms_tb, plain_ms=plain_tb)
    return results


def _rows_for(path, names):
    with open(path, "rb") as fh:
        lines = fh.read().splitlines(keepends=True)
    return b"".join(ln for ln in lines if ln.split(b"\t", 1)[0] in names)


def phase_main_path(work, gfa, fasta, reads, card):
    import torch

    from vgaligner_tpu_torch import cli, kernels

    prefix = os.path.join(work, "graph")
    cli.main(["index", "-i", gfa, "-k", str(K), "-o", prefix])
    os.makedirs(os.path.join(work, "card"))
    os.chdir(os.path.join(work, "card"))
    out = os.path.join(work, "card", "smoke")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    cli.main(["map", "-i", prefix, "-f", fasta, "-p", "abpoa", "-D", "-G", gfa,
              "--precision", "auto", "--device", "cuda", "-o", out])
    torch.cuda.synchronize()
    took = time.monotonic() - t0
    launches = kernels.launch_counts()
    for name in ("chain_dp", "poa_dp", "poa_traceback"):
        if launches[name] <= 0:
            raise AssertionError(f"the main path never launched {name}: {launches}")
    rate = N_READS / took
    print(f"[main] map -p abpoa -D on {N_READS} reads: {took:.2f} s, {rate:.1f} reads/s "
          f"streamed map+align ({card}); launches {launches}")

    with open(out + "-alignments.gaf", "rb") as fh:
        aln = fh.read().splitlines()
    with open(out + "-chains.gaf", "rb") as fh:
        chains = fh.read().splitlines()
    if len(aln) != N_READS or len(chains) < N_READS:
        raise AssertionError(f"{len(aln)} alignment rows, {len(chains)} chain rows "
                             f"for {N_READS} reads")
    mapped = 0
    for row in aln:
        cols = row.split(b"\t")
        if len(cols) != 13:
            raise AssertionError(f"malformed GAF row {row[:80]!r}")
        if cols[5] != b"*":
            mapped += 1
            if int(cols[1]) != READ_LEN or int(cols[6]) <= 0 or not cols[12].startswith(b"as:i:"):
                raise AssertionError(f"implausible alignment row {row[:120]!r}")
    if mapped < 0.95 * N_READS:
        raise AssertionError(f"only {mapped} of {N_READS} path-sampled reads aligned")
    print(f"[main] {len(chains)} chain rows, {mapped}/{N_READS} reads aligned")

    sample_fa = os.path.join(work, "sample.fa")
    with open(sample_fa, "w") as fh:
        for i in range(CPU_SAMPLE):
            fh.write(f">read{i}\n{reads[i]}\n")
    os.makedirs(os.path.join(work, "cpu"))
    os.chdir(os.path.join(work, "cpu"))
    cpu_out = os.path.join(work, "cpu", "smoke")
    cli.main(["map", "-i", prefix, "-f", sample_fa, "-p", "abpoa", "-D", "-G", gfa,
              "--precision", "fast", "--device", "cpu", "-o", cpu_out])
    names = {f"read{i}".encode() for i in range(CPU_SAMPLE)}
    for kind in ("chains", "alignments"):
        card_rows = _rows_for(f"{out}-{kind}.gaf", names)
        with open(f"{cpu_out}-{kind}.gaf", "rb") as fh:
            cpu_rows = fh.read()
        if card_rows != cpu_rows:
            raise AssertionError(f"{kind} GAF of the first {CPU_SAMPLE} reads differs "
                                 "between the card and the CPU plain path")
    print(f"[main] first {CPU_SAMPLE} reads: chains and alignments GAF byte-identical "
          "to the --device cpu run")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vgaligner_tpu_torch._shared.graph import graph_from_gfa
    from vgaligner_tpu_torch._shared.index import Index
    from vgaligner_tpu_torch.testing import sample_reads, write_fasta, write_synthetic_gfa

    card = phase_env()
    dev = torch.device("cuda", 0)
    phase_build()

    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="vg_chip_smoke_")
    try:
        gfa = os.path.join(work, "graph.gfa")
        shape = write_synthetic_gfa(gfa, seed=SEED_GRAPH)
        graph = graph_from_gfa(gfa)
        reads = sample_reads(graph, N_READS, READ_LEN, seed=77)
        fasta = os.path.join(work, "reads.fa")
        write_fasta(fasta, reads)
        print(f"[data] synthetic graph {shape}, {len(reads)} reads of {READ_LEN} bp")
        index = Index.build(graph, K, 100, 100)
        results = phase_kernels(index, reads, dev)
        launches = phase_main_path(work, gfa, fasta, reads, card)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)

    sources = {
        "chain_dp": ("vgaligner_tpu_torch/kernels/csrc/chain_dp.cu",
                     "vgaligner_tpu/ops/chain_pallas.py:187"),
        "poa_dp": ("vgaligner_tpu_torch/kernels/csrc/poa_dp.cu",
                   "vgaligner_tpu/ops/poa_pallas2.py:434"),
        "poa_traceback": ("vgaligner_tpu_torch/kernels/csrc/poa_traceback.cu",
                          "vgaligner_tpu/ops/poa_device.py:325"),
    }
    line = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
             **results[name])
        for name, (src, rep) in sources.items()
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
