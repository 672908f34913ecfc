"""Native host runtime (C++ via ctypes).

The device compute path is PyTorch and the CUDA kernels; this package is
the native runtime around it: the host-side hot loops that build the
index and feed/drain the POA device kernels (see host_kernels.cpp).  The
shared library is compiled with g++ at first use into
``vgaligner_tpu_torch/_build/`` (gitignored), named by a hash of the
source and the flags so that an edited source never loads a stale
library, under a lock file so that concurrent processes build it once.
Nothing is written next to the sources.  The port has no Python
fallback for this runtime: ``require_native`` raises when the build
failed.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Dict, List, NamedTuple, Optional

import numpy as np

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "host_kernels.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_build_error = ""

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i8p = ctypes.POINTER(ctypes.c_int8)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_charp = ctypes.c_char_p


def _build() -> Optional[str]:
    """Compile the shared library into BUILD_DIR unless this source and
    flag hash already has one there; None (and ``_build_error``) when
    g++ fails."""
    global _build_error
    import fcntl

    h = hashlib.sha256()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(_CXX_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"host_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *_CXX_FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            _build_error = proc.stderr[-4000:]
            log.error("native build failed (g++ exit %d):\n%s", proc.returncode, _build_error)
            return None
        os.replace(tmp, path)
    return path


def require_native():
    """The native runtime's library; the port has no Python fallbacks."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "the native host runtime (vgaligner_tpu_torch/native/host_kernels.cpp) "
            f"did not build; the port needs g++ and does not fall back\n{_build_error}"
        )
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it did not build."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.vg_free.argtypes = [ctypes.c_void_p]
        lib.vg_free.restype = None
        lib.vg_kmer_index.argtypes = [
            ctypes.c_int64, _charp, _i64p, _i64p, _i64p, _i64p, _i64p,
            _i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, _i64p,
            ctypes.POINTER(_i64p), ctypes.POINTER(_i64p),
            ctypes.POINTER(_i64p), _i64p, ctypes.POINTER(_i64p),
        ]
        lib.vg_kmer_index.restype = ctypes.c_int64
        lib.vg_path_kmers.argtypes = [
            ctypes.c_int64, _charp, _i64p, _i64p, ctypes.c_int64,
            ctypes.c_int64, _i64p, _i64p,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(_i64p), ctypes.POINTER(_i64p),
            ctypes.POINTER(_i64p), _i64p, ctypes.POINTER(_i64p),
        ]
        lib.vg_path_kmers.restype = ctypes.c_int64
        lib.vg_pack_poa_wire.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            _i8p, _i32p, _i32p, ctypes.c_int64,
            _u8p, _u8p,
            ctypes.POINTER(_i32p), ctypes.POINTER(_u16p), _i64p, _i64p,
        ]
        lib.vg_pack_poa_wire.restype = ctypes.c_int64
        lib.vg_build_poa_batch.argtypes = [
            ctypes.c_int64, _i64p, _charp, _i64p, _i64p, _i64p, _i64p,
            ctypes.c_int64, ctypes.c_int64,
            _i8p, _i32p, _u8p, _i32p, _i32p, _i32p,
        ]
        lib.vg_build_poa_batch.restype = ctypes.c_int64
        lib.vg_extract_subgraphs.argtypes = [
            ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
            _charp, _charp, ctypes.c_int64,
            ctypes.c_int64, _i64p, _i64p, _i64p, _i64p, _i8p, _i8p,
            _i64p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(_i64p), ctypes.POINTER(_i64p),
            ctypes.POINTER(_i64p), ctypes.POINTER(_i64p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(_i64p), ctypes.POINTER(_i64p),
            ctypes.POINTER(_u8p),
        ]
        lib.vg_extract_subgraphs.restype = ctypes.c_int64
        lib.vg_subgraph_paths.argtypes = [
            ctypes.c_int64, _i64p, _i64p,
            ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i64p, _i32p,
            _i64p, ctypes.POINTER(_i64p),
        ]
        lib.vg_subgraph_paths.restype = ctypes.c_int64
        lib.vg_finish_tapes.argtypes = [
            ctypes.c_int64, ctypes.c_int64, _i8p, _i32p, _i32p,
            _i64p, _i8p, _i32p, _i32p,
            _i8p, ctypes.c_int64,
            _charp, ctypes.c_int64, _i32p,
            _charp, ctypes.c_int64, _i32p,
            _i32p, ctypes.c_int64, _i32p,
            _i32p, ctypes.c_int64, _i32p,
            _i32p,
        ]
        lib.vg_finish_tapes.restype = ctypes.c_int64
        lib.vg_count_anchors.argtypes = [
            ctypes.c_int64, _charp, _i64p, ctypes.c_int32, _i64p, _i64p,
            ctypes.c_int64, _i64p, _i32p,
        ]
        lib.vg_count_anchors.restype = ctypes.c_int64
        lib.vg_anchor_coords.argtypes = [
            ctypes.c_int64, _charp, _i64p, ctypes.c_int32, _i64p, _i64p,
            _i64p, _i64p, _i64p, ctypes.c_int64, _i64p, _i64p, _i32p,
            _i64p, _i64p, _i64p, _i32p,
        ]
        lib.vg_anchor_coords.restype = ctypes.c_int64
        lib.vg_backtrack.argtypes = [
            ctypes.c_int64, ctypes.c_int64, _i32p, _u8p, _i32p,
            ctypes.c_int64,
            ctypes.POINTER(_i64p), ctypes.POINTER(_i64p),
            ctypes.POINTER(_i32p),
        ]
        lib.vg_backtrack.restype = ctypes.c_int64
        lib.vg_backtrack_delta.argtypes = [
            ctypes.c_int64, ctypes.c_int64, _u8p, _i32p,
            ctypes.c_int64,
            ctypes.POINTER(_i64p), ctypes.POINTER(_i64p),
            ctypes.POINTER(_i32p),
        ]
        lib.vg_backtrack_delta.restype = ctypes.c_int64
        lib.vg_decode_tape_u8.argtypes = [
            ctypes.c_int64, ctypes.c_int64, _u8p, _i32p,
            _i32p, _i32p, ctypes.c_int64,
            _i8p, _i32p,
        ]
        lib.vg_decode_tape_u8.restype = ctypes.c_int64
        lib.vg_poa_global_host.argtypes = [
            _charp, _i64p, ctypes.c_int64, _i64p, ctypes.c_int64,
            _i8p, ctypes.c_int64,
            ctypes.POINTER(_i8p), ctypes.POINTER(_i32p), _i64p,
            ctypes.POINTER(_i8p), ctypes.POINTER(_i32p), ctypes.POINTER(_i32p),
            _i64p,
        ]
        lib.vg_poa_global_host.restype = ctypes.c_int64
        lib.vg_baseline_map_align.argtypes = [
            ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
            _charp, _charp, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64, _i64p, _i64p, _i64p,
            _i64p, _i64p,
            ctypes.c_int64, _charp, _i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32,
            _i64p, _i64p,
        ]
        lib.vg_baseline_map_align.restype = ctypes.c_int64
        lib.vg_map_read_chains.argtypes = [
            _charp, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
            _i64p, _i64p, _i64p, _i64p, _i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(_i64p), ctypes.POINTER(_i64p),
            ctypes.POINTER(_i64p), ctypes.POINTER(_i64p),
        ]
        lib.vg_map_read_chains.restype = ctypes.c_int64
        lib.vg_chains_gaf.argtypes = [
            ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
            _i8p, _i8p, _u8p, _i32p, _i64p,
            _charp, _i64p, ctypes.c_int64,
            _i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p), _i64p,
        ]
        lib.vg_chains_gaf.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


def _p32(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


def _p8(a: np.ndarray):
    return a.ctypes.data_as(_i8p)


def kmer_index_native(graph, k: int, edge_max, degree_max, sampling_rate,
                      node_starts: np.ndarray, seq_len: int,
                      drop_handle_on_n: bool = True,
                      dedup_positions: bool = True,
                      state_cap: int = 0,
                      modimizer: str = "ahash"):
    """Native replacement for generate_kmers + generate_pos_on_ref.

    Returns (codes, offsets, counts, positions) with codes the sorted
    2-bit packed unique k-mer codes (kmer_gen.py returns the seq strings;
    Index.build converts to codes — the native path skips the strings).
    """
    lib = get_lib()
    assert lib is not None
    from ..graph.handlegraph import handle_pack

    ids = graph.node_ids()
    n = len(ids)
    # contiguity is enforced by Index.build before calling
    labels = []
    label_off = np.zeros(n + 1, dtype=np.int64)
    l_off = np.zeros(n + 1, dtype=np.int64)
    r_off = np.zeros(n + 1, dtype=np.int64)
    l_dat: list = []
    r_dat: list = []
    for i, nid in enumerate(ids):
        node = graph._nodes[nid]
        labels.append(node.sequence)
        label_off[i + 1] = label_off[i] + len(node.sequence)
        l_dat.extend(node.left_edges)
        r_dat.extend(node.right_edges)
        l_off[i + 1] = len(l_dat)
        r_off[i + 1] = len(r_dat)
    labels_b = "".join(labels).encode("ascii")
    l_arr = np.asarray(l_dat, dtype=np.int64) if l_dat else np.zeros(1, np.int64)
    r_arr = np.asarray(r_dat, dtype=np.int64) if r_dat else np.zeros(1, np.int64)
    ns = np.ascontiguousarray(node_starts[:n], dtype=np.int64)

    oc, oo, ocn, op = _i64p(), _i64p(), _i64p(), _i64p()
    n_pos = ctypes.c_int64(0)
    capped = np.zeros(1, dtype=np.int64)
    n_unique = lib.vg_kmer_index(
        n, labels_b, _p64(label_off), _p64(l_off), _p64(l_arr),
        _p64(r_off), _p64(r_arr), _p64(ns), seq_len, k,
        -1 if edge_max is None else edge_max,
        -1 if degree_max is None else degree_max,
        0 if sampling_rate is None else sampling_rate,
        0 if modimizer == "ahash" else 1,
        1 if drop_handle_on_n else 0,
        1 if dedup_positions else 0,
        state_cap, _p64(capped),
        ctypes.byref(oc), ctypes.byref(oo), ctypes.byref(ocn),
        ctypes.byref(n_pos), ctypes.byref(op),
    )
    if capped[0]:
        log.warning(
            "k-mer DFS state cap (%d) hit on %d handle orientations: "
            "dense hub regions enumerated partially", state_cap, capped[0],
        )
    try:
        codes = np.ctypeslib.as_array(oc, shape=(max(n_unique, 1),))[:n_unique].copy()
        offsets = np.ctypeslib.as_array(oo, shape=(max(n_unique, 1),))[:n_unique].copy()
        counts = np.ctypeslib.as_array(ocn, shape=(max(n_unique, 1),))[:n_unique].copy()
        npos = int(n_pos.value)
        positions = (
            np.ctypeslib.as_array(op, shape=(max(npos, 1) * 4,))[: npos * 4]
            .copy()
            .reshape(-1, 4)
        )
    finally:
        lib.vg_free(oc)
        lib.vg_free(oo)
        lib.vg_free(ocn)
        lib.vg_free(op)
    return (codes, offsets, counts, positions, int(capped[0]))


def path_kmers_native(graph, k: int, node_starts: np.ndarray,
                      seq_len: int, dedup_positions: bool = True):
    """Native path-guided k-mer table (kmer_gen.py
    generate_kmers_linearly + generate_pos_on_ref fused): used by the
    DFS-cap fallback merge, where the Python object path measured ~4 s
    on MICB-scale graphs.  Returns (codes, offsets, counts, positions)
    in the same structure as kmer_index_native, or None for k > 32."""
    lib = get_lib()
    assert lib is not None
    if k > 32:
        return None
    ids = graph.node_ids()
    n = len(ids)
    labels = []
    label_off = np.zeros(n + 1, dtype=np.int64)
    for i, nid in enumerate(ids):
        node = graph._nodes[nid]
        labels.append(node.sequence)
        label_off[i + 1] = label_off[i] + len(node.sequence)
    labels_b = "".join(labels).encode("ascii")
    pids = list(graph.paths_iter())
    p_off = np.zeros(len(pids) + 1, dtype=np.int64)
    p_dat: list = []
    for i, pid in enumerate(pids):
        p_dat.extend(graph.get_path(pid).nodes)
        p_off[i + 1] = len(p_dat)
    p_arr = (np.asarray(p_dat, dtype=np.int64) if p_dat
             else np.zeros(1, np.int64))
    ns = np.ascontiguousarray(node_starts[:n], dtype=np.int64)

    oc, oo, ocn, op = _i64p(), _i64p(), _i64p(), _i64p()
    n_pos = ctypes.c_int64(0)
    n_unique = lib.vg_path_kmers(
        n, labels_b, _p64(label_off), _p64(ns), seq_len,
        len(pids), _p64(p_off), _p64(p_arr), k,
        1 if dedup_positions else 0,
        ctypes.byref(oc), ctypes.byref(oo), ctypes.byref(ocn),
        ctypes.byref(n_pos), ctypes.byref(op),
    )
    if n_unique < 0:
        return None
    try:
        codes = np.ctypeslib.as_array(oc, shape=(max(n_unique, 1),))[:n_unique].copy()
        offsets = np.ctypeslib.as_array(oo, shape=(max(n_unique, 1),))[:n_unique].copy()
        counts = np.ctypeslib.as_array(ocn, shape=(max(n_unique, 1),))[:n_unique].copy()
        npos = int(n_pos.value)
        positions = (
            np.ctypeslib.as_array(op, shape=(max(npos, 1) * 4,))[: npos * 4]
            .copy()
            .reshape(-1, 4)
        )
    finally:
        lib.vg_free(oc)
        lib.vg_free(oo)
        lib.vg_free(ocn)
        lib.vg_free(op)
    return codes, offsets, counts, positions


def pack_poa_wire_native(vcodes_p: np.ndarray, vpred_s: np.ndarray,
                         nv: np.ndarray, max_delta: int, t_pad: int):
    """Single-pass v4 wire packing (see host_kernels.cpp
    vg_pack_poa_wire).  vcodes_p [B,V] int8 (sink folded in bit 5),
    vpred_s [B,V,P] int32, nv [B] int32.  Returns (vnib, dnib,
    exc_idx, exc_pd16) with the nibble planes ladder-padded to
    t_pad/2 bytes, or None when a delta exceeds uint16 (caller takes
    the numpy/v3 route)."""
    lib = get_lib()
    if lib is None:
        return None
    B, V = vcodes_p.shape
    P = vpred_s.shape[-1]
    vnib = np.zeros(t_pad // 2, dtype=np.uint8)
    dnib = np.zeros(t_pad // 2, dtype=np.uint8)
    vc = np.ascontiguousarray(vcodes_p, dtype=np.int8)
    vp = np.ascontiguousarray(vpred_s, dtype=np.int32)
    nv_c = np.ascontiguousarray(nv, dtype=np.int32)
    oe, op = _i32p(), _u16p()
    n_exc = np.zeros(1, dtype=np.int64)
    dmax = np.zeros(1, dtype=np.int64)
    rc = lib.vg_pack_poa_wire(
        B, V, P, _p8(vc), _p32(vp), _p32(nv_c), max_delta,
        vnib.ctypes.data_as(_u8p), dnib.ctypes.data_as(_u8p),
        ctypes.byref(oe), ctypes.byref(op), _p64(n_exc), _p64(dmax),
    )
    if rc != 0:
        return None
    try:
        e = int(n_exc[0])
        exc_idx = np.ctypeslib.as_array(oe, shape=(max(e, 1),))[:e].copy()
        exc_pd = np.ctypeslib.as_array(op, shape=(max(e, 1),))[:e].copy()
    finally:
        lib.vg_free(oe)
        lib.vg_free(op)
    return vnib, dnib, exc_idx, exc_pd


def build_poa_batch_arrays(labels_b: bytes, label_off: np.ndarray,
                           prob_node_off: np.ndarray,
                           prob_edge_off: np.ndarray, edges_flat: np.ndarray,
                           sel: Optional[np.ndarray], v_pad: int, p_max: int):
    """Array-form batch subgraph -> padded POA arrays (native), one row a
    problem.

    `sel` picks problems out of the concatenated inputs (None = all).
    Returns None when a selected problem exceeds v_pad or fan-in p_max.
    """
    lib = get_lib()
    assert lib is not None
    B = len(prob_node_off) - 1 if sel is None else len(sel)
    sel_c = None if sel is None else np.ascontiguousarray(sel, dtype=np.int64)

    vcodes = np.zeros((B, v_pad), dtype=np.int8)
    vpred = np.zeros((B, v_pad, p_max), dtype=np.int32)
    is_sink = np.zeros((B, v_pad), dtype=np.uint8)
    nv = np.zeros(B, dtype=np.int32)
    node_of = np.zeros((B, v_pad), dtype=np.int32)
    off_in = np.zeros((B, v_pad), dtype=np.int32)
    rc = lib.vg_build_poa_batch(
        B, None if sel_c is None else _p64(sel_c), labels_b,
        _p64(label_off), _p64(prob_node_off),
        _p64(prob_edge_off), _p64(edges_flat), v_pad, p_max,
        _p8(vcodes), _p32(vpred), vcodes_u8(is_sink), _p32(nv),
        _p32(node_of), _p32(off_in),
    )
    if rc != 0:
        return None
    return vcodes, vpred, is_sink, nv, node_of, off_in


def build_poa_batch_native(problems, v_pad: int, p_max: int):
    """Batch (nodes, edges) subgraphs -> padded POA arrays.

    problems: list of (node_labels: List[str], edges: List[(a, b)]).
    Returns (vcodes [B,v_pad] i8, vpred [B,v_pad,p_max] i32,
    is_sink [B,v_pad] u8, nv [B] i32, node_of [B,v_pad] i32,
    off_in [B,v_pad] i32) or None when a problem exceeds the pads
    (caller falls back to the Python path).
    """
    B = len(problems)
    labels_parts: list = []
    n_total = sum(len(nodes) for nodes, _ in problems)
    e_total = sum(len(edges) for _, edges in problems)
    label_off = np.zeros(n_total + 1, dtype=np.int64)
    prob_node_off = np.zeros(B + 1, dtype=np.int64)
    prob_edge_off = np.zeros(B + 1, dtype=np.int64)
    edges_flat = np.zeros(max(e_total, 1) * 2, dtype=np.int64)
    ni = 0
    ei = 0
    for p, (nodes, edges) in enumerate(problems):
        for s in nodes:
            labels_parts.append(s)
            label_off[ni + 1] = label_off[ni] + len(s)
            ni += 1
        for a, b in edges:
            edges_flat[2 * ei] = a
            edges_flat[2 * ei + 1] = b
            ei += 1
        prob_node_off[p + 1] = ni
        prob_edge_off[p + 1] = ei
    labels_b = "".join(labels_parts).encode("ascii")
    return build_poa_batch_arrays(
        labels_b, label_off, prob_node_off, prob_edge_off, edges_flat,
        None, v_pad, p_max,
    )


def vcodes_u8(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def count_anchors_native(seqs, kmer_codes: np.ndarray,
                         fo_counts: np.ndarray, k: int,
                         lut: "np.ndarray | None" = None) -> np.ndarray:
    """Exact forward-only anchor totals per read (Mapper._anchor_totals).
    lut: optional dense 4^k code->group int32 table (Index.host_lut)."""
    lib = get_lib()
    assert lib is not None
    n = len(seqs)
    seq_off = np.zeros(n + 1, dtype=np.int64)
    for i, s in enumerate(seqs):
        seq_off[i + 1] = seq_off[i] + len(s)
    blob = "".join(seqs).encode("ascii")
    codes_c = np.ascontiguousarray(kmer_codes, dtype=np.int64)
    counts_c = np.ascontiguousarray(fo_counts, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    lut_c = None if lut is None else np.ascontiguousarray(lut, dtype=np.int32)
    lib.vg_count_anchors(
        n, blob, _p64(seq_off), k, _p64(codes_c), _p64(counts_c),
        len(codes_c), _p64(out),
        None if lut_c is None else _p32(lut_c),
    )
    return out


def anchor_coords_native(seqs, index, a_max: np.ndarray, mem_off: np.ndarray,
                         mem_slots: np.ndarray):
    """(qb, tb, te) for chain-member anchors, host-side.

    Member ids are *sorted positions* in the chaining DP's stable
    sort-by-target_end order (ops/chain.py); this re-derives the
    device's anchor set (ops/lookup.py, truncated at a_max per read)
    and its sort so chain emission needs no device round trip.
    a_max [n_reads] int64, mem_off [n_reads+1] int64, mem_slots flat
    int32 (any order per read).  Returns three int64 arrays aligned
    with mem_slots.
    """
    lib = get_lib()
    assert lib is not None
    n = len(seqs)
    seq_off = np.zeros(n + 1, dtype=np.int64)
    for i, s in enumerate(seqs):
        seq_off[i + 1] = seq_off[i] + len(s)
    blob = "".join(seqs).encode("ascii")
    codes_c = np.ascontiguousarray(index.kmer_codes, dtype=np.int64)
    counts_c = np.ascontiguousarray(index.fo_counts, dtype=np.int64)
    offsets_c = np.ascontiguousarray(index.fo_offsets, dtype=np.int64)
    start_c, end_c = index.fo_columns()
    am = np.ascontiguousarray(a_max, dtype=np.int64)
    mo = np.ascontiguousarray(mem_off, dtype=np.int64)
    ms = np.ascontiguousarray(mem_slots, dtype=np.int32)
    m = len(ms)
    qb = np.zeros(m, dtype=np.int64)
    tb = np.zeros(m, dtype=np.int64)
    te = np.zeros(m, dtype=np.int64)
    lut = index.host_lut()
    lut_c = None if lut is None else np.ascontiguousarray(lut, dtype=np.int32)
    rc = lib.vg_anchor_coords(
        n, blob, _p64(seq_off), index.kmer_length, _p64(codes_c),
        _p64(counts_c), _p64(offsets_c), _p64(start_c), _p64(end_c),
        len(codes_c), _p64(am), _p64(mo), _p32(ms),
        _p64(qb), _p64(tb), _p64(te),
        None if lut_c is None else _p32(lut_c),
    )
    if rc != 0:
        raise ValueError(f"anchor position out of range for read {rc - 1}")
    return qb, tb, te


def backtrack_native(pred: np.ndarray, starts: np.ndarray,
                     n_valid: np.ndarray, min_anchors: int):
    """Chain backtracking for a batch (Mapper._backtrack_positions).

    pred [B, A] int32 is consumed (predecessors are nulled in place on a
    copy).  Returns (read_off [B+1], chain_off [n_chains+1],
    positions int32 flat) — per read, chains chain_off[read_off[b]] ..
    chain_off[read_off[b+1]], each an ascending position slice.
    """
    lib = get_lib()
    assert lib is not None
    B, A = pred.shape
    pred_c = np.ascontiguousarray(pred, dtype=np.int32).copy()
    starts_c = np.ascontiguousarray(starts, dtype=np.uint8)
    nv_c = np.ascontiguousarray(n_valid, dtype=np.int32)
    oro, oco = _i64p(), _i64p()
    opos = _i32p()
    n_chains = lib.vg_backtrack(
        B, A, _p32(pred_c), starts_c.ctypes.data_as(_u8p), _p32(nv_c),
        min_anchors, ctypes.byref(oro), ctypes.byref(oco), ctypes.byref(opos),
    )
    try:
        read_off = np.ctypeslib.as_array(oro, shape=(B + 1,)).copy()
        chain_off = np.ctypeslib.as_array(oco, shape=(n_chains + 1,)).copy()
        n_pos = int(chain_off[-1]) if n_chains else 0
        positions = np.ctypeslib.as_array(opos, shape=(max(n_pos, 1),))[:n_pos].copy()
    finally:
        lib.vg_free(oro)
        lib.vg_free(oco)
        lib.vg_free(opos)
    return read_off, chain_off, positions


def backtrack_delta_native(plane: np.ndarray, n_valid: np.ndarray,
                           min_anchors: int):
    """Chain backtracking on the map wire's u8 delta plane (see
    host_kernels.cpp vg_backtrack_delta).  plane [B, A] uint8 is
    consumed (predecessors nulled).  Returns (read_off, chain_off,
    positions) exactly like backtrack_native."""
    lib = get_lib()
    assert lib is not None
    B, A = plane.shape
    pl = np.ascontiguousarray(plane, dtype=np.uint8)
    nv = np.ascontiguousarray(n_valid, dtype=np.int32)
    oro, oco, opos = _i64p(), _i64p(), _i32p()
    n_chains = lib.vg_backtrack_delta(
        B, A, pl.ctypes.data_as(_u8p), _p32(nv), min_anchors,
        ctypes.byref(oro), ctypes.byref(oco), ctypes.byref(opos),
    )
    try:
        read_off = np.ctypeslib.as_array(oro, shape=(B + 1,)).copy()
        chain_off = np.ctypeslib.as_array(oco, shape=(n_chains + 1,)).copy()
        n_pos = int(chain_off[-1]) if n_chains else 0
        positions = np.ctypeslib.as_array(
            opos, shape=(max(n_pos, 1),)
        )[:n_pos].copy()
    finally:
        lib.vg_free(oro)
        lib.vg_free(oco)
        lib.vg_free(opos)
    return read_off, chain_off, positions


def decode_tape_u8_native(tape: np.ndarray, starts: np.ndarray,
                          excpos: np.ndarray, excval: np.ndarray):
    """Native inverse of the device u8 delta tape encoding (see
    host_kernels.cpp vg_decode_tape_u8 and ops/poa_device.py
    _encode_tape_u8).  Returns (ops i8 [b,t], vids i32 [b,t]); raises
    on a corrupt exception stream (positions out of order / count
    mismatch — never produced by the device encoder)."""
    lib = get_lib()
    assert lib is not None
    b, t = tape.shape
    tp = np.ascontiguousarray(tape, dtype=np.uint8)
    st = np.ascontiguousarray(starts, dtype=np.int32)
    ep = np.ascontiguousarray(excpos, dtype=np.int32)
    ev = np.ascontiguousarray(excval, dtype=np.int32)
    ops = np.empty((b, t), np.int8)
    vids = np.empty((b, t), np.int32)
    rc = lib.vg_decode_tape_u8(
        b, t, tp.ctypes.data_as(_u8p), _p32(st),
        _p32(ep), _p32(ev), len(ep),
        ops.ctypes.data_as(_i8p), _p32(vids),
    )
    if rc != 0:
        raise ValueError("corrupt u8 tape exception stream")
    return ops, vids


def poa_global_host_native(nodes, edges, query: str):
    """Native global POA over one (possibly huge) subgraph.

    Bit-identical to ops/poa.py align_global_host; used for problems too
    large for the batched device kernel.  Returns a PoaResult.
    """
    lib = get_lib()
    assert lib is not None
    from ..ops.poa import PoaResult
    from ..utils.dna import encode_seq

    n = len(nodes)
    label_off = np.zeros(n + 1, dtype=np.int64)
    for i, s in enumerate(nodes):
        label_off[i + 1] = label_off[i] + len(s)
    labels_b = "".join(nodes).encode("ascii")
    edges_flat = np.zeros(max(len(edges), 1) * 2, dtype=np.int64)
    for i, (a, b) in enumerate(edges):
        edges_flat[2 * i] = a
        edges_flat[2 * i + 1] = b
    qc = np.ascontiguousarray(encode_seq(query), dtype=np.int8)
    L = len(qc)

    o_ops, o_vids = _i8p(), _i32p()
    o_t = ctypes.c_int64(0)
    o_vc, o_no, o_oi = _i8p(), _i32p(), _i32p()
    o_v = ctypes.c_int64(0)
    best = lib.vg_poa_global_host(
        labels_b, _p64(label_off), n, _p64(edges_flat), len(edges),
        _p8(qc), L,
        ctypes.byref(o_ops), ctypes.byref(o_vids), ctypes.byref(o_t),
        ctypes.byref(o_vc), ctypes.byref(o_no), ctypes.byref(o_oi),
        ctypes.byref(o_v),
    )
    try:
        t = int(o_t.value)
        V = int(o_v.value)
        ops = np.ctypeslib.as_array(o_ops, shape=(max(t, 1),))[:t].copy()
        vids = np.ctypeslib.as_array(o_vids, shape=(max(t, 1),))[:t].copy()
        vcodes = np.ctypeslib.as_array(o_vc, shape=(max(V, 1),))[:V].copy()
        node_of = np.ctypeslib.as_array(o_no, shape=(max(V, 1),))[:V].copy()
        off_in = np.ctypeslib.as_array(o_oi, shape=(max(V, 1),))[:V].copy()
    finally:
        for p in (o_ops, o_vids, o_vc, o_no, o_oi):
            lib.vg_free(p)

    # decode the tape with the shared finisher (batch of one)
    T = max(t, 1)
    bg_off = np.asarray([0, V], dtype=np.int64)
    cigars, css, node_paths, path_vertices, scalars = finish_tapes_native(
        ops.reshape(1, T) if t else np.full((1, 1), 3, np.int8),
        vids.reshape(1, T) if t else np.zeros((1, 1), np.int32),
        np.asarray([t], dtype=np.int32), bg_off,
        vcodes, node_of, off_in, qc.reshape(1, L) if L else np.zeros((1, 1), np.int8),
    )
    return PoaResult(
        cigar=cigars[0],
        cs=css[0],
        path_vertices=path_vertices[0],
        node_path=node_paths[0],
        aln_start_offset=int(scalars[0, 2]),
        aln_end_offset=int(scalars[0, 3]),
        n_aligned=int(scalars[0, 0]),
        best_score=int(best),
        query_start=0,
        query_end=L,
        path_start_offset=int(scalars[0, 4]),
        path_end_offset=int(scalars[0, 5]),
        residue_matches=int(scalars[0, 1]),
    )


def extract_subgraphs_native(index, anchor_off: np.ndarray, aqb: np.ndarray,
                             atb: np.ndarray, ate: np.ndarray,
                             aso: Optional[np.ndarray],
                             aeo: Optional[np.ndarray],
                             qlen: np.ndarray, k: int,
                             bubble_closure: bool = False,
                             range_mode: str = "id"):
    """Batched chain -> subgraph extraction over the index arrays.

    range_mode selects the chain->subgraph strategy (host_kernels.cpp
    vg_extract_subgraphs):
      * "id"       — the reference's contiguous node-id range
                     (align.rs:267-402; strict parity);
      * "corridor" — topology-aware corridor between the chain's first
                     and last anchor nodes (accuracy extension; see
                     models/poa_aligner.py find_range_chain_corridor).
    bubble_closure (exclusive with corridor) splices in out-of-range
    one-hop bubble alt-alleles.
    Returns (handle_off [B+1], handles, label_off [total_nodes+1],
    lbase [total_nodes] — each label's base offset within its node
    (corridor flank-trim 'from', 0 otherwise; rebases GAF node offsets
    to untrimmed coordinates), labels bytes, edge_off [B+1],
    edges [total_edges,2], status [B]) where status[p] != 0 marks a
    problem needing the Python fallback.
    """
    lib = get_lib()
    assert lib is not None
    B = len(anchor_off) - 1
    seq_fwd = index.seq_fwd.encode("ascii")
    seq_rev = index.seq_rev.encode("ascii")
    ns = np.ascontiguousarray(index.node_starts, dtype=np.int64)
    edg = np.ascontiguousarray(index.edges, dtype=np.int64)
    eidx = np.ascontiguousarray(index.edge_idx, dtype=np.int64)
    etn = np.ascontiguousarray(index.edges_to_node, dtype=np.int64)

    ao = np.ascontiguousarray(anchor_off, dtype=np.int64)
    aqb_c = np.ascontiguousarray(aqb, dtype=np.int64)
    atb_c = np.ascontiguousarray(atb, dtype=np.int64)
    ate_c = np.ascontiguousarray(ate, dtype=np.int64)
    aso_c = None if aso is None else np.ascontiguousarray(aso, dtype=np.int8)
    aeo_c = None if aeo is None else np.ascontiguousarray(aeo, dtype=np.int8)
    ql = np.ascontiguousarray(qlen, dtype=np.int64)

    oh, ohs, olo, olbase = _i64p(), _i64p(), _i64p(), _i64p()
    olb = ctypes.c_char_p()
    oeo, oe = _i64p(), _i64p()
    ost = _u8p()
    total_label = lib.vg_extract_subgraphs(
        index.n_nodes, _p64(ns), _p64(edg), _p64(eidx), _p64(etn),
        seq_fwd, seq_rev, index.seq_length,
        B, _p64(ao), _p64(aqb_c), _p64(atb_c), _p64(ate_c),
        None if aso_c is None else _p8(aso_c),
        None if aeo_c is None else _p8(aeo_c),
        _p64(ql), k,
        2 if range_mode == "corridor" else (1 if bubble_closure else 0),
        ctypes.byref(oh), ctypes.byref(ohs), ctypes.byref(olo),
        ctypes.byref(olbase), ctypes.byref(olb), ctypes.byref(oeo),
        ctypes.byref(oe), ctypes.byref(ost),
    )
    try:
        handle_off = np.ctypeslib.as_array(oh, shape=(B + 1,)).copy()
        n_handles = int(handle_off[-1])
        handles = np.ctypeslib.as_array(ohs, shape=(max(n_handles, 1),))[:n_handles].copy()
        label_off = np.ctypeslib.as_array(olo, shape=(n_handles + 1,)).copy()
        lbase = np.ctypeslib.as_array(
            olbase, shape=(max(n_handles, 1),)
        )[:n_handles].copy()
        labels = ctypes.string_at(olb, int(total_label)) if total_label else b""
        edge_off = np.ctypeslib.as_array(oeo, shape=(B + 1,)).copy()
        n_edges = int(edge_off[-1])
        edges_out = (
            np.ctypeslib.as_array(oe, shape=(max(n_edges, 1) * 2,))[: n_edges * 2]
            .copy()
            .reshape(-1, 2)
        )
        status = np.ctypeslib.as_array(ost, shape=(max(B, 1),))[:B].copy()
    finally:
        for p in (oh, ohs, olo, olbase, oeo, oe):
            lib.vg_free(p)
        lib.vg_free(olb)
        lib.vg_free(ost)
    return (handle_off, handles, label_off, lbase, labels, edge_off,
            edges_out, status)


class PathIndex(NamedTuple):
    """A graph's P-lines by handle value, for ``subgraph_paths_native``:
    the path ids in order, and for each distinct step handle (``keys``,
    sorted) its steps ``[key_off[k], key_off[k+1])``, each as its index
    among all paths' steps in (path, position) order and its path's rank."""

    pids: List[int]
    keys: np.ndarray
    key_off: np.ndarray
    occ_step: np.ndarray
    occ_path: np.ndarray


def path_index(graph) -> PathIndex:
    """The ``PathIndex`` of ``graph``'s P-lines, in path-id order."""
    pids = sorted(graph.paths_iter())
    steps = [np.asarray(graph.get_path(pid).nodes, dtype=np.int64) for pid in pids]
    lens = np.asarray([len(s) for s in steps], dtype=np.int64)
    flat = np.concatenate(steps) if steps else np.zeros(0, np.int64)
    # a stable sort keeps each handle's steps in (path, position) order
    order = np.argsort(flat, kind="stable")
    keys, first = np.unique(flat[order], return_index=True)
    return PathIndex(
        pids=pids,
        keys=np.ascontiguousarray(keys, dtype=np.int64),
        key_off=np.append(first, len(flat)).astype(np.int64),
        occ_step=np.ascontiguousarray(order, dtype=np.int64),
        occ_path=np.repeat(np.arange(len(pids), dtype=np.int32), lens)[order],
    )


def subgraph_paths_native(index: PathIndex, handle_off: np.ndarray,
                          handles: np.ndarray) -> List[Dict[int, List[int]]]:
    """``get_subgraph_paths`` of every range of a batch (range p owns
    ``handles[handle_off[p]:handle_off[p+1]]``, the extractor's layout)
    in one native pass: per range, ``{path id: ids rebased to the range}``
    with every path id present.  An empty range raises ValueError, as
    the Python's ``min()`` does."""
    lib = get_lib()
    assert lib is not None
    B, n_paths = len(handle_off) - 1, len(index.pids)
    ho = np.ascontiguousarray(handle_off, dtype=np.int64)
    hs = np.ascontiguousarray(handles, dtype=np.int64)
    if B < 0 or ho[0] != 0 or ho[-1] != len(hs) or (np.diff(ho) < 0).any():
        raise ValueError("handle_off does not partition the handles")
    off = np.empty(B * n_paths + 1, dtype=np.int64)
    out = _i64p()
    bad = lib.vg_subgraph_paths(
        B, _p64(ho), _p64(hs), n_paths, len(index.keys), _p64(index.keys),
        _p64(index.key_off), _p64(index.occ_step), _p32(index.occ_path),
        _p64(off), ctypes.byref(out),
    )
    if bad:
        raise ValueError(f"range {bad - 1} of the batch has no handle")
    try:
        n = int(off[-1])
        ids = np.ctypeslib.as_array(out, shape=(max(n, 1),))[:n].tolist()
    finally:
        lib.vg_free(out)
    off = off.tolist()
    # every (range, path) slice in one C-level map, then a dict a range
    lists = list(map(ids.__getitem__, map(slice, off[:-1], off[1:])))
    return [dict(zip(index.pids, lists[p * n_paths:(p + 1) * n_paths])) for p in range(B)]


def finish_tapes_native(ops: np.ndarray, vids: np.ndarray, tlens: np.ndarray,
                        bg_off: np.ndarray, bg_codes: np.ndarray,
                        bg_node_of: np.ndarray, bg_off_in: np.ndarray,
                        q: np.ndarray):
    """Decode device op tapes into cigar/cs strings + node paths.

    ops [B,T] i8, vids [B,T] i32, tlens [B] i32; bg arrays concatenated
    with bg_off [B+1]; q [B, q_stride] i8.  Returns per-problem lists
    (cigars, css, node_paths, path_vertex_counts, path_vertices,
    scalars [B,6]).
    """
    lib = get_lib()
    assert lib is not None
    B, T = ops.shape
    stride = 4 * T + 64
    cigar_buf = np.empty((B, stride), dtype=np.int8)
    cs_buf = np.empty((B, stride), dtype=np.int8)
    np_buf = np.empty((B, T), dtype=np.int32)
    pv_buf = np.empty((B, T), dtype=np.int32)
    cigar_len = np.empty(B, dtype=np.int32)
    cs_len = np.empty(B, dtype=np.int32)
    np_len = np.empty(B, dtype=np.int32)
    pv_len = np.empty(B, dtype=np.int32)
    scalars = np.empty((B, 6), dtype=np.int32)

    ops_c = np.ascontiguousarray(ops, dtype=np.int8)
    vids_c = np.ascontiguousarray(vids, dtype=np.int32)
    tlens_c = np.ascontiguousarray(tlens, dtype=np.int32)
    q_c = np.ascontiguousarray(q, dtype=np.int8)
    bg_codes_c = np.ascontiguousarray(bg_codes, dtype=np.int8)
    bg_node_of_c = np.ascontiguousarray(bg_node_of, dtype=np.int32)
    bg_off_in_c = np.ascontiguousarray(bg_off_in, dtype=np.int32)
    bg_off_c = np.ascontiguousarray(bg_off, dtype=np.int64)

    lib.vg_finish_tapes(
        B, T, _p8(ops_c), _p32(vids_c), _p32(tlens_c),
        _p64(bg_off_c), _p8(bg_codes_c), _p32(bg_node_of_c), _p32(bg_off_in_c),
        _p8(q_c), q_c.shape[1],
        cigar_buf.ctypes.data_as(_charp), stride, _p32(cigar_len),
        cs_buf.ctypes.data_as(_charp), stride, _p32(cs_len),
        _p32(np_buf), T, _p32(np_len),
        _p32(pv_buf), T, _p32(pv_len),
        _p32(scalars),
    )
    cigars = [cigar_buf[p, : cigar_len[p]].tobytes().decode("ascii") for p in range(B)]
    css = [cs_buf[p, : cs_len[p]].tobytes().decode("ascii") for p in range(B)]
    node_paths = [np_buf[p, : np_len[p]].tolist() for p in range(B)]
    path_vertices = [pv_buf[p, : pv_len[p]].tolist() for p in range(B)]
    return cigars, css, node_paths, path_vertices, scalars


def chains_gaf_blob_native(per_read_chains, index) -> "bytes | None":
    """Batch chains-GAF text (GAFAlignment.from_chain + to_string,
    align.rs:762-930/971-1027) assembled in ONE native pass.

    Returns the full GAF blob (rows for every chain of every read, in
    input order, placeholder rows included) or None when the native
    runtime is unavailable — callers fall back to the Python
    from_chain path, which test_native pins as byte-identical."""
    lib = get_lib()
    if lib is None:
        return None
    chains = [c for cs in per_read_chains for c in cs]
    n = len(chains)
    mem_off = np.zeros(n + 1, dtype=np.int64)
    qlen = np.zeros(n, dtype=np.int64)
    strand = np.zeros(n, dtype=np.uint8)
    mapq = np.zeros(n, dtype=np.int32)
    name_off = np.zeros(n + 1, dtype=np.int64)
    names: list = []
    parts_qb: list = []
    parts_tb: list = []
    parts_te: list = []
    parts_so: list = []
    parts_eo: list = []
    any_orient = False
    for i, c in enumerate(chains):
        # None names render as '*' (to_string's missing-column rule)
        nm = "*" if c.query.name is None else c.query.name
        names.append(nm)
        name_off[i + 1] = name_off[i] + len(nm)
        qlen[i] = len(c.query.seq)
        if c.is_placeholder or c.n_anchors == 0:
            mem_off[i + 1] = mem_off[i]
            continue
        mem_off[i + 1] = mem_off[i] + c.n_anchors
        strand[i] = 1 if getattr(c, "strand", "+") == "-" else 0
        mapq[i] = min(int(max(c.mapping_quality, 0.0)), 254)
        parts_qb.append(np.asarray(c.aqb, dtype=np.int64))
        parts_tb.append(np.asarray(c.atb, dtype=np.int64))
        parts_te.append(np.asarray(c.ate, dtype=np.int64))
        if c.aso is not None:
            parts_so.append(np.asarray(c.aso, dtype=np.int8))
            parts_eo.append(np.asarray(c.aeo, dtype=np.int8))
            any_orient = True
        else:
            parts_so.append(np.zeros(c.n_anchors, dtype=np.int8))
            parts_eo.append(np.zeros(c.n_anchors, dtype=np.int8))
    zero = np.zeros(1, dtype=np.int64)
    qb = np.concatenate(parts_qb) if parts_qb else zero
    tb = np.concatenate(parts_tb) if parts_tb else zero
    te = np.concatenate(parts_te) if parts_te else zero
    if any_orient:
        so = np.concatenate(parts_so)
        eo = np.concatenate(parts_eo)
        so_p, eo_p = _p8(so), _p8(eo)
    else:
        so_p = eo_p = None
    blob = "".join(names).encode("ascii")
    ns = np.ascontiguousarray(index.node_starts, dtype=np.int64)
    out = ctypes.c_void_p()
    out_len = np.zeros(1, dtype=np.int64)
    rc = lib.vg_chains_gaf(
        n, _p64(mem_off), _p64(qb), _p64(tb), _p64(te), so_p, eo_p,
        strand.ctypes.data_as(_u8p), _p32(mapq), _p64(qlen),
        blob, _p64(name_off), index.kmer_length,
        _p64(ns), index.n_nodes, index.seq_length,
        ctypes.byref(out), _p64(out_len),
    )
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out.value, int(out_len[0]))
    finally:
        lib.vg_free(out)


def baseline_map_align_native(index, seqs, bandwidth: int = 50,
                              max_gap: int = 1000, min_anchors: int = 3,
                              also_align: bool = True):
    """Single-threaded native CPU baseline: the reference's per-read loop
    (map.rs:56-111 + align.rs:58-145) restated in C++ (host_kernels.cpp
    vg_baseline_map_align).  bench.py times this as the measured stand-in
    for the Rust reference.  Returns (n_chains [n], tape_len [n])."""
    lib = get_lib()
    assert lib is not None
    n = len(seqs)
    seq_off = np.zeros(n + 1, dtype=np.int64)
    for i, s in enumerate(seqs):
        seq_off[i + 1] = seq_off[i] + len(s)
    blob = "".join(seqs).encode("ascii")
    ns = np.ascontiguousarray(index.node_starts, dtype=np.int64)
    edg = np.ascontiguousarray(index.edges, dtype=np.int64)
    eidx = np.ascontiguousarray(index.edge_idx, dtype=np.int64)
    etn = np.ascontiguousarray(index.edges_to_node, dtype=np.int64)
    codes_c = np.ascontiguousarray(index.kmer_codes, dtype=np.int64)
    counts_c = np.ascontiguousarray(index.fo_counts, dtype=np.int64)
    offsets_c = np.ascontiguousarray(index.fo_offsets, dtype=np.int64)
    start_c, end_c = index.fo_columns()
    start_c = np.ascontiguousarray(start_c, dtype=np.int64)
    end_c = np.ascontiguousarray(end_c, dtype=np.int64)
    n_chains = np.zeros(n, dtype=np.int64)
    tape_len = np.zeros(n, dtype=np.int64)
    rc = lib.vg_baseline_map_align(
        index.n_nodes, _p64(ns), _p64(edg), _p64(eidx), _p64(etn),
        index.seq_fwd.encode("ascii"), index.seq_rev.encode("ascii"),
        index.seq_length,
        index.kmer_length, len(codes_c), _p64(codes_c),
        _p64(counts_c), _p64(offsets_c), _p64(start_c), _p64(end_c),
        n, blob, _p64(seq_off),
        bandwidth, max_gap, min_anchors,
        1 if also_align else 0,
        _p64(n_chains), _p64(tape_len),
    )
    assert rc == 0
    return n_chains, tape_len


def map_read_chains_native(index, seq: str, bandwidth: int = 50,
                           max_gap: int = 1000, min_anchors: int = 3):
    """Exact unbounded single-read chaining on host (host_kernels.cpp
    vg_map_read_chains).  Fallback for reads whose anchor count exceeds
    the device bucket cap — reference semantics with no truncation.
    Returns a list of (qb, tb, te) int64 array triples, one per chain,
    in reference emit order."""
    lib = get_lib()
    assert lib is not None
    blob = seq.encode("ascii")
    codes_c = np.ascontiguousarray(index.kmer_codes, dtype=np.int64)
    counts_c = np.ascontiguousarray(index.fo_counts, dtype=np.int64)
    offsets_c = np.ascontiguousarray(index.fo_offsets, dtype=np.int64)
    start_c, end_c = index.fo_columns()
    start_c = np.ascontiguousarray(start_c, dtype=np.int64)
    end_c = np.ascontiguousarray(end_c, dtype=np.int64)
    o_off, o_qb, o_tb, o_te = _i64p(), _i64p(), _i64p(), _i64p()
    n_chains = lib.vg_map_read_chains(
        blob, len(blob), index.kmer_length, len(codes_c), _p64(codes_c),
        _p64(counts_c), _p64(offsets_c), _p64(start_c), _p64(end_c),
        bandwidth, max_gap, min_anchors,
        ctypes.byref(o_off), ctypes.byref(o_qb), ctypes.byref(o_tb),
        ctypes.byref(o_te),
    )
    try:
        off = np.ctypeslib.as_array(o_off, shape=(n_chains + 1,)).copy()
        total = int(off[-1]) if n_chains else 0
        qb = np.ctypeslib.as_array(o_qb, shape=(max(total, 1),))[:total].copy()
        tb = np.ctypeslib.as_array(o_tb, shape=(max(total, 1),))[:total].copy()
        te = np.ctypeslib.as_array(o_te, shape=(max(total, 1),))[:total].copy()
    finally:
        for p in (o_off, o_qb, o_tb, o_te):
            lib.vg_free(p)
    return [
        (qb[off[c]:off[c + 1]], tb[off[c]:off[c + 1]], te[off[c]:off[c + 1]])
        for c in range(n_chains)
    ]
