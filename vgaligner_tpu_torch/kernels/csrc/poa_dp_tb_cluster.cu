// Global partial-order alignment DP and its traceback in one kernel, for
// sm_90a: rows of W = 512-16,384 columns (reads of 256-16,383 bp), one
// thread-block cluster a problem.
//
// Replaces, at those widths: vgaligner_tpu/ops/poa_pallas2.py::
// _poa_dp_kernel2 (pallas_call at :434, poa_dp_pallas2) and
// vgaligner_tpu/ops/poa_pallas.py::_poa_dp_kernel (pallas_call at :258,
// poa_dp_pallas, whose lane-padded contract ops/poa_device.py::
// poa_global_kernel runs), each followed by the traceback loop
// vgaligner_tpu/ops/poa_device.py::traceback_batch (:325).  Its outputs
// are bit-identical to ops/poa_device.py::poa_dp_plain followed by
// poa_traceback_plain: score, best_sink, tbits over rows v < nv[b], tape
// and tlen.  Rows of up to 256 columns take poa_dp_tb.cu.
//
// The recurrence, the f32 operations and their order, the tie rules and
// the 19 decision bits, the row state plan
// (a ring of RING rows, PINS pinned far rows, a global backing store past
// them, counted in n_backing, that holds only the rows the host counted
// for each problem, a far vertex's row its rank among its problem's
// unpinned far vertices, and tlen -1 for a problem given too few) and the
// walk are poa_dp_tb.cu's.
//
// What bounds it on the card: the one output that must reach device
// memory is tbits, 4 bytes a cell written once, so the least time is that
// write.  The vertex loop is serial within a problem and the walk is a
// chain of dependent loads, so what the design attacks is each problem's
// latency, and the SMs a chunk of few wide problems leaves idle:
//
//  * a cluster of N = W / S CTAs a problem, S columns a CTA: S = SLICE =
//    512 at W 512-8,192 (N = 1/2/4/8/16), S = WIDE_SLICE = 1,024 at W
//    16,384 (N = 16, which 512 columns a CTA could not reach: a cluster
//    holds at most 16 CTAs, and 16 is already a non-portable size).  CTA
//    r owns columns [r*S, (r+1)*S); lane l of warp w owns C = 4
//    consecutive columns, so a global warp g = r*WARPS + w owns columns
//    [128g, 128g + 128), with WARPS = S / 128 warps a CTA (4 or 8).  The
//    per-thread code is the same at both slices; S is a template
//    argument, so the 512-column instance is the code it always was.  A
//    chunk of 32 problems at W 2,048 is 128 CTAs, where one block a
//    problem gave 32;
//  * each CTA keeps H/E1/E2 of its own columns for the ring and the pinned
//    rows in shared memory, each thread reading and writing only its own
//    C columns (one float4 a plane, thread t's at float offset t*C, free
//    of bank conflicts), and takes the column left of its first from the
//    lane before by shuffle.  Far predecessors past the pins come from
//    the backing store (back_off: each problem's first row in it; 3W
//    floats a row, never zeroed), whose row every CTA writes in its own
//    columns.  No CTA reads another's rows, so reusing a ring slot needs
//    no order across CTAs;
//  * three values of a row cross a warp boundary (and so a slice
//    boundary), and each warp obtains them without waiting for a second
//    barrier:
//      - before the row's one cluster barrier, lane 31 of every global
//        warp pushes its record {x1, x2, hl} through distributed shared
//        memory to every CTA of rank >= its own (one float4 a CTA, the
//        row's parity picking one of two buffers): x = the max of
//        h_pre + e*j over the warp's columns but its last, hl = h_pre of
//        its last column.  The warp's total is max(x, hl + e*j_last);
//      - after the barrier a warp takes the max of the totals of every
//        earlier global warp (one redux.sync over ordered integers):
//        that gives the in-row gap F's prefix at its first column, exact
//        in any order because max is;
//      - from the record of the warp just before it, lane 0 computes H
//        of the column left of its first, H[v][j0-1] = max(hl, F1, F2)
//        with the same f32 steps as its owner; that value gives the
//        F-open bits of its first column in this row, and lane 0 keeps
//        it in a per-warp halo (a ring of RING entries and PINS pins)
//        for the M term of later rows at that column;
//    so a row has one cluster barrier, and two buffers keep a record a
//    warp still reads from the next row's pushes;
//  * predecessor ids, codes and sink flags: lane l of each warp holds
//    those of vertex 32k + l for the current and the next block of 32
//    rows, and a row takes its own by shuffle;
//  * tbits: one 16-byte store a lane a row;
//  * the best sink: the lane owning column nq keeps the first strict max
//    over rows v < nv (and NEGF at v = nv < V, as the plain argmax);
//  * the walk: after a last cluster barrier (release/acquire, so every
//    CTA's tbits rows are visible) that lane walks, loading the decision
//    word and the vertex's P predecessor ids together, one dependent
//    round trip a step; its warp writes the END tail.  No shared memory
//    is read across CTAs after that barrier, so the other CTAs may exit.
//
// A CTA's state is 12 rows of 3 x S floats (72 KB at S 512, 144 KB at S
// 1,024) plus the halo, the records (2 x 16 x WARPS float4s) and the
// far-vertex bitmap (V / 8 bytes): 152,960 bytes at S 1,024 and V 8,192,
// one CTA an SM, under the 227 KB a block may take.  A launch's device
// memory is tbits [B, V, W] i32 and the backing rows the host counted, so
// a lone problem at V 8,192 x W 16,384 takes 0.54 GB and 196,608 bytes a
// counted row.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEGF = -1.0e9f;
constexpr float MATCH = 2.0f;
constexpr float MISMATCH = -4.0f;
constexpr float O1 = 4.0f, E1 = 2.0f, O2 = 24.0f, E2 = 1.0f;
constexpr int VIRT_SLOT = 15;
constexpr int RING = 8;  // a power of two
constexpr int PINS = 4;
constexpr int NROWS = RING + PINS;
constexpr int C = 4;                      // columns a lane
constexpr int SLICE = 512;                // columns a CTA at W 512-8,192
constexpr int WIDE_SLICE = 1024;          // columns a CTA above, at W 16,384
constexpr int MAX_CTAS = 16;              // CTAs a cluster, at W 8,192 and 16,384

// the sizes that follow from S columns a CTA
template <int S>
struct Slice {
  static constexpr int WARPS = S / (32 * C);  // warps a CTA
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MAX_WARPS = MAX_CTAS * WARPS;  // warps in the largest cluster
};
constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_END = 3;
constexpr int END_FILL = OP_END | (1 << 2);
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// the max of x over the warp: floats as order-preserving integers, one
// redux.sync (no NaN occurs)
__device__ __forceinline__ float warp_max(float x) {
  int i = __float_as_int(x);
  i ^= (i >> 31) & 0x7fffffff;
  i = __reduce_max_sync(FULL, i);
  i ^= (i >> 31) & 0x7fffffff;
  return __int_as_float(i);
}

// C = 4 consecutive columns of a plane, 16 bytes at a time
__device__ __forceinline__ void load_cols(const float* p, float (&x)[C]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void store_cols(float* p, const float (&x)[C]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

template <int P>
__device__ __forceinline__ void load_meta(const int* vp_b, const int8_t* vc_b,
                                          const uint8_t* sk_b, int v, int nvb, int (&pr)[P],
                                          int& code, int& sink) {
  if (v < nvb) {
#pragma unroll
    for (int p = 0; p < P; ++p) pr[p] = vp_b[(size_t)v * P + p];
    code = vc_b[v];
    sink = sk_b[v];
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) pr[p] = -1;
    code = 4;
    sink = 0;
  }
}

// a far vertex's row in its problem's backing store: the far vertices
// below v that are not pinned, counted by the whole warp (v is the same
// in every lane; one bitmap word a lane up to V 1,024, then one redux.sync)
__device__ __forceinline__ int back_rank(const unsigned* bm, int v, int lane) {
  const int wv = v >> 5;
  int cnt = 0;
  for (int i = lane; i <= wv; i += 32) {
    const unsigned m = bm[i];
    cnt += __popc(i == wv ? m & ((1u << (v & 31)) - 1u) : m);
  }
  return __reduce_add_sync(FULL, cnt);
}

template <int P, int S>
__global__ void __launch_bounds__(Slice<S>::THREADS)
    poa_dp_tb_cluster_kernel(const int8_t* __restrict__ vcodes, const int* __restrict__ vpred,
                             const uint8_t* __restrict__ is_sink, const int* __restrict__ nv,
                             const int8_t* __restrict__ q, const int* __restrict__ nq,
                             const float* __restrict__ init_row, int V, int L, int bm_words,
                             const int* __restrict__ back_off, float* __restrict__ backing,
                             float* __restrict__ score,
                             int* __restrict__ best_sink, int* __restrict__ tbits,
                             int* __restrict__ tape, int* __restrict__ tlen,
                             int* __restrict__ n_backing) {
  constexpr int WARPS = Slice<S>::WARPS, THREADS = Slice<S>::THREADS;
  constexpr int MAX_WARPS = Slice<S>::MAX_WARPS;
  constexpr int RS = 3 * S;  // floats in a CTA's state row: H, E1, E2
  extern __shared__ float4 smem_v4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int N = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / N;  // a cluster's CTAs are consecutive in x
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int g = r * WARPS + w;        // the warp's place in the row
  const int jw = g * 32 * C;          // its first column
  const int j0 = jw + lane * C;       // this lane's first column
  const int W = L + 1;
  const size_t RSG = 3 * (size_t)W;   // floats in a backing-store row

  float4* rec = smem_v4;                                      // [2][MAX_WARPS]
  float* rows = reinterpret_cast<float*>(smem_v4 + 2 * MAX_WARPS);  // [NROWS][RS]
  float* halo = rows + NROWS * RS + w * NROWS;                // this warp's [NROWS]
  unsigned* bm = reinterpret_cast<unsigned*>(rows + NROWS * RS + WARPS * NROWS);

  const int nvb = nv[b];
  const int nqb = nq[b];
  const int* vp_b = vpred + (size_t)b * V * P;
  const int8_t* vc_b = vcodes + (size_t)b * V;
  const uint8_t* sk_b = is_sink + (size_t)b * V;

  // (1) far-referenced vertices into the bitmap; the first PINS are
  // pinned.  Every CTA plans the same from vpred.
  for (int i = t; i < bm_words; i += THREADS) bm[i] = 0u;
  __syncthreads();
  for (int v = RING + 1 + t; v < nvb; v += THREADS) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int pp = vp_b[(size_t)v * P + p];
      if (pp >= 0 && pp < v - RING) atomicOr(&bm[pp >> 5], 1u << (pp & 31));
    }
  }
  __syncthreads();
  int pin[PINS];
  {
    int from = 0;
#pragma unroll
    for (int k = 0; k < PINS; ++k) {
      int found = -1;
      for (int i = from >> 5; i < bm_words; ++i) {
        unsigned m = bm[i];
        if (i == (from >> 5)) m &= ~0u << (from & 31);
        if (m) {
          found = (i << 5) + __ffs(m) - 1;
          break;
        }
      }
      pin[k] = found;
      from = found < 0 ? (bm_words << 5) : found + 1;
    }
  }
  __syncthreads();
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < PINS; ++k)
      if (pin[k] >= 0) bm[pin[k] >> 5] &= ~(1u << (pin[k] & 31));
  }
  __syncthreads();
  int n_far = 0;  // this problem's far vertices past the pins, in every warp
  for (int i = lane; i < bm_words; i += 32) n_far += __popc(bm[i]);
  n_far = __reduce_add_sync(FULL, n_far);
  if (r == 0 && t == 0) n_backing[b] = n_far;
  // the rows the host counted for this problem; a row past them is
  // neither written nor read, and tlen says -1
  const int n_back = min(n_far, back_off[b + 1] - back_off[b]);
  float* bk_b = backing + (size_t)back_off[b] * RSG;
  // backing rows written so far: rows go out in ascending v, so this is
  // the rank of the next one (back_rank's count for reads)
  int n_written = 0;

  // (2) the lane's query codes, virtual-source row and gap slopes e*j;
  // the column left of the lane's first (lane 0's halo column); the last
  // column of the warp before this one
  int qv[C];
  float ir[C], e1j[C], e2j[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    qv[c] = j >= 1 ? (int)q[(size_t)b * L + j - 1] : 4;
    ir[c] = init_row[j];
    const float jf = __int2float_rn(j);
    e1j[c] = __fmul_rn(E1, jf);
    e2j[c] = __fmul_rn(E2, jf);
  }
  const float ir_left = j0 >= 1 ? init_row[j0 - 1] : NEGF;
  const float jpf = __int2float_rn(jw - 1);
  const float e1p = __fmul_rn(E1, jpf), e2p = __fmul_rn(E2, jpf);

  // every CTA of the cluster runs before any shared memory is written
  // across CTAs
  cluster.sync();

  // (3) the vertex loop
  const float oe1 = O1 + E1, oe2 = O2 + E2;
  int cur_pr[P], nxt_pr[P], cur_code, nxt_code, cur_sink, nxt_sink;
  load_meta<P>(vp_b, vc_b, sk_b, lane, nvb, cur_pr, cur_code, cur_sink);
  load_meta<P>(vp_b, vc_b, sk_b, 32 + lane, nvb, nxt_pr, nxt_code, nxt_sink);
  const int nqc = min(max(nqb, 0), W - 1);
  const int own = nqc - j0;  // column nq's index in this lane's columns, if it owns it
  float best = neg_inf();
  int bv = 0;

  for (int v = 0; v < nvb; ++v) {
    const int vl = v & 31;
    if (vl == 0 && v > 0) {
#pragma unroll
      for (int p = 0; p < P; ++p) cur_pr[p] = nxt_pr[p];
      cur_code = nxt_code;
      cur_sink = nxt_sink;
      load_meta<P>(vp_b, vc_b, sk_b, v + 32 + lane, nvb, nxt_pr, nxt_code, nxt_sink);
    }
    int preds[P];
    int live_mask = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      preds[p] = __shfl_sync(FULL, cur_pr[p], vl);
      live_mask |= (preds[p] >= 0 ? 1 : 0) << p;
    }
    const int vcode = __shfl_sync(FULL, cur_code, vl);
    const int sink = __shfl_sync(FULL, cur_sink, vl);
    const bool has_any = preds[0] >= 0;

    float sub[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float s = (qv[c] == vcode) ? MATCH : MISMATCH;
      if (qv[c] >= 4 || vcode >= 4) s = MISMATCH;
      sub[c] = s;
    }

    // (A) E1/E2 and M over the predecessor slots, column by column
    float best1[C], best2[C], mbest[C];
    int slot1[C], slot2[C], mslot[C];
    bool opn1[C], opn2[C];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int pp = preds[p];
      float h[C], e1[C], e2[C];
      float hleft = NEGF;  // lane 0: H[pp][j0 - 1]
      if (pp >= 0 && pp < v) {
        int srow = -1;  // shared-memory row, or -1 for the backing store
        if (v - pp <= RING) {
          srow = pp & (RING - 1);
        } else {
#pragma unroll
          for (int k = 0; k < PINS; ++k)
            if (pin[k] == pp) srow = RING + k;
        }
        if (srow >= 0) {
          const float* s = rows + srow * RS + t * C;
          load_cols(s, h);
          load_cols(s + S, e1);
          load_cols(s + 2 * S, e2);
          if (lane == 0) hleft = halo[srow];
        } else {
          const int rank = back_rank(bm, pp, lane);
          if (rank < n_back) {
            const float* gr = bk_b + (size_t)rank * RSG;
            load_cols(gr + j0, h);
            load_cols(gr + W + j0, e1);
            load_cols(gr + 2 * W + j0, e2);
            if (lane == 0 && j0 >= 1) hleft = gr[j0 - 1];
          } else {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              h[c] = NEGF;
              e1[c] = NEGF;
              e2[c] = NEGF;
            }
          }
        }
      } else if (pp < 0 && p == 0 && !has_any) {
        // the virtual source: H = init_row, E1 = E2 = NEGF
#pragma unroll
        for (int c = 0; c < C; ++c) {
          h[c] = ir[c];
          e1[c] = NEGF;
          e2[c] = NEGF;
        }
        hleft = ir_left;
      } else {
        // a dead slot, or a predecessor at or past v: the all-NEGF row
#pragma unroll
        for (int c = 0; c < C; ++c) {
          h[c] = NEGF;
          e1[c] = NEGF;
          e2[c] = NEGF;
        }
      }
      const float up = __shfl_up_sync(FULL, h[C - 1], 1);
      const float hm = lane == 0 ? hleft : up;  // H[j0 - 1]
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        const float hp = h[c];
        const float hpm = c == 0 ? hm : h[c > 0 ? c - 1 : 0];
        const float open1 = __fsub_rn(hp, oe1), ext1 = __fsub_rn(e1[c], E1);
        const float open2 = __fsub_rn(hp, oe2), ext2 = __fsub_rn(e2[c], E2);
        const float cand1 = fmaxf(open1, ext1), cand2 = fmaxf(open2, ext2);
        const float mc = j >= 1 ? __fadd_rn(hpm, sub[c]) : NEGF;
        if (p == 0 || cand1 > best1[c]) {
          best1[c] = cand1;
          slot1[c] = p;
          opn1[c] = open1 >= ext1;
        }
        if (p == 0 || cand2 > best2[c]) {
          best2[c] = cand2;
          slot2[c] = p;
          opn2[c] = open2 >= ext2;
        }
        if (p == 0 || mc > mbest[c]) {
          mbest[c] = mc;
          mslot[c] = p;
        }
      }
    }

    float hpre[C];
    int pbits[C];
    float t1 = neg_inf(), t2 = neg_inf(), x1 = neg_inf(), x2 = neg_inf();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float mx12 = fmaxf(best1[c], best2[c]);
      const float h_pre = fmaxf(mbest[c], mx12);
      const int case_pre = mbest[c] >= mx12 ? 0 : (best1[c] >= best2[c] ? 1 : 2);
      const int ms = (live_mask >> mslot[c]) & 1 ? mslot[c] : VIRT_SLOT;
      const int s1 = (live_mask >> slot1[c]) & 1 ? slot1[c] : VIRT_SLOT;
      const int s2 = (live_mask >> slot2[c]) & 1 ? slot2[c] : VIRT_SLOT;
      hpre[c] = h_pre;
      pbits[c] = case_pre | (ms << 3) | ((int)opn1[c] << 7) | (s1 << 8) | ((int)opn2[c] << 12) |
                 (s2 << 13);
      if (c == C - 1) {
        x1 = t1;
        x2 = t2;
      }
      t1 = fmaxf(t1, __fadd_rn(h_pre, e1j[c]));
      t2 = fmaxf(t2, __fadd_rn(h_pre, e2j[c]));
    }

    // (B) the warp's scan of the lane totals; lane 31's record to every
    // CTA that holds a later warp, then the row's one cluster barrier
    float a1 = t1, a2 = t2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o1 = __shfl_up_sync(FULL, a1, off);
      const float o2 = __shfl_up_sync(FULL, a2, off);
      if (lane >= off) {
        a1 = fmaxf(a1, o1);
        a2 = fmaxf(a2, o2);
      }
    }
    float r1 = __shfl_up_sync(FULL, a1, 1);
    float r2 = __shfl_up_sync(FULL, a2, 1);
    if (lane == 0) {
      r1 = neg_inf();
      r2 = neg_inf();
    }
    {
      const float rx1 = __shfl_sync(FULL, fmaxf(r1, x1), 31);
      const float rx2 = __shfl_sync(FULL, fmaxf(r2, x2), 31);
      const float rhl = __shfl_sync(FULL, hpre[C - 1], 31);
      float4* slot = rec + (v & 1) * MAX_WARPS + g;
      if (lane >= r && lane < N)
        *cluster.map_shared_rank(slot, (unsigned)lane) = make_float4(rx1, rx2, rhl, 0.f);
    }
    cluster.sync();

    // (C) the prefix over the earlier warps' totals; H of the column
    // left of this warp's first, from its owner's record
    const float4* rb = rec + (v & 1) * MAX_WARPS;
    float m1 = neg_inf(), m2 = neg_inf();
    for (int k = lane; k < g - 1; k += 32) {
      const float4 x = rb[k];
      const float jf = __int2float_rn(k * 32 * C + 32 * C - 1);
      m1 = fmaxf(m1, fmaxf(x.x, __fadd_rn(x.z, __fmul_rn(E1, jf))));
      m2 = fmaxf(m2, fmaxf(x.y, __fadd_rn(x.z, __fmul_rn(E2, jf))));
    }
    m1 = warp_max(m1);
    m2 = warp_max(m2);
    float hprev = NEGF;
    if (g >= 1) {
      const float4 x = rb[g - 1];
      const float f1p = __fsub_rn(__fsub_rn(fmaxf(m1, x.x), O1), e1p);
      const float f2p = __fsub_rn(__fsub_rn(fmaxf(m2, x.y), O2), e2p);
      hprev = fmaxf(x.z, fmaxf(f1p, f2p));
      m1 = fmaxf(m1, fmaxf(x.x, __fadd_rn(x.z, e1p)));
      m2 = fmaxf(m2, fmaxf(x.y, __fadd_rn(x.z, e2p)));
    }
    r1 = fmaxf(r1, m1);
    r2 = fmaxf(r2, m2);

    // F, H and the case of each column; r1/r2 = c[j-1] on entry to column j
    float hrow[C];
    float f1_first = NEGF, f2_first = NEGF, prev_h = NEGF;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const float f1 = j >= 1 ? __fsub_rn(__fsub_rn(r1, O1), e1j[c]) : NEGF;
      const float f2 = j >= 1 ? __fsub_rn(__fsub_rn(r2, O2), e2j[c]) : NEGF;
      r1 = fmaxf(r1, __fadd_rn(hpre[c], e1j[c]));
      r2 = fmaxf(r2, __fadd_rn(hpre[c], e2j[c]));
      const float hh = fmaxf(hpre[c], fmaxf(f1, f2));
      const int cas = hh <= hpre[c] ? (pbits[c] & 7) : (hh == f1 ? 3 : 4);
      pbits[c] = (pbits[c] & ~7) | cas;
      if (c == 0) {
        f1_first = f1;
        f2_first = f2;
      } else {
        const bool f1o = f1 == __fsub_rn(prev_h, oe1);
        const bool f2o = f2 == __fsub_rn(prev_h, oe2);
        pbits[c] |= ((int)f1o << 17) | ((int)f2o << 18);
      }
      hrow[c] = hh;
      prev_h = hh;
    }
    {
      // the first column's F-open bits need H of the column before it
      const float up = __shfl_up_sync(FULL, prev_h, 1);
      const float ph = lane >= 1 ? up : hprev;
      const bool f1o = f1_first == __fsub_rn(ph, oe1);
      const bool f2o = f2_first == __fsub_rn(ph, oe2);
      pbits[0] |= ((int)f1o << 17) | ((int)f2o << 18);
    }

    // (D) the row: ring slot, pin rows, backing store, halo, decision words
    {
      float* s = rows + (v & (RING - 1)) * RS + t * C;
      store_cols(s, hrow);
      store_cols(s + S, best1);
      store_cols(s + 2 * S, best2);
      if (lane == 0) halo[v & (RING - 1)] = hprev;
    }
#pragma unroll
    for (int k = 0; k < PINS; ++k) {
      if (pin[k] == v) {
        float* s = rows + (RING + k) * RS + t * C;
        store_cols(s, hrow);
        store_cols(s + S, best1);
        store_cols(s + 2 * S, best2);
        if (lane == 0) halo[RING + k] = hprev;
      }
    }
    if ((bm[v >> 5] >> (v & 31)) & 1u) {
      if (n_written < n_back) {
        float* gr = bk_b + (size_t)n_written * RSG;
        store_cols(gr + j0, hrow);
        store_cols(gr + W + j0, best1);
        store_cols(gr + 2 * W + j0, best2);
      }
      ++n_written;
    }
    reinterpret_cast<int4*>(tbits + ((size_t)b * V + v) * W + j0)[0] =
        make_int4(pbits[0], pbits[1], pbits[2], pbits[3]);

    if (own >= 0 && own < C) {
      float hn = NEGF;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c == own) hn = hrow[c];
      const float s = sink ? hn : NEGF;
      if (s > best) {
        best = s;
        bv = v;
      }
    }
  }

  // (4) the best sink: the first v at the max, a vertex past nv scoring NEGF
  if (own >= 0 && own < C && nvb < V && NEGF > best) {
    best = NEGF;
    bv = nvb;
  }
  // every CTA's tbits rows are written and visible; no CTA reads another's
  // shared memory after this
  cluster.sync();
  if (nqc < jw || nqc >= jw + 32 * C) return;  // not the warp that holds column nq

  // (5) the walk, from (best_sink, nq) in state H to the virtual source
  const int wl = (nqc - jw) / C;
  const int T = V + W + 1;
  int* tp = tape + (size_t)b * T;
  int n = 0;
  if (lane == wl) {
    score[b] = best;
    best_sink[b] = bv;
    int v = bv, j = nqb, st = 0;
    for (; n < T; ++n) {
      if (v == -2 && j == 0) break;
      const int vc = min(max(v, 0), V - 1);
      int jj = j < 0 ? j + W : j;
      jj = min(max(jj, 0), W - 1);
      const int bits = tbits[((size_t)b * V + vc) * W + jj];
      int pr[P];
#pragma unroll
      for (int p = 0; p < P; ++p) pr[p] = vp_b[(size_t)vc * P + p];
      const int cas = bits & 7;
      const int m_slot = (bits >> 3) & 15;
      const bool at_h = st == 0;
      const bool is_match = at_h && cas == 0;
      const int sw = (at_h && !is_match) ? cas : st;
      const bool in_e = sw == 1 || sw == 2;
      const int e_opn = sw == 1 ? (bits >> 7) & 1 : (bits >> 12) & 1;
      const int e_slot = sw == 1 ? (bits >> 8) & 15 : (bits >> 13) & 15;
      const int go_slot = in_e ? e_slot : m_slot;
      const int gs = min(go_slot, P - 1);
      int pred_at = pr[0];
#pragma unroll
      for (int p = 1; p < P; ++p)
        if (p == gs) pred_at = pr[p];
      const int go_nxt = go_slot == VIRT_SLOT ? -2 : pred_at;
      const bool in_f = sw == 3 || sw == 4;
      const int f_opn = sw == 3 ? (bits >> 17) & 1 : (bits >> 18) & 1;
      const bool from_virtual = v == -2;

      const int op = (from_virtual || in_f) ? OP_I : (in_e ? OP_D : OP_M);
      const int vid = from_virtual ? -1 : v;
      tp[n] = (op | ((vid + 2) << 2)) & 0xFFFF;
      const int v2 = (from_virtual || in_f) ? v : go_nxt;
      const int j2 = (from_virtual || in_f || is_match) ? j - 1 : j;
      int st2;
      if (from_virtual || is_match) {
        st2 = 0;
      } else if (in_e) {
        st2 = e_opn ? 0 : sw;
      } else if (in_f) {
        st2 = f_opn ? 0 : sw;
      } else {
        st2 = st;
      }
      v = v2;
      j = j2;
      st = st2;
    }
    tlen[b] = n_back < n_far ? -1 : n;
  }
  n = __shfl_sync(FULL, n, wl);
  for (int i = n + lane; i < T; i += 32) tp[i] = END_FILL;
}

}  // namespace

namespace {

int bitmap_words(int V) { return (((V + 31) >> 5) + 3) & ~3; }

// columns a CTA at row width W
int cta_cols(int W) { return W <= SLICE * MAX_CTAS ? SLICE : WIDE_SLICE; }

template <int S>
size_t smem_bytes(int V) {
  return 2 * Slice<S>::MAX_WARPS * sizeof(float4) +
         ((size_t)NROWS * 3 * S + Slice<S>::WARPS * NROWS + bitmap_words(V)) * sizeof(float);
}

// CTAs a cluster at row width W, or 0 where W is not one the kernel takes
int cluster_ctas(int W) {
  const int s = cta_cols(W);
  const int n = W / s;
  return (W % s == 0 && (n == 1 || n == 2 || n == 4 || n == 8 || n == 16)) ? n : 0;
}

template <int P, int S>
cudaError_t configure(int B, int V, int W, cudaStream_t st, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  const int N = cluster_ctas(W);
  if (N == 0 || cta_cols(W) != S || V <= 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<S>(V);
  cudaError_t e = cudaFuncSetAttribute(poa_dp_tb_cluster_kernel<P, S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && N > 8)
    e = cudaFuncSetAttribute(poa_dp_tb_cluster_kernel<P, S>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(B * N), 1, 1);
  cfg->blockDim = dim3(Slice<S>::THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return e;
}

template <int P, int S>
cudaError_t launch_slice(int B, int V, int L, cudaStream_t st, const int8_t* vcodes,
                         const int* vpred, const uint8_t* is_sink, const int* nv,
                         const int8_t* q, const int* nq, const float* init_row,
                         const int* back_off, float* backing, float* score, int* best_sink,
                         int* tbits, int* tape, int* tlen, int* n_backing) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<P, S>(B, V, L + 1, st, &cfg, attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, poa_dp_tb_cluster_kernel<P, S>, vcodes, vpred, is_sink, nv, q,
                         nq, init_row, V, L, bitmap_words(V), back_off, backing, score,
                         best_sink, tbits, tape, tlen, n_backing);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int P>
cudaError_t launch(int B, int V, int L, cudaStream_t st, const int8_t* vcodes, const int* vpred,
                   const uint8_t* is_sink, const int* nv, const int8_t* q, const int* nq,
                   const float* init_row, const int* back_off, float* backing, float* score,
                   int* best_sink, int* tbits, int* tape, int* tlen, int* n_backing) {
  auto go = cta_cols(L + 1) == SLICE ? &launch_slice<P, SLICE> : &launch_slice<P, WIDE_SLICE>;
  return go(B, V, L, st, vcodes, vpred, is_sink, nv, q, nq, init_row, back_off, backing, score,
            best_sink, tbits, tape, tlen, n_backing);
}

template <int P, int S>
cudaError_t occupancy_slice(int W, int V, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<P, S>(1, V, W, nullptr, &cfg, attr);
  if (e != cudaSuccess) return e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, poa_dp_tb_cluster_kernel<P, S>, &cfg);
  out[0] = cluster_ctas(W);
  out[1] = clusters;
  out[2] = (int)cfg.dynamicSmemBytes;
  return e;
}

template <int P>
cudaError_t occupancy(int W, int V, int* out) {
  return cta_cols(W) == SLICE ? occupancy_slice<P, SLICE>(W, V, out)
                              : occupancy_slice<P, WIDE_SLICE>(W, V, out);
}

}  // namespace

extern "C" int vg_poa_dp_tb_cluster(const void* vcodes, const void* vpred, const void* is_sink,
                                    const void* nv, const void* q, const void* nq,
                                    const void* init_row, int B, int V, int P, int L,
                                    const void* back_off, void* backing, void* score,
                                    void* best_sink, void* tbits, void* tape, void* tlen,
                                    void* n_backing, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
#define VG_CLUSTER_LAUNCH(PP)                                                                  \
  launch<PP>(B, V, L, (cudaStream_t)stream, (const int8_t*)vcodes, (const int*)vpred,        \
             (const uint8_t*)is_sink, (const int*)nv, (const int8_t*)q, (const int*)nq,       \
             (const float*)init_row, (const int*)back_off, (float*)backing, (float*)score,      \
             (int*)best_sink, (int*)tbits, (int*)tape, (int*)tlen, (int*)n_backing)
  switch (P) {
    case 2: return (int)VG_CLUSTER_LAUNCH(2);
    case 4: return (int)VG_CLUSTER_LAUNCH(4);
    case 8: return (int)VG_CLUSTER_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VG_CLUSTER_LAUNCH
}

// out[0..2]: CTAs a cluster, clusters the card keeps resident at once,
// dynamic shared memory per CTA in bytes
extern "C" int vg_poa_dp_tb_cluster_occupancy(int P, int W, int V, int* out) {
  switch (P) {
    case 2: return (int)occupancy<2>(W, V, out);
    case 4: return (int)occupancy<4>(W, V, out);
    case 8: return (int)occupancy<8>(W, V, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
