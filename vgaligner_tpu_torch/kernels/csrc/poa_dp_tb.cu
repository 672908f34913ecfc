// Global partial-order alignment DP and its traceback in one kernel, for
// sm_90a: rows of W <= 256 columns (reads up to 255 bp).
//
// Replaces, at those widths: vgaligner_tpu/ops/poa_pallas2.py::
// _poa_dp_kernel2 (pallas_call at :434, poa_dp_pallas2) and
// vgaligner_tpu/ops/poa_pallas.py::_poa_dp_kernel (pallas_call at :258,
// poa_dp_pallas, whose lane-padded contract ops/poa_device.py::
// poa_global_kernel runs), each followed by the traceback loop
// vgaligner_tpu/ops/poa_device.py::traceback_batch (:325).  Its outputs
// are bit-identical to ops/poa_device.py::poa_dp_plain followed by
// poa_traceback_plain: score, best_sink, tbits over rows v < nv[b], tape
// and tlen.  Wider rows keep poa_dp.cu and poa_traceback.cu.
//
// The recurrence, the f32 operations and their order, the tie rules and
// the 19 decision bits are poa_dp.cu's (see there); the walk is
// poa_traceback.cu's.
//
// What bounds it on the card: the one output that must reach device
// memory is tbits, 4 bytes a cell written once (134 MB for 1,024
// problems of 256 x 128 cells), so the least time is that write.  The
// vertex loop is serial within a problem (row v reads its predecessors'
// rows) and the walk is a chain of dependent loads, so what the design
// attacks is each problem's latency:
//
//  * one warp per problem, lane l owning columns [l*C, l*C + C), C =
//    W / 32 in 1/2/4/8; a block holds NW problems and has no barrier, so
//    a whole chunk of problems is resident at once and each warp runs
//    its own nv rows;
//  * the state H/E1/E2 lives in shared memory: a ring of RING rows (slot
//    v & (RING - 1); a predecessor RING rows back is read before its
//    slot is overwritten) and PINS pinned rows.  A lane reads and writes
//    only its own columns of every row, and takes the column left of its
//    first from the lane before by shuffle, so a row needs no barrier;
//    the lane-private layout (vector k of lane l at k*32 + l, float4 for
//    C >= 4) is free of bank conflicts;
//  * far predecessors (more than RING rows back): before the first row
//    the warp marks in a per-problem bitmap every vertex that some later
//    vertex reads from that far; the first PINS of them, in ascending id,
//    get the pinned rows, as the JAX kernel's host-planned pins do.  The
//    rest are written to a global backing store [B, V, 3W] and read back
//    from there (only those rows; n_backing[b] counts them).  A
//    predecessor at or past v reads the all-NEGF sentinel, which is what
//    an unwritten row holds in the plain version, so no row is filled;
//  * predecessor ids, codes and sink flags: lane l holds those of vertex
//    32k + l for the current and the next block of 32 rows, and a row
//    takes its own by shuffle;
//  * the in-row gaps: each lane's running max of h_pre + e*j, one warp
//    shuffle scan, then F, H and the case per column;
//  * tbits: one store per cell, 16 bytes at a time where C >= 4;
//  * the best sink: the lane owning column nq keeps the first strict max
//    over rows v < nv (and NEGF at v = nv < V, as the plain argmax);
//  * the walk: lane 0, after a __syncwarp, loads the decision word and
//    the vertex's P predecessor ids together (one dependent round trip a
//    step, to the tbits rows this warp has just written); the warp writes
//    the END tail.
//
// RING 8 and PINS 4 keep the state at 12 rows of 3W floats: 18 KB a warp
// at W = 128, 37 KB at W = 256; with four and two warps a block, three
// blocks fit an SM's shared memory, and the launch bounds hold registers
// to what three blocks allow.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEGF = -1.0e9f;
constexpr float MATCH = 2.0f;
constexpr float MISMATCH = -4.0f;
constexpr float O1 = 4.0f, E1 = 2.0f, O2 = 24.0f, E2 = 1.0f;
constexpr int VIRT_SLOT = 15;
constexpr int RING = 8;  // a power of two
constexpr int PINS = 4;
constexpr int NROWS = RING + PINS;
constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_END = 3;
constexpr int END_FILL = OP_END | (1 << 2);
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// a lane's C columns of one W-float plane in the lane-private layout
template <int C>
__device__ __forceinline__ void load_cols(const float* plane, int lane, float (&x)[C]) {
  if constexpr (C >= 4) {
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
      const float4 t = reinterpret_cast<const float4*>(plane)[k * 32 + lane];
      x[4 * k] = t.x;
      x[4 * k + 1] = t.y;
      x[4 * k + 2] = t.z;
      x[4 * k + 3] = t.w;
    }
  } else if constexpr (C == 2) {
    const float2 t = reinterpret_cast<const float2*>(plane)[lane];
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = plane[lane];
  }
}

template <int C>
__device__ __forceinline__ void store_cols(float* plane, int lane, const float (&x)[C]) {
  if constexpr (C >= 4) {
#pragma unroll
    for (int k = 0; k < C / 4; ++k)
      reinterpret_cast<float4*>(plane)[k * 32 + lane] =
          make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
  } else if constexpr (C == 2) {
    reinterpret_cast<float2*>(plane)[lane] = make_float2(x[0], x[1]);
  } else {
    plane[lane] = x[0];
  }
}

template <int C>
__device__ __forceinline__ void store_row(float* row, int lane, const float (&h)[C],
                                          const float (&e1)[C], const float (&e2)[C]) {
  constexpr int W = 32 * C;
  store_cols<C>(row, lane, h);
  store_cols<C>(row + W, lane, e1);
  store_cols<C>(row + 2 * W, lane, e2);
}

// the decision words of a lane's columns [l*C, l*C + C) of one tbits row
template <int C>
__device__ __forceinline__ void store_bits(int* row, int lane, const int (&x)[C]) {
  if constexpr (C >= 4) {
#pragma unroll
    for (int k = 0; k < C / 4; ++k)
      reinterpret_cast<int4*>(row + lane * C)[k] =
          make_int4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
  } else if constexpr (C == 2) {
    reinterpret_cast<int2*>(row + lane * 2)[0] = make_int2(x[0], x[1]);
  } else {
    row[lane] = x[0];
  }
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

template <int P, int C, int NW>
__global__ void __launch_bounds__(NW * 32, 3)
    poa_dp_tb_kernel(const int8_t* __restrict__ vcodes, const int* __restrict__ vpred,
                     const uint8_t* __restrict__ is_sink, const int* __restrict__ nv,
                     const int8_t* __restrict__ q, const int* __restrict__ nq,
                     const float* __restrict__ init_row, int B, int V, int L, int bm_words,
                     float* __restrict__ backing, float* __restrict__ score,
                     int* __restrict__ best_sink, int* __restrict__ tbits,
                     int* __restrict__ tape, int* __restrict__ tlen,
                     int* __restrict__ n_backing) {
  constexpr int W = 32 * C;
  constexpr int RS = 3 * W;  // floats in a state row: H, E1, E2
  extern __shared__ float4 smem_v4[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int b = blockIdx.x * NW + wib;
  if (b >= B) return;  // whole warps; the block has no barrier
  float* rows = reinterpret_cast<float*>(smem_v4) + (size_t)wib * (NROWS * RS + bm_words);
  unsigned* bm = reinterpret_cast<unsigned*>(rows + NROWS * RS);

  const int nvb = nv[b];
  const int nqb = nq[b];
  const int* vp_b = vpred + (size_t)b * V * P;
  const int8_t* vc_b = vcodes + (size_t)b * V;
  const uint8_t* sk_b = is_sink + (size_t)b * V;
  const int j0 = lane * C;

  // (1) far-referenced vertices into the bitmap; the first PINS are pinned
  for (int w = lane; w < bm_words; w += 32) bm[w] = 0u;
  __syncwarp();
  for (int v = RING + 1 + lane; v < nvb; v += 32) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int pp = vp_b[(size_t)v * P + p];
      if (pp >= 0 && pp < v - RING) atomicOr(&bm[pp >> 5], 1u << (pp & 31));
    }
  }
  __syncwarp();
  int pin[PINS];
  {
    int from = 0;
#pragma unroll
    for (int k = 0; k < PINS; ++k) {
      int found = -1;
      for (int w = from >> 5; w < bm_words; ++w) {
        unsigned m = bm[w];
        if (w == (from >> 5)) m &= ~0u << (from & 31);
        if (m) {
          found = (w << 5) + __ffs(m) - 1;
          break;
        }
      }
      pin[k] = found;
      from = found < 0 ? (bm_words << 5) : found + 1;
    }
  }
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < PINS; ++k)
      if (pin[k] >= 0) bm[pin[k] >> 5] &= ~(1u << (pin[k] & 31));
  }
  __syncwarp();
  {
    int cnt = 0;
    for (int w = lane; w < bm_words; w += 32) cnt += __popc(bm[w]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(FULL, cnt, off);
    if (lane == 0) n_backing[b] = cnt;
  }

  // (2) the lane's query codes, virtual-source row and gap slopes e*j
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

  // (3) the vertex loop
  const float oe1 = O1 + E1, oe2 = O2 + E2;
  int cur_pr[P], nxt_pr[P], cur_code, nxt_code, cur_sink, nxt_sink;
  load_meta<P>(vp_b, vc_b, sk_b, lane, nvb, cur_pr, cur_code, cur_sink);
  load_meta<P>(vp_b, vc_b, sk_b, 32 + lane, nvb, nxt_pr, nxt_code, nxt_sink);
  const int own = nqb - j0;  // column nq's index in this lane's columns, if it owns it
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
          const float* s = rows + srow * RS;
          load_cols<C>(s, lane, h);
          load_cols<C>(s + W, lane, e1);
          load_cols<C>(s + 2 * W, lane, e2);
        } else {
          const float* g = backing + ((size_t)b * V + pp) * RS;
          load_cols<C>(g, lane, h);
          load_cols<C>(g + W, lane, e1);
          load_cols<C>(g + 2 * W, lane, e2);
        }
      } else if (pp < 0 && p == 0 && !has_any) {
        // the virtual source: H = init_row, E1 = E2 = NEGF
#pragma unroll
        for (int c = 0; c < C; ++c) {
          h[c] = ir[c];
          e1[c] = NEGF;
          e2[c] = NEGF;
        }
      } else {
        // a dead slot, or a predecessor at or past v: the all-NEGF row
#pragma unroll
        for (int c = 0; c < C; ++c) {
          h[c] = NEGF;
          e1[c] = NEGF;
          e2[c] = NEGF;
        }
      }
      const float hm = __shfl_up_sync(FULL, h[C - 1], 1);  // H[j0 - 1]
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
    float t1 = neg_inf(), t2 = neg_inf();
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
      t1 = fmaxf(t1, __fadd_rn(h_pre, e1j[c]));
      t2 = fmaxf(t2, __fadd_rn(h_pre, e2j[c]));
    }

    // (B) exclusive prefix max of the lane totals over the warp
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
      const float ph = lane >= 1 ? up : NEGF;
      const bool f1o = f1_first == __fsub_rn(ph, oe1);
      const bool f2o = f2_first == __fsub_rn(ph, oe2);
      pbits[0] |= ((int)f1o << 17) | ((int)f2o << 18);
    }

    // (C) the row: ring slot, pin row or backing store, decision words
    store_row<C>(rows + (v & (RING - 1)) * RS, lane, hrow, best1, best2);
#pragma unroll
    for (int k = 0; k < PINS; ++k)
      if (pin[k] == v) store_row<C>(rows + (RING + k) * RS, lane, hrow, best1, best2);
    if ((bm[v >> 5] >> (v & 31)) & 1u)
      store_row<C>(backing + ((size_t)b * V + v) * RS, lane, hrow, best1, best2);
    store_bits<C>(tbits + ((size_t)b * V + v) * W, lane, pbits);

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
  const int owner = min(max(nqb / C, 0), 31);
  best = __shfl_sync(FULL, best, owner);
  bv = __shfl_sync(FULL, bv, owner);
  if (lane == 0) {
    score[b] = best;
    best_sink[b] = bv;
  }
  __syncwarp();  // this warp's tbits rows are visible to lane 0

  // (5) the walk, from (best_sink, nq) in state H to the virtual source
  const int T = V + W + 1;
  int* tp = tape + (size_t)b * T;
  int n = 0;
  if (lane == 0) {
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
      const int g = min(go_slot, P - 1);
      int pred_at = pr[0];
#pragma unroll
      for (int p = 1; p < P; ++p)
        if (p == g) pred_at = pr[p];
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
  }
  n = __shfl_sync(FULL, n, 0);
  for (int t = n + lane; t < T; t += 32) tp[t] = END_FILL;
  if (lane == 0) tlen[b] = n;
}

// problems a block holds: four warps up to W = 128, two at W = 256, so a
// block's state stays near 74 KB and three blocks fit an SM
template <int C>
constexpr int warps_per_block() {
  return C <= 4 ? 4 : 2;
}

int bitmap_words(int V) { return (((V + 31) >> 5) + 3) & ~3; }  // keeps the next warp 16-B aligned

template <int P, int C>
size_t smem_bytes(int V) {
  return (size_t)warps_per_block<C>() * (NROWS * 3 * 32 * C + bitmap_words(V)) * sizeof(float);
}

template <int P, int C>
cudaError_t prepare(int V, size_t* smem) {
  *smem = smem_bytes<P, C>(V);
  return cudaFuncSetAttribute(poa_dp_tb_kernel<P, C, warps_per_block<C>()>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <int P, int C>
cudaError_t launch(int B, int V, int L, cudaStream_t st, const int8_t* vcodes, const int* vpred,
                   const uint8_t* is_sink, const int* nv, const int8_t* q, const int* nq,
                   const float* init_row, float* backing, float* score, int* best_sink,
                   int* tbits, int* tape, int* tlen, int* n_backing) {
  constexpr int NW = warps_per_block<C>();
  size_t smem;
  cudaError_t e = prepare<P, C>(V, &smem);
  if (e != cudaSuccess) return e;
  poa_dp_tb_kernel<P, C, NW><<<(B + NW - 1) / NW, NW * 32, smem, st>>>(
      vcodes, vpred, is_sink, nv, q, nq, init_row, B, V, L, bitmap_words(V), backing, score,
      best_sink, tbits, tape, tlen, n_backing);
  return cudaGetLastError();
}

template <int P, int C>
cudaError_t occupancy(int V, int* out) {
  constexpr int NW = warps_per_block<C>();
  size_t smem;
  cudaError_t e = prepare<P, C>(V, &smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, poa_dp_tb_kernel<P, C, NW>,
                                                    NW * 32, smem);
  out[0] = NW;
  out[1] = blocks;
  out[2] = (int)smem;
  return e;
}

}  // namespace

#define VG_TB_SWITCH(FN, ...)                                         \
  switch (P * 100 + C) {                                              \
    case 201: return (int)FN<2, 1>(__VA_ARGS__);                      \
    case 202: return (int)FN<2, 2>(__VA_ARGS__);                      \
    case 204: return (int)FN<2, 4>(__VA_ARGS__);                      \
    case 208: return (int)FN<2, 8>(__VA_ARGS__);                      \
    case 401: return (int)FN<4, 1>(__VA_ARGS__);                      \
    case 402: return (int)FN<4, 2>(__VA_ARGS__);                      \
    case 404: return (int)FN<4, 4>(__VA_ARGS__);                      \
    case 408: return (int)FN<4, 8>(__VA_ARGS__);                      \
    case 801: return (int)FN<8, 1>(__VA_ARGS__);                      \
    case 802: return (int)FN<8, 2>(__VA_ARGS__);                      \
    case 804: return (int)FN<8, 4>(__VA_ARGS__);                      \
    case 808: return (int)FN<8, 8>(__VA_ARGS__);                      \
    default: return (int)cudaErrorInvalidValue;                       \
  }

extern "C" int vg_poa_dp_tb(const void* vcodes, const void* vpred, const void* is_sink,
                            const void* nv, const void* q, const void* nq,
                            const void* init_row, int B, int V, int P, int L, void* backing,
                            void* score, void* best_sink, void* tbits, void* tape, void* tlen,
                            void* n_backing, void* stream) {
  const int W = L + 1;
  if (B <= 0) return (int)cudaGetLastError();
  if (W % 32 != 0 || V <= 0) return (int)cudaErrorInvalidValue;
  const int C = W / 32;
  VG_TB_SWITCH(launch, B, V, L, (cudaStream_t)stream, (const int8_t*)vcodes, (const int*)vpred,
               (const uint8_t*)is_sink, (const int*)nv, (const int8_t*)q, (const int*)nq,
               (const float*)init_row, (float*)backing, (float*)score, (int*)best_sink,
               (int*)tbits, (int*)tape, (int*)tlen, (int*)n_backing)
}

// out[0..2]: problems (warps) a block holds, blocks an SM keeps resident,
// dynamic shared memory per block in bytes
extern "C" int vg_poa_dp_tb_occupancy(int P, int W, int V, int* out) {
  if (W % 32 != 0 || V <= 0) return (int)cudaErrorInvalidValue;
  const int C = W / 32;
  VG_TB_SWITCH(occupancy, V, out)
}
