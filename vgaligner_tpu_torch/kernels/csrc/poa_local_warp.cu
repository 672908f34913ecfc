// Local gapless partial-order alignment (rspoa engine), DP + traceback,
// one warp per problem, for sm_90a: rows of W <= 256 columns (reads up
// to 255 bp).
//
// Replaces, at those widths: vgaligner_tpu/ops/poa_device.py::
// poa_local_kernel (:1075), a device loop (an XLA fori_loop over the
// vertices, then a scan for the traceback) with no Pallas kernel.  Its
// outputs are bit-identical to ops/poa_device.py::poa_local_plain: best
// [B] f32, tape [B, W] i32 (W = L + 1, the END fill included), tlen and
// qend.  Rows of 512-16,384 columns take poa_local_cluster.cu.  The
// recurrence:
//   cand_p[j] = H[pred_p][j-1] for a live slot, 0 for a dead one, 0 at j = 0;
//   m_best = max(max_p cand_p, 0); slot = the first live slot at m_best
//     when m_best > 0, else 15;
//   row[0] = 0, row[j] = max(m_best[j] + sub(q[j-1], code[v]), 0);
//   cell byte = slot | (row > 0) << 4;
// best is the largest row value over v < nv[b] at its first cell in
// (v, j) scan order, and the walk takes match steps from there.
//
// What bounds it on the card: the one plane that must reach device
// memory is the cell bytes, 1 byte a cell below nv (131 MB for 8,192
// problems of mean nv 125 x 128 columns), so the least time is that
// write.  The vertex loop is serial within a problem (row v reads its
// predecessors' rows) and the walk is a chain of dependent loads, so
// the design attacks each problem's latency and the bytes around it:
//
//  * one warp per problem, lane l owning columns [l*C, l*C + C), C =
//    W / 32 in 1/2/4/8; a block holds NW problems and has no barrier,
//    so each warp runs its own nv[b] rows, not the batch maximum;
//  * H lives in shared memory as int16: every value is an integer with
//    0 <= H <= 2L <= 510, so int16 is exact and half an f32 row; the
//    f32 outputs are converted at the end, which is exact;
//  * a ring of SLOTS = 16 rows serves every predecessor at most RING = 8
//    rows back.  A row's slot is 16 rows old, so no lane can still be
//    reading it: a lane reads column j - 1 of a predecessor row straight
//    from shared memory (its own C columns and the one before them), and
//    one __syncwarp at the end of a row publishes the row;
//  * far predecessors (more than RING rows back): poa_dp_tb.cu's plan.
//    Before the first row the warp marks in a per-problem bitmap every
//    vertex that some later vertex v < nv reads from that far; the first
//    PINS of them, in ascending id, get pinned rows; the rest are written
//    to a global int16 backing store and read back from there
//    (n_backing[b] counts them).  The store holds only the rows the host
//    counted for each problem (back_off: each problem's first row, so a
//    launch takes [sum of its problems' rows, W] int16, not [B, V, W]);
//    a far vertex's row is its rank among its problem's unpinned far
//    vertices (a running count for writes, which go out in ascending v;
//    the warp's count from the bitmap for reads).  A problem whose far
//    vertices need more rows than it was given (the host and the kernel
//    disagree) writes and reads no row past them and gets tlen -1, which
//    the caller treats as an error.  A dead slot, and a predecessor at or
//    past its vertex, read 0: in the plain version that row is the
//    virtual row V or a row not written yet, all zeros;
//  * predecessor ids and codes: lane l holds those of vertex 32k + l for
//    the current and the next block of 32 rows; a row takes its own by
//    shuffle;
//  * the best cell: each lane keeps the first strict best over its own
//    cells in (v, j) scan order; one warp reduction at the end takes the
//    larger value, then the smaller v, then the smaller j;
//  * cells: one store a lane a row (4 bytes at W = 128, coalesced) into
//    a plane that is never zeroed: every walk starts at a row below nv
//    (or at j = 0, where it stops unread) and moves only to a
//    predecessor whose H at j - 1 is positive, a row below v that this
//    warp has written;
//  * the walk: lane 0, after a __syncwarp, loads the cell byte and the
//    vertex's P predecessor ids together (one dependent round trip a
//    step); the warp writes the END tail.
//
// Shared memory a warp: (SLOTS + PINS) rows of 2W bytes and the bitmap,
// 5 KB at W = 128, 10 KB at W = 256.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MATCH = 2, MISMATCH = -4;
constexpr int VIRT_SLOT = 15;
constexpr int RING = 8;    // rows back that the ring serves
constexpr int SLOTS = 16;  // ring slots, a power of two >= 2 RING
constexpr int PINS = 4;
constexpr int NROWS = SLOTS + PINS;
constexpr int OP_M = 0, OP_END = 3;
constexpr int END_FILL = OP_END | (1 << 2);
constexpr unsigned FULL = 0xffffffffu;

// (value a at cell (av, aj)) wins over (value b at (bv, bj)): the larger
// value, then the earlier cell in (v, j) scan order
__device__ __forceinline__ bool before(int a, int av, int aj, int b, int bv, int bj) {
  if (a != b) return a > b;
  if (av != bv) return av < bv;
  return aj < bj;
}

// a lane's C int16 columns [l*C, l*C + C) of a row
template <int C>
__device__ __forceinline__ void load_own(const int16_t* row, int lane, int (&x)[C]) {
  const int16_t* p = row + lane * C;
  if constexpr (C == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = (int)(int16_t)(w[k] & 0xffffu);
      x[2 * k + 1] = (int)(int16_t)(w[k] >> 16);
    }
  } else if constexpr (C == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    x[0] = (int)(int16_t)(t.x & 0xffffu);
    x[1] = (int)(int16_t)(t.x >> 16);
    x[2] = (int)(int16_t)(t.y & 0xffffu);
    x[3] = (int)(int16_t)(t.y >> 16);
  } else if constexpr (C == 2) {
    const unsigned t = *reinterpret_cast<const unsigned*>(p);
    x[0] = (int)(int16_t)(t & 0xffffu);
    x[1] = (int)(int16_t)(t >> 16);
  } else {
    x[0] = p[0];
  }
}

template <int C>
__device__ __forceinline__ void store_own(int16_t* row, int lane, const int (&x)[C]) {
  int16_t* p = row + lane * C;
  if constexpr (C == 1) {
    p[0] = (int16_t)x[0];
  } else {
    unsigned w[C / 2];
#pragma unroll
    for (int k = 0; k < C / 2; ++k)
      w[k] = ((unsigned)x[2 * k] & 0xffffu) | ((unsigned)x[2 * k + 1] << 16);
    if constexpr (C == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (C == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<unsigned*>(p) = w[0];
    }
  }
}

// the cell bytes of a lane's columns, one store
template <int C>
__device__ __forceinline__ void store_cells(uint8_t* row, int lane, const int (&x)[C]) {
  uint8_t* p = row + lane * C;
  if constexpr (C == 1) {
    p[0] = (uint8_t)x[0];
  } else if constexpr (C == 2) {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)(x[0] | (x[1] << 8));
  } else {
    unsigned w[C / 4];
#pragma unroll
    for (int k = 0; k < C / 4; ++k)
      w[k] = (unsigned)x[4 * k] | ((unsigned)x[4 * k + 1] << 8) |
             ((unsigned)x[4 * k + 2] << 16) | ((unsigned)x[4 * k + 3] << 24);
    if constexpr (C == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<unsigned*>(p) = w[0];
    }
  }
}

template <int P>
__device__ __forceinline__ void load_meta(const int* vp_b, const int8_t* vc_b, int v, int nvb,
                                          int (&pr)[P], int& code) {
  if (v < nvb) {
#pragma unroll
    for (int p = 0; p < P; ++p) pr[p] = vp_b[(size_t)v * P + p];
    code = vc_b[v];
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) pr[p] = -1;
    code = 4;
  }
}

// a far vertex's row in its problem's backing store: the far vertices
// below v that are not pinned, counted by the whole warp (v is the same
// in every lane; one bitmap word a lane, every word below v's, then one
// redux.sync)
__device__ __forceinline__ int back_rank(const unsigned* bm, int v, int lane) {
  const int wv = v >> 5;
  int cnt = 0;
  for (int i = lane; i <= wv; i += 32) {
    const unsigned m = bm[i];
    cnt += __popc(i == wv ? m & ((1u << (v & 31)) - 1u) : m);
  }
  return __reduce_add_sync(FULL, cnt);
}

template <int P, int C, int NW>
__global__ void __launch_bounds__(NW * 32, 8)
    poa_local_warp_kernel(const int8_t* __restrict__ vcodes, const int* __restrict__ vpred,
                          const int* __restrict__ nv, const int8_t* __restrict__ q, int B, int V,
                          int L, int bm_words, const int* __restrict__ back_off,
                          int16_t* __restrict__ backing,
                          uint8_t* __restrict__ cells, float* __restrict__ best_out,
                          int* __restrict__ tape, int* __restrict__ tlen,
                          int* __restrict__ qend, int* __restrict__ n_backing) {
  constexpr int W = 32 * C;
  extern __shared__ uint4 smem_v4[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int b = blockIdx.x * NW + wib;
  if (b >= B) return;  // whole warps; the block has no barrier
  int16_t* rows = reinterpret_cast<int16_t*>(
      reinterpret_cast<char*>(smem_v4) + (size_t)wib * (NROWS * W * 2 + bm_words * 4));
  unsigned* bm = reinterpret_cast<unsigned*>(rows + NROWS * W);

  const int nvb = nv[b];
  const int* vp_b = vpred + (size_t)b * V * P;
  const int8_t* vc_b = vcodes + (size_t)b * V;
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
  int n_far = 0;  // this problem's far vertices past the pins
  for (int w = lane; w < bm_words; w += 32) n_far += __popc(bm[w]);
  n_far = __reduce_add_sync(FULL, n_far);
  if (lane == 0) n_backing[b] = n_far;
  // the rows the host counted for this problem; a row past them is
  // neither written nor read, and tlen says -1
  const int n_back = min(n_far, back_off[b + 1] - back_off[b]);
  int16_t* back_b = backing + (size_t)back_off[b] * W;
  // backing rows written so far: rows go out in ascending v, so this is
  // the rank of the next one (back_rank's count for reads)
  int n_written = 0;

  // (2) the lane's query codes, -1 where no vertex code matches (N, and
  // column 0, whose row value is 0)
  int qm[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    const int qc = j >= 1 ? (int)q[(size_t)b * L + j - 1] : 4;
    qm[c] = qc < 4 ? qc : -1;
  }

  // (3) the vertex loop, to this problem's own nv
  int cur_pr[P], nxt_pr[P], cur_code, nxt_code;
  load_meta<P>(vp_b, vc_b, lane, nvb, cur_pr, cur_code);
  load_meta<P>(vp_b, vc_b, 32 + lane, nvb, nxt_pr, nxt_code);
  int tbest = 0, tv = 0, tj = 0;
  uint8_t* cells_b = cells + (size_t)b * V * W;

  for (int v = 0; v < nvb; ++v) {
    const int vl = v & 31;
    if (vl == 0 && v > 0) {
#pragma unroll
      for (int p = 0; p < P; ++p) cur_pr[p] = nxt_pr[p];
      cur_code = nxt_code;
      load_meta<P>(vp_b, vc_b, v + 32 + lane, nvb, nxt_pr, nxt_code);
    }
    const int vcode = __shfl_sync(FULL, cur_code, vl);

    int mbest[C], mslot[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      mbest[c] = 0;
      mslot[c] = VIRT_SLOT;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int pp = __shfl_sync(FULL, cur_pr[p], vl);
      if (pp >= 0 && pp < v) {  // a dead slot, or one at or past v, reads 0
        const int16_t* src = nullptr;  // nullptr: a backing row past n_back, read as 0
        if (v - pp <= RING) {
          src = rows + (pp & (SLOTS - 1)) * W;
        } else {
#pragma unroll
          for (int k = 0; k < PINS; ++k)
            if (pin[k] == pp) src = rows + (SLOTS + k) * W;
          if (src == nullptr) {
            const int rank = back_rank(bm, pp, lane);
            if (rank < n_back) src = back_b + (size_t)rank * W;
          }
        }
        int own[C];
        int left = 0;  // column j0 - 1
        if (src != nullptr) {
          load_own<C>(src, lane, own);
          if (lane > 0) left = src[j0 - 1];
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) own[c] = 0;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int cand = c == 0 ? left : own[c > 0 ? c - 1 : 0];
          if (cand > mbest[c]) {  // the first slot at the max, when it is positive
            mbest[c] = cand;
            mslot[c] = p;
          }
        }
      }
    }

    int hrow[C], cell[C];
    int rmax = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // a vertex code of 4 (N) matches no qm; column 0 has qm -1, m 0, so row 0
      const int row = max(mbest[c] + (qm[c] == vcode ? MATCH : MISMATCH), 0);
      hrow[c] = row;
      cell[c] = mslot[c] | ((row > 0) << 4);
      rmax = max(rmax, row);
    }
    if (rmax > tbest) {  // the lane's first strict best: its first column at rmax
      tbest = rmax;
      tv = v;
      tj = j0 + C - 1;
#pragma unroll
      for (int c = C - 1; c >= 0; --c)
        if (hrow[c] == rmax) tj = j0 + c;
    }
    store_own<C>(rows + (v & (SLOTS - 1)) * W, lane, hrow);
    if (pin[0] >= 0) {
#pragma unroll
      for (int k = 0; k < PINS; ++k)
        if (pin[k] == v) store_own<C>(rows + (SLOTS + k) * W, lane, hrow);
    }
    if (n_written < n_back && ((bm[v >> 5] >> (v & 31)) & 1u)) {
      store_own<C>(back_b + (size_t)n_written * W, lane, hrow);
      ++n_written;
    }
    store_cells<C>(cells_b + (size_t)v * W, lane, cell);
    __syncwarp();  // row v visible to the later rows' lanes
  }

  // (4) the best cell: larger value, then earlier cell in scan order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(FULL, tbest, off);
    const int ov = __shfl_xor_sync(FULL, tv, off);
    const int oj = __shfl_xor_sync(FULL, tj, off);
    if (before(ob, ov, oj, tbest, tv, tj)) {
      tbest = ob;
      tv = ov;
      tj = oj;
    }
  }

  // (5) the walk: match steps until the zero floor or j == 0
  const int T = W;
  int* tp = tape + (size_t)b * T;
  int n = 0;
  if (lane == 0) {
    int v = tv, j = tj;
    for (; n < T; ++n) {
      if (v < 0 || j <= 0) break;
      const int vc = min(v, V - 1);
      const int bits = cells_b[(size_t)vc * W + j];
      int pr[P];
#pragma unroll
      for (int p = 0; p < P; ++p) pr[p] = vp_b[(size_t)vc * P + p];
      if ((bits >> 4) == 0) break;
      tp[n] = OP_M | ((v + 2) << 2);
      const int slot = bits & 15;
      const int g = min(slot, P - 1);
      int nxt = pr[0];
#pragma unroll
      for (int p = 1; p < P; ++p)
        if (p == g) nxt = pr[p];
      v = slot == VIRT_SLOT ? -2 : nxt;
      j -= 1;
    }
  }
  n = __shfl_sync(FULL, n, 0);
  for (int t = n + lane; t < T; t += 32) tp[t] = END_FILL;
  if (lane == 0) {
    best_out[b] = (float)tbest;
    tlen[b] = n_back < n_far ? -1 : n;
    qend[b] = tj;
  }
}

constexpr int NW = 4;  // problems a block

int bitmap_words(int V) { return (((V + 31) >> 5) + 3) & ~3; }  // keeps the next warp 16-B aligned

template <int C>
size_t smem_bytes(int V) {
  return (size_t)NW * (NROWS * 32 * C * 2 + bitmap_words(V) * 4);
}

template <int P, int C>
cudaError_t prepare(int V, size_t* smem) {
  *smem = smem_bytes<C>(V);
  return cudaFuncSetAttribute(poa_local_warp_kernel<P, C, NW>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <int P, int C>
cudaError_t launch(int B, int V, int L, cudaStream_t st, const int8_t* vcodes, const int* vpred,
                   const int* nv, const int8_t* q, const int* back_off, int16_t* backing,
                   uint8_t* cells, float* best, int* tape, int* tlen, int* qend,
                   int* n_backing) {
  size_t smem;
  cudaError_t e = prepare<P, C>(V, &smem);
  if (e != cudaSuccess) return e;
  poa_local_warp_kernel<P, C, NW><<<(B + NW - 1) / NW, NW * 32, smem, st>>>(
      vcodes, vpred, nv, q, B, V, L, bitmap_words(V), back_off, backing, cells, best, tape, tlen,
      qend, n_backing);
  return cudaGetLastError();
}

template <int P, int C>
cudaError_t occupancy(int V, int* out) {
  size_t smem;
  cudaError_t e = prepare<P, C>(V, &smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, poa_local_warp_kernel<P, C, NW>,
                                                    NW * 32, smem);
  out[0] = NW;
  out[1] = blocks;
  out[2] = (int)smem;
  return e;
}

}  // namespace

#define VG_LW_SWITCH(FN, ...)                                         \
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

// back_off [B + 1] int32: problem b's backing rows are [back_off[b],
// back_off[b + 1]) of backing [back_off[B], W] int16
extern "C" int vg_poa_local_warp(const void* vcodes, const void* vpred, const void* nv,
                                 const void* q, int B, int V, int P, int L, const void* back_off,
                                 void* backing, void* cells, void* best, void* tape, void* tlen,
                                 void* qend, void* n_backing, void* stream) {
  const int W = L + 1;
  if (B <= 0) return (int)cudaGetLastError();
  if (W % 32 != 0 || W > 256 || V <= 0) return (int)cudaErrorInvalidValue;
  const int C = W / 32;
  VG_LW_SWITCH(launch, B, V, L, (cudaStream_t)stream, (const int8_t*)vcodes, (const int*)vpred,
               (const int*)nv, (const int8_t*)q, (const int*)back_off, (int16_t*)backing,
               (uint8_t*)cells, (float*)best, (int*)tape, (int*)tlen, (int*)qend,
               (int*)n_backing)
}

// out[0..2]: problems (warps) a block holds, blocks an SM keeps resident,
// dynamic shared memory per block in bytes
extern "C" int vg_poa_local_warp_occupancy(int P, int W, int V, int* out) {
  if (W % 32 != 0 || W > 256 || V <= 0) return (int)cudaErrorInvalidValue;
  const int C = W / 32;
  VG_LW_SWITCH(occupancy, V, out)
}
