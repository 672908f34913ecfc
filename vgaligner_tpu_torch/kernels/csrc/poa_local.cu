// Local gapless partial-order alignment (rspoa engine), DP + traceback,
// for sm_90a.
//
// Replaces: vgaligner_tpu/ops/poa_device.py::poa_local_kernel, a device
// loop (an XLA fori_loop over vertices, then a scan for the traceback)
// with no Pallas kernel.  Bit-identical best, tape[b, :tlen[b]], tlen
// and qend.
//
// Per problem b: a base-level DAG of nv[b] vertices in topological
// order with up to P predecessor slots (-1 = dead), against the query
// q[b, :L] (padding code 4 always mismatches).  Row V of H is a virtual
// all-zero row that dead slots read.  For vertex v and column j:
//   cand_p[j] = H[pred_p][j-1] for a live slot, 0 for a dead one, 0 at j = 0;
//   m_best = max(max_p cand_p, 0); slot = the first live slot at m_best
//     when m_best > 0, else 15 (a slot >= P is also 15);
//   row[0] = 0, row[j] = max(m_best[j] + sub(q[j-1], code[v]), 0);
//   cell byte = slot | (row > 0) << 4.
// The loop runs to the batch max nv; a row v >= nv[b] is stored in H as
// 0, but its cell bytes are still written.  best is the largest row
// value over v < nv[b] (0 if none is positive); (bv, bj) is the first
// row whose max reaches it and the first column at that max, i.e. the
// first cell of the best value in (v, j) scan order.  The traceback then
// walks at most L+1 match steps from (bv, bj): each writes
// OP_M | (v + 2) << 2 and moves to the stored slot's predecessor (the
// virtual source is v = -2) and j - 1; it stops at j = 0, at a cell
// whose row value is 0, or past the virtual source.  The other entries
// of the L+1 tape hold OP_END | 1 << 2; tlen counts the written ones
// and qend = bj.
//
// Every value is a small integer (|row| <= 2L), so the f32 H of the JAX
// version is exact and the kernel's f32 arithmetic gives its values bit
// for bit, in any order.
//
// What bounds it on the card: as the global DP, the vertex loop is
// serial, a W-wide row per step, reading P predecessor rows (4 bytes per
// slot per column) and writing 5 bytes per cell; the traceback is a
// chain of at most L+1 dependent loads.
//
// Design: one block per problem, columns spread over threads as in
// poa_dp.cu (one per thread up to W = 1,024, then C = W / 1,024 each).
// H lives in a global zeroed [B, V+1, W] f32 scratch (predecessors can be
// far back, so no ring) and the cells in a zeroed u8 plane [B, V, W].
// Instead of an arg-max per row, each thread keeps the first cell at its
// own best value in scan order, strict improvements only; one block
// reduction at the end (larger value, then smaller v, then smaller j)
// gives the same cell as the row-by-row rule.  Thread 0 then walks the
// traceback.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float MATCH = 2.0f;
constexpr float MISMATCH = -4.0f;
constexpr int VIRT_SLOT = 15;
constexpr int OP_M = 0, OP_END = 3;
constexpr int END_FILL = OP_END | (1 << 2);

// (value a at cell (av, aj)) wins over (value b at (bv, bj)): the larger
// value, then the earlier cell in (v, j) scan order
__device__ __forceinline__ bool before(float a, int av, int aj, float b, int bv, int bj) {
  if (a != b) return a > b;
  if (av != bv) return av < bv;
  return aj < bj;
}

template <int P>
__global__ void __launch_bounds__(1024)
    poa_local_kernel(const int8_t* __restrict__ vcodes, const int* __restrict__ vpred,
                     const int* __restrict__ nv, const int8_t* __restrict__ q, int B,
                     int V, int L, int C, float* __restrict__ H,
                     uint8_t* __restrict__ cells, float* __restrict__ best_out,
                     int* __restrict__ tape, int* __restrict__ tlen,
                     int* __restrict__ qend) {
  __shared__ int nv_max_s;
  __shared__ float rb[32];
  __shared__ int rv[32], rj[32];
  const int W = L + 1;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const int j0 = t * C;
  const int nvb = nv[b];
  float* Hb = H + (size_t)b * (V + 1) * W;
  uint8_t* cb = cells + (size_t)b * V * W;
  const int8_t* qb = q + (size_t)b * L;

  if (t == 0) nv_max_s = 0;
  __syncthreads();
  {
    int m = 0;
    for (int i = t; i < B; i += blockDim.x) m = max(m, nv[i]);
    atomicMax(&nv_max_s, m);
  }
  __syncthreads();
  const int nv_max = nv_max_s;

  float tbest = 0.f;
  int tv = 0, tj = 0;
  for (int v = 0; v < nv_max; ++v) {
    const int* pv = vpred + ((size_t)b * V + v) * P;
    int preds[P];
#pragma unroll
    for (int p = 0; p < P; ++p) preds[p] = pv[p];
    const int vcode = vcodes[(size_t)b * V + v];
    const bool in_range = v < nvb;
    float* hrow = Hb + (size_t)v * W;
    uint8_t* crow = cb + (size_t)v * W;
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      float m_best = 0.f;
      int slot = P;
      if (j >= 1) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (preds[p] >= 0) {
            const float cand = Hb[(size_t)preds[p] * W + j - 1];
            m_best = fmaxf(m_best, cand);
          }
        }
#pragma unroll
        for (int p = P - 1; p >= 0; --p) {
          if (preds[p] >= 0 && Hb[(size_t)preds[p] * W + j - 1] == m_best) slot = p;
        }
      }
      if (!(m_best > 0.f) || slot >= P) slot = VIRT_SLOT;
      float row = 0.f;
      if (j >= 1) {
        const int qj = qb[j - 1];
        const float sub = (qj == vcode && qj < 4 && vcode < 4) ? MATCH : MISMATCH;
        row = fmaxf(m_best + sub, 0.f);
      }
      crow[j] = (uint8_t)(slot | ((row > 0.f) << 4));
      hrow[j] = in_range ? row : 0.f;
      if (in_range && row > tbest) {
        tbest = row;
        tv = v;
        tj = j;
      }
    }
    __syncthreads();  // row v visible to later rows
  }

  // block reduction of (value, v, j): larger value, then earlier cell
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, tbest, off);
    const int ov = __shfl_xor_sync(0xffffffffu, tv, off);
    const int oj = __shfl_xor_sync(0xffffffffu, tj, off);
    if (before(ob, ov, oj, tbest, tv, tj)) {
      tbest = ob;
      tv = ov;
      tj = oj;
    }
  }
  if (lane == 0) {
    rb[warp] = tbest;
    rv[warp] = tv;
    rj[warp] = tj;
  }
  __syncthreads();
  if (t != 0) return;
  float best = rb[0];
  int bv = rv[0], bj = rj[0];
  for (int w = 1; w < nwarps; ++w) {
    if (before(rb[w], rv[w], rj[w], best, bv, bj)) {
      best = rb[w];
      bv = rv[w];
      bj = rj[w];
    }
  }

  // traceback: match steps only, until the zero floor or j == 0
  const int T = L + 1;
  int* tp = tape + (size_t)b * T;
  int n = 0, v = bv, j = bj;
  for (; n < T; ++n) {
    if (v < 0 || j <= 0) break;
    const int vc = min(v, V - 1);
    const int bits = cb[(size_t)vc * W + j];
    if ((bits >> 4) == 0) break;
    tp[n] = OP_M | ((v + 2) << 2);
    const int slot = bits & 15;
    v = slot == VIRT_SLOT ? -2 : vpred[((size_t)b * V + vc) * P + min(slot, P - 1)];
    j -= 1;
  }
  for (int i = n; i < T; ++i) tp[i] = END_FILL;
  best_out[b] = best;
  tlen[b] = n;
  qend[b] = bj;
}

}  // namespace

extern "C" int vg_poa_local(const void* vcodes, const void* vpred, const void* nv,
                            const void* q, int B, int V, int P, int L, void* H,
                            void* cells, void* best, void* tape, void* tlen, void* qend,
                            void* stream) {
  const int W = L + 1;
  if (B <= 0) return (int)cudaGetLastError();
  int threads, C;
  if (W % 32 == 0 && W <= 1024) {
    threads = W;
    C = 1;
  } else if (W % 1024 == 0) {
    threads = 1024;
    C = W / 1024;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
#define VG_LOCAL_LAUNCH(PP)                                                             \
  poa_local_kernel<PP><<<B, threads, 0, st>>>(                                          \
      (const int8_t*)vcodes, (const int*)vpred, (const int*)nv, (const int8_t*)q, B, V, \
      L, C, (float*)H, (uint8_t*)cells, (float*)best, (int*)tape, (int*)tlen, (int*)qend)
  switch (P) {
    case 2: VG_LOCAL_LAUNCH(2); break;
    case 4: VG_LOCAL_LAUNCH(4); break;
    case 8: VG_LOCAL_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef VG_LOCAL_LAUNCH
  return (int)cudaGetLastError();
}
