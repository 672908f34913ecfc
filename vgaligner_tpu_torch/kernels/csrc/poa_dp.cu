// Global partial-order alignment DP, for sm_90a.
//
// Replaces: vgaligner_tpu/ops/poa_pallas2.py::_poa_dp_kernel2 (launched
// by poa_dp_pallas2 from ops/poa_device.py::poa_global_kernel_packed),
// whose outputs equal ops/poa_device.py::poa_dp_xla.  Bit-identical
// score, best_sink, and tbits over every row v < nv[b].
//
// Per problem b: a base-level DAG of nv[b] vertices in topological
// order, each with up to P predecessor slots (-1 = dead), aligned
// globally against the query q[b, :nq[b]] with abPOA's defaults (match
// 2, mismatch -4, N always mismatches, two-piece gaps 4+2g and 24+g).
// Row V of the state is the virtual source: H = init_row, E1 = E2 = NEGF.
// For each vertex v and column j (W = L + 1 columns):
//   E1/E2 (graph gaps): per slot max(H_p - (o+e), E_p - e); the first
//     slot at the column max, and whether open >= extend there;
//   M: per slot H_p[j-1] + sub(q[j-1], code[v]) (NEGF at j = 0);
//   h_pre = max(M, E1, E2), ties M > E1 > E2;
//   F1/F2 (in-row gaps) in closed form: c = inclusive prefix max of
//     h_pre + e*j, F[j] = (c[j-1] - o) - e*j, F[0] = NEGF;
//   H = max(h_pre, F1, F2), ties h_pre > F1 > F2;
//   19 decision bits per cell (layout in ops/poa_device.py), a slot that
//     is not a live predecessor stored as 15 (virtual source).
// The best sink is the first v < nv with is_sink at the column-nq max
// (argmax over all V with NEGF for non-candidates).
//
// Arithmetic is f32 with NEGF = -1e9 in the JAX op order.  Near NEGF f32
// spacing is 64, so unreachable cells round, and the open >= extend bits
// there depend on doing exactly these f32 operations; every product is
// an exact small integer, so FMA contraction could not change a value,
// but each step is written __fadd_rn/__fsub_rn regardless.
//
// What bounds it on the card: the vertex loop is serial (row v reads
// rows of its predecessors), so a problem's latency is nv steps of a
// W-wide row update with two block-wide prefix-max scans.  Each step
// reads P predecessor rows (4 floats per slot per column) and writes 3W
// floats of state plus W decision words: about (16P + 16) bytes per cell
// of device-memory traffic, most of it L2-resident for the recent rows.
//
// Design: one block per problem, one thread per column (W <= 1024), and
// the H/E1/E2 state in a global scratch [B, V+1, 3W] f32 that the
// wrapper allocates.  The two prefix maxima are a warp shuffle scan plus
// a scan of the warp totals in shared memory.  Problems ride blocks, so a
// chunk of B = 1,024 problems keeps every SM busy.  The TPU kernel's row
// ring, pinned far rows, meta plane and uniform-slot tags answer VMEM
// limits and are not carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEGF = -1.0e9f;
constexpr float MATCH = 2.0f;
constexpr float MISMATCH = -4.0f;
constexpr float O1 = 4.0f, E1 = 2.0f, O2 = 24.0f, E2 = 1.0f;
constexpr int VIRT_SLOT = 15;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

template <int P>
__global__ void poa_dp_kernel(const int8_t* __restrict__ vcodes,
                              const int* __restrict__ vpred,
                              const uint8_t* __restrict__ is_sink,
                              const int* __restrict__ nv, const int8_t* __restrict__ q,
                              const int* __restrict__ nq,
                              const float* __restrict__ init_row, int V, int L,
                              float* __restrict__ S, float* __restrict__ score,
                              int* __restrict__ best_sink, int* __restrict__ tbits) {
  __shared__ float wt1[32], wt2[32];
  __shared__ float cs1[1024], cs2[1024], hrow[1024];
  const int W = L + 1;
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarps = blockDim.x >> 5;
  const int nvb = nv[b];
  const size_t rs = 3 * (size_t)W;  // state row stride
  float* Sb = S + (size_t)b * (V + 1) * rs;

  for (int v = 0; v < nvb; ++v) {
    float* row = Sb + v * rs;
    row[j] = NEGF;
    row[W + j] = NEGF;
    row[2 * W + j] = NEGF;
  }
  {
    float* src = Sb + V * rs;
    src[j] = init_row[j];
    src[W + j] = NEGF;
    src[2 * W + j] = NEGF;
  }
  __syncthreads();

  const int qj = j >= 1 ? (int)q[(size_t)b * L + j - 1] : 4;
  const float jf = __int2float_rn(j);
  const float e1j = __fmul_rn(E1, jf), e2j = __fmul_rn(E2, jf);
  const float oe1 = O1 + E1, oe2 = O2 + E2;

  for (int v = 0; v < nvb; ++v) {
    const int* pv = vpred + ((size_t)b * V + v) * P;
    int preds[P];
#pragma unroll
    for (int p = 0; p < P; ++p) preds[p] = pv[p];
    const bool has_any = preds[0] >= 0;
    const int vcode = vcodes[(size_t)b * V + v];
    float sub = (qj == vcode) ? MATCH : MISMATCH;
    if (qj >= 4 || vcode >= 4) sub = MISMATCH;

    float best1 = 0.f, best2 = 0.f, mbest = 0.f;
    int slot1 = 0, slot2 = 0, mslot = 0;
    bool opn1 = false, opn2 = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool real = preds[p] >= 0;
      const bool live = real || (p == 0 && !has_any);
      const float* prow = Sb + (real ? preds[p] : V) * rs;
      const float hp = live ? prow[j] : NEGF;
      const float hpm = live && j >= 1 ? prow[j - 1] : NEGF;
      const float e1p = real ? prow[W + j] : NEGF;
      const float e2p = real ? prow[2 * W + j] : NEGF;
      const float open1 = __fsub_rn(hp, oe1), ext1 = __fsub_rn(e1p, E1);
      const float open2 = __fsub_rn(hp, oe2), ext2 = __fsub_rn(e2p, E2);
      const float cand1 = fmaxf(open1, ext1), cand2 = fmaxf(open2, ext2);
      const float mc = j >= 1 ? __fadd_rn(hpm, sub) : NEGF;
      if (p == 0 || cand1 > best1) {
        best1 = cand1;
        slot1 = p;
        opn1 = open1 >= ext1;
      }
      if (p == 0 || cand2 > best2) {
        best2 = cand2;
        slot2 = p;
        opn2 = open2 >= ext2;
      }
      if (p == 0 || mc > mbest) {
        mbest = mc;
        mslot = p;
      }
    }
    const float mx12 = fmaxf(best1, best2);
    const float h_pre = fmaxf(mbest, mx12);
    const int case_pre = mbest >= mx12 ? 0 : (best1 >= best2 ? 1 : 2);

    // inclusive prefix max of h_pre + e*j over the row (F1 and F2 at once)
    float a1 = __fadd_rn(h_pre, e1j), a2 = __fadd_rn(h_pre, e2j);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o1 = __shfl_up_sync(0xffffffffu, a1, off);
      const float o2 = __shfl_up_sync(0xffffffffu, a2, off);
      if (lane >= off) {
        a1 = fmaxf(a1, o1);
        a2 = fmaxf(a2, o2);
      }
    }
    if (lane == 31) {
      wt1[warp] = a1;
      wt2[warp] = a2;
    }
    __syncthreads();
    if (warp == 0) {
      float x1 = lane < nwarps ? wt1[lane] : neg_inf();
      float x2 = lane < nwarps ? wt2[lane] : neg_inf();
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o1 = __shfl_up_sync(0xffffffffu, x1, off);
        const float o2 = __shfl_up_sync(0xffffffffu, x2, off);
        if (lane >= off) {
          x1 = fmaxf(x1, o1);
          x2 = fmaxf(x2, o2);
        }
      }
      if (lane < nwarps) {
        wt1[lane] = x1;
        wt2[lane] = x2;
      }
    }
    __syncthreads();
    if (warp > 0) {
      a1 = fmaxf(a1, wt1[warp - 1]);
      a2 = fmaxf(a2, wt2[warp - 1]);
    }
    cs1[j] = a1;
    cs2[j] = a2;
    __syncthreads();
    const float f1 = j >= 1 ? __fsub_rn(__fsub_rn(cs1[j - 1], O1), e1j) : NEGF;
    const float f2 = j >= 1 ? __fsub_rn(__fsub_rn(cs2[j - 1], O2), e2j) : NEGF;
    const float h = fmaxf(h_pre, fmaxf(f1, f2));
    const int cas = h <= h_pre ? case_pre : (h == f1 ? 3 : 4);
    hrow[j] = h;
    __syncthreads();
    const float prev_h = j >= 1 ? hrow[j - 1] : NEGF;
    const bool f1o = f1 == __fsub_rn(prev_h, oe1);
    const bool f2o = f2 == __fsub_rn(prev_h, oe2);

    const int ms = preds[mslot] >= 0 ? mslot : VIRT_SLOT;
    const int s1 = preds[slot1] >= 0 ? slot1 : VIRT_SLOT;
    const int s2 = preds[slot2] >= 0 ? slot2 : VIRT_SLOT;
    tbits[((size_t)b * V + v) * W + j] =
        cas | (ms << 3) | ((int)opn1 << 7) | (s1 << 8) | ((int)opn2 << 12) |
        (s2 << 13) | ((int)f1o << 17) | ((int)f2o << 18);
    float* out = Sb + v * rs;
    out[j] = h;
    out[W + j] = best1;
    out[2 * W + j] = best2;
    __syncthreads();  // row v visible to later rows; shared buffers free
  }

  if (j == 0) {
    const int col = nq[b];
    float best = neg_inf();
    int bv = 0;
    for (int v = 0; v < V; ++v) {
      const bool cand = v < nvb && is_sink[(size_t)b * V + v];
      const float s = cand ? Sb[v * rs + col] : NEGF;
      if (s > best) {
        best = s;
        bv = v;
      }
      if (v >= nvb) break;  // every later vertex is a NEGF non-candidate
    }
    score[b] = best;
    best_sink[b] = bv;
  }
}

}  // namespace

extern "C" int vg_poa_dp(const void* vcodes, const void* vpred, const void* is_sink,
                         const void* nv, const void* q, const void* nq,
                         const void* init_row, int B, int V, int P, int L, void* S,
                         void* score, void* best_sink, void* tbits, void* stream) {
  const int W = L + 1;
  if (B <= 0) return (int)cudaGetLastError();
  if (W % 32 != 0 || W > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define VG_POA_LAUNCH(PP)                                                          \
  poa_dp_kernel<PP><<<B, W, 0, st>>>(                                              \
      (const int8_t*)vcodes, (const int*)vpred, (const uint8_t*)is_sink,           \
      (const int*)nv, (const int8_t*)q, (const int*)nq, (const float*)init_row, V, \
      L, (float*)S, (float*)score, (int*)best_sink, (int*)tbits)
  switch (P) {
    case 2: VG_POA_LAUNCH(2); break;
    case 4: VG_POA_LAUNCH(4); break;
    case 8: VG_POA_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef VG_POA_LAUNCH
  return (int)cudaGetLastError();
}
