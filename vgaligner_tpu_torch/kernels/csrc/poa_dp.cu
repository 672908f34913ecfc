// Global partial-order alignment DP, for sm_90a.
//
// Replaces: vgaligner_tpu/ops/poa_pallas2.py::_poa_dp_kernel2 (launched
// by poa_dp_pallas2 from ops/poa_device.py::poa_global_kernel_packed)
// and vgaligner_tpu/ops/poa_pallas.py::_poa_dp_kernel (poa_dp_pallas,
// launched by poa_global_kernel; the port runs that contract on this
// kernel at the lane-padded width), whose outputs equal
// ops/poa_device.py::poa_dp_xla.  Bit-identical score, best_sink, and
// tbits over every row v < nv[b].
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
// but each step is written __fadd_rn/__fsub_rn regardless.  The prefix
// maxima are exact in any order, so their scan order is free.
//
// What bounds it on the card: the vertex loop is serial (row v reads
// rows of its predecessors), so a problem's latency is nv steps of a
// W-wide row update with one block-wide prefix-max scan.  Each step
// reads P predecessor rows (4 floats per slot per column) and writes 3W
// floats of state plus W decision words: about (16P + 16) bytes per cell
// of device-memory traffic, most of it L2-resident for the recent rows.
//
// Design: one block per problem.  Up to W = 1,024 one thread per
// column; above it 1,024 threads that each own C = W / 1,024 (2/4/8/16)
// consecutive columns, up to W = 16,384 (reads of 16,383 bp).  A row is
// three phases: (A) each thread computes h_pre and the slot bits of its
// columns from the predecessor rows and its running max of h_pre + e*j;
// (B) a block scan of those thread totals (warp shuffles, then the warp
// totals in shared memory) gives each thread the prefix max of all
// earlier columns, from which it finishes F, H and the case of its own
// columns and writes the row; (C) the F-open bit of a thread's first
// column needs H of the column before it, which the previous thread left
// in shared memory.  The state H/E1/E2 lives in a global scratch
// [B, V+1, 3W] f32 that the wrapper allocates; the row is written only
// after the scan barrier, when every thread has read its predecessors.
// __launch_bounds__(1024) holds registers to 64 a thread so that any
// block size launches; at C = 16 the per-column arrays spill to local
// memory.  Problems ride blocks, so a chunk of B = 1,024 problems keeps
// every SM busy.  The TPU kernel's row ring, pinned far rows, meta plane
// and uniform-slot tags answer VMEM limits and are not carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEGF = -1.0e9f;
constexpr float MATCH = 2.0f;
constexpr float MISMATCH = -4.0f;
constexpr float O1 = 4.0f, E1 = 2.0f, O2 = 24.0f, E2 = 1.0f;
constexpr int VIRT_SLOT = 15;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

template <int P, int C>
__global__ void __launch_bounds__(1024)
    poa_dp_kernel(const int8_t* __restrict__ vcodes, const int* __restrict__ vpred,
                  const uint8_t* __restrict__ is_sink, const int* __restrict__ nv,
                  const int8_t* __restrict__ q, const int* __restrict__ nq,
                  const float* __restrict__ init_row, int V, int L,
                  float* __restrict__ S, float* __restrict__ score,
                  int* __restrict__ best_sink, int* __restrict__ tbits) {
  __shared__ float wt1[32], wt2[32], hlast[1024];
  const int W = L + 1;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int j0 = t * C;
  const int lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const int nvb = nv[b];
  const size_t rs = 3 * (size_t)W;  // state row stride
  float* Sb = S + (size_t)b * (V + 1) * rs;
  const float oe1 = O1 + E1, oe2 = O2 + E2;

  for (int v = 0; v < nvb; ++v) {
    float* row = Sb + v * rs;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      row[j0 + c] = NEGF;
      row[W + j0 + c] = NEGF;
      row[2 * W + j0 + c] = NEGF;
    }
  }
  {
    float* src = Sb + V * rs;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      src[j0 + c] = init_row[j0 + c];
      src[W + j0 + c] = NEGF;
      src[2 * W + j0 + c] = NEGF;
    }
  }
  __syncthreads();

  for (int v = 0; v < nvb; ++v) {
    const int* pv = vpred + ((size_t)b * V + v) * P;
    int preds[P];
#pragma unroll
    for (int p = 0; p < P; ++p) preds[p] = pv[p];
    const bool has_any = preds[0] >= 0;
    const int vcode = vcodes[(size_t)b * V + v];

    // (A) h_pre, E1/E2 and the pre-F bits of this thread's columns
    float hpre[C], b1[C], b2[C];
    int pbits[C];
    float t1 = neg_inf(), t2 = neg_inf();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const int qj = j >= 1 ? (int)q[(size_t)b * L + j - 1] : 4;
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
      const int ms = preds[mslot] >= 0 ? mslot : VIRT_SLOT;
      const int s1 = preds[slot1] >= 0 ? slot1 : VIRT_SLOT;
      const int s2 = preds[slot2] >= 0 ? slot2 : VIRT_SLOT;
      hpre[c] = h_pre;
      b1[c] = best1;
      b2[c] = best2;
      pbits[c] = case_pre | (ms << 3) | ((int)opn1 << 7) | (s1 << 8) | ((int)opn2 << 12) |
                 (s2 << 13);
      const float jf = __int2float_rn(j);
      t1 = fmaxf(t1, __fadd_rn(h_pre, __fmul_rn(E1, jf)));
      t2 = fmaxf(t2, __fadd_rn(h_pre, __fmul_rn(E2, jf)));
    }

    // (B) exclusive prefix max of the thread totals over the block
    float a1 = t1, a2 = t2;
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
    float r1 = __shfl_up_sync(0xffffffffu, a1, 1);
    float r2 = __shfl_up_sync(0xffffffffu, a2, 1);
    if (lane == 0) {
      r1 = neg_inf();
      r2 = neg_inf();
    }
    if (warp > 0) {
      r1 = fmaxf(r1, wt1[warp - 1]);
      r2 = fmaxf(r2, wt2[warp - 1]);
    }

    // F, H and the case of each column; r1/r2 = c[j-1] on entry to column j
    float* out = Sb + v * rs;
    int* tb = tbits + ((size_t)b * V + v) * W;
    float f1_first = NEGF, f2_first = NEGF, prev_h = NEGF;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const float jf = __int2float_rn(j);
      const float e1j = __fmul_rn(E1, jf), e2j = __fmul_rn(E2, jf);
      const float f1 = j >= 1 ? __fsub_rn(__fsub_rn(r1, O1), e1j) : NEGF;
      const float f2 = j >= 1 ? __fsub_rn(__fsub_rn(r2, O2), e2j) : NEGF;
      r1 = fmaxf(r1, __fadd_rn(hpre[c], e1j));
      r2 = fmaxf(r2, __fadd_rn(hpre[c], e2j));
      const float h = fmaxf(hpre[c], fmaxf(f1, f2));
      const int cas = h <= hpre[c] ? (pbits[c] & 7) : (h == f1 ? 3 : 4);
      pbits[c] = (pbits[c] & ~7) | cas;
      if (c == 0) {
        f1_first = f1;
        f2_first = f2;
      } else {
        const bool f1o = f1 == __fsub_rn(prev_h, oe1);
        const bool f2o = f2 == __fsub_rn(prev_h, oe2);
        tb[j] = pbits[c] | ((int)f1o << 17) | ((int)f2o << 18);
      }
      out[j] = h;
      out[W + j] = b1[c];
      out[2 * W + j] = b2[c];
      prev_h = h;
    }
    hlast[t] = prev_h;
    __syncthreads();

    // (C) the first column's F-open bits need H of the previous column
    {
      const float ph = t >= 1 ? hlast[t - 1] : NEGF;
      const bool f1o = f1_first == __fsub_rn(ph, oe1);
      const bool f2o = f2_first == __fsub_rn(ph, oe2);
      tb[j0] = pbits[0] | ((int)f1o << 17) | ((int)f2o << 18);
    }
    __syncthreads();  // row v visible to later rows; shared buffers free
  }

  if (t == 0) {
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

template <int P>
cudaError_t launch_p(int C, int B, int threads, cudaStream_t st, const int8_t* vcodes,
                     const int* vpred, const uint8_t* is_sink, const int* nv,
                     const int8_t* q, const int* nq, const float* init_row, int V, int L,
                     float* S, float* score, int* best_sink, int* tbits) {
#define VG_POA_LAUNCH(CC)                                                               \
  poa_dp_kernel<P, CC><<<B, threads, 0, st>>>(vcodes, vpred, is_sink, nv, q, nq,       \
                                               init_row, V, L, S, score, best_sink, tbits)
  switch (C) {
    case 1: VG_POA_LAUNCH(1); break;
    case 2: VG_POA_LAUNCH(2); break;
    case 4: VG_POA_LAUNCH(4); break;
    case 8: VG_POA_LAUNCH(8); break;
    case 16: VG_POA_LAUNCH(16); break;
    default: return cudaErrorInvalidValue;
  }
#undef VG_POA_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" int vg_poa_dp(const void* vcodes, const void* vpred, const void* is_sink,
                         const void* nv, const void* q, const void* nq,
                         const void* init_row, int B, int V, int P, int L, void* S,
                         void* score, void* best_sink, void* tbits, void* stream) {
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
  const int8_t* vc = (const int8_t*)vcodes;
  const int* vp = (const int*)vpred;
  const uint8_t* sk = (const uint8_t*)is_sink;
  const int* n = (const int*)nv;
  const int8_t* qq = (const int8_t*)q;
  const int* nqq = (const int*)nq;
  const float* ir = (const float*)init_row;
  cudaError_t rc;
  switch (P) {
    case 2: rc = launch_p<2>(C, B, threads, st, vc, vp, sk, n, qq, nqq, ir, V, L, (float*)S,
                             (float*)score, (int*)best_sink, (int*)tbits); break;
    case 4: rc = launch_p<4>(C, B, threads, st, vc, vp, sk, n, qq, nqq, ir, V, L, (float*)S,
                             (float*)score, (int*)best_sink, (int*)tbits); break;
    case 8: rc = launch_p<8>(C, B, threads, st, vc, vp, sk, n, qq, nqq, ir, V, L, (float*)S,
                             (float*)score, (int*)best_sink, (int*)tbits); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)rc;
}
