// Chaining DP, fast (scaled-integer) mode, for sm_90a.
//
// Replaces: vgaligner_tpu/ops/chain_pallas.py::_chain_kernel (launched by
// chain_dp_pallas), and the XLA scan it shares its outputs with
// (ops/chain.py::_chain_scores_fast).  Bit-identical f, pred and
// curr_max.
//
// Recurrence over anchors sorted by target end (per read b):
//   f(i) = max(k*1000, max_{i-bw <= j < i, ok(j,i)} f(j) + min(ql,tl,k)*1000 - gc(|ql-tl|))
//   pred(i) = the LARGEST j attaining the max when it exceeds k*1000, else -1
//   curr_max = max(0, every anchor's window max m), m = -2^30 when the
//              window holds no admissible predecessor
// ok(j,i): both anchors valid, qb_j < qb_i, te_j < te_i, |ql-tl| <= max_gap.
//
// What bounds it on the card: the DP is serial along anchors within a
// read (f(i) depends on f(i-1)), so a read's latency is A steps of a
// bw-wide max/argmax.  Work is tiny (about 40 integer and f32 ops per
// pair, 50 pairs per anchor); no device-memory bandwidth to speak of.
//
// Design: one warp per read.  The bw-row predecessor window is spread
// over the 32 lanes (lane l takes j = i-1-l, i-33-l, ...), each lane
// keeps its best (value, j), and a butterfly shuffle reduces them with
// the larger-j tie rule.  The last bw values of f live in a per-warp
// shared-memory ring, written by lane 0 and published by __syncwarp.
// Reads ride warps, so B = 4,096 reads fill the card many times over; a
// single huge read (A = 65,536) runs its A steps on one warp.
//
// The gap cost is computed per pair from a degree-7 f32 polynomial of
// log2 whose bits come from one IEEE rounding after every multiply and
// every add; nvcc would contract a*b+c into an FMA, so every step is an
// explicit __fmul_rn/__fadd_rn.  The coefficients are the f32 roundings
// of ops/chain.py's _LOG2_COEF, written as bit patterns.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEGI = -(1 << 30);

__device__ __forceinline__ int gap_cost_scaled(int gap, int k) {
  if (gap == 0) return 0;
  const float c0 = __uint_as_float(0x355a01e1u);
  const float c1 = __uint_as_float(0x3fb8a838u);
  const float c2 = __uint_as_float(0xbf385f32u);
  const float c3 = __uint_as_float(0x3ef18577u);
  const float c4 = __uint_as_float(0xbea4995cu);
  const float c5 = __uint_as_float(0x3e412de6u);
  const float c6 = __uint_as_float(0xbd9b7c1du);
  const float c7 = __uint_as_float(0x3c6f2e81u);
  const float gf = __int2float_rn(gap);
  const int bits = __float_as_int(gf);
  const int e = ((bits >> 23) & 0xFF) - 127;
  const float x = __int_as_float((bits & 0x7FFFFF) | (127 << 23));
  const float t = __fsub_rn(x, 1.0f);
  float acc = c7;
  acc = __fadd_rn(__fmul_rn(acc, t), c6);
  acc = __fadd_rn(__fmul_rn(acc, t), c5);
  acc = __fadd_rn(__fmul_rn(acc, t), c4);
  acc = __fadd_rn(__fmul_rn(acc, t), c3);
  acc = __fadd_rn(__fmul_rn(acc, t), c2);
  acc = __fadd_rn(__fmul_rn(acc, t), c1);
  acc = __fadd_rn(__fmul_rn(acc, t), c0);
  const float lg2 = __fadd_rn(__int2float_rn(e), acc);
  const float y = __fadd_rn(__fmul_rn(500.0f, lg2), 0.5f);
  const int lg = __float2int_rz(floorf(y));
  return 10 * k * gap + lg;
}

__global__ void chain_dp_kernel(const int* __restrict__ qb, const int* __restrict__ tb,
                                const int* __restrict__ te,
                                const uint8_t* __restrict__ valid, int B, int A,
                                int k, int bw, int ring, int max_gap,
                                int* __restrict__ f_out, int* __restrict__ pred_out,
                                int* __restrict__ cmax_out) {
  extern __shared__ int ring_smem[];
  const int warp_in_block = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp_in_block;
  if (b >= B) return;  // uniform per warp
  int* fr = ring_smem + warp_in_block * ring;
  const size_t row = (size_t)b * A;
  const int* qbr = qb + row;
  const int* tbr = tb + row;
  const int* ter = te + row;
  const uint8_t* var = valid + row;
  const int k_i = k * 1000;
  const int rmask = ring - 1;
  int cm = 0;
  for (int i = 0; i < A; ++i) {
    int best = NEGI;
    int bj = -1;
    if (var[i]) {
      const int qbi = qbr[i], tbi = tbr[i], tei = ter[i];
      for (int r = lane; r < bw; r += 32) {
        const int j = i - 1 - r;
        if (j < 0) break;
        if (!var[j]) continue;
        const int qbj = qbr[j], tej = ter[j];
        if (qbj >= qbi || tej >= tei) continue;
        const int ql = qbi - qbj;
        const int tl = min(abs(tbi - tbr[j]), abs(tei - tej));
        const int gap = abs(ql - tl);
        if (gap > max_gap) continue;
        const int mlen = min(min(ql, tl), k) * 1000;
        const int p = fr[j & rmask] + (mlen - gap_cost_scaled(gap, k));
        if (p > best || (p == best && j > bj)) {
          best = p;
          bj = j;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
      if (ob > best || (ob == best && oj > bj)) {
        best = ob;
        bj = oj;
      }
    }
    const bool improved = best > k_i;
    const int fi = improved ? best : k_i;
    cm = max(cm, best);
    __syncwarp();  // every lane has read the ring before it is overwritten
    if (lane == 0) {
      fr[i & rmask] = fi;
      f_out[row + i] = fi;
      pred_out[row + i] = improved ? bj : -1;
    }
    __syncwarp();  // publish f(i) to the other lanes
  }
  if (lane == 0) cmax_out[b] = cm;
}

__global__ void gap_cost_kernel(const int* __restrict__ gaps, int n, int k,
                                int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = gap_cost_scaled(gaps[i], k);
}

}  // namespace

extern "C" int vg_chain_dp(const void* qb, const void* tb, const void* te,
                           const void* valid, int B, int A, int k, int bw,
                           int max_gap, void* f, void* pred, void* cmax,
                           void* stream) {
  if (B <= 0 || A <= 0) return (int)cudaGetLastError();
  int ring = 32;
  while (ring < bw) ring <<= 1;
  const int warps = 4;
  const size_t smem = (size_t)warps * ring * sizeof(int);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(chain_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const int grid = (B + warps - 1) / warps;
  chain_dp_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const int*)qb, (const int*)tb, (const int*)te, (const uint8_t*)valid, B, A, k,
      bw, ring, max_gap, (int*)f, (int*)pred, (int*)cmax);
  return (int)cudaGetLastError();
}

extern "C" int vg_chain_gap_cost(const void* gaps, int n, int k, void* out,
                                 void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  gap_cost_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const int*)gaps, n, k, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* vg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
