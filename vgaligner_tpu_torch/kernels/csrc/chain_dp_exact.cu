// Chaining DP, exact (f64) mode, for sm_90a.
//
// Replaces: vgaligner_tpu/ops/chain.py::chain_scores with precision
// "exact" (the f64 lax.scan of one_read, a device loop with no Pallas
// kernel; the reference's parity mode, chain.rs:274-655).  Bit-identical
// f, pred and curr_max.
//
// Recurrence over anchors sorted by target end (per read b), k = seed
// length, k_f = (double)k:
//   prop(j,i) = round3((f(j) + mlen) - gcost[gap]),
//     round3(x) = (y >= 0 ? floor(y + 0.5) : ceil(y - 0.5)) / 1000, y = x * 1000,
//     mlen = (double)min(ql, tl, k), ql = qb_i - qb_j,
//     tl = min(|tb_i - tb_j|, |te_i - te_j|), gap = |ql - tl|;
//   m(i) = max over i-bw <= j < i with ok(j,i) of prop, -DBL_MAX if none;
//   f(i) = m(i) if m(i) > k_f (strict) else k_f; pred(i) = the LARGEST j
//     at m(i) when it improved, else -1;
//   curr_max = max(0.0, every m(i)).
// ok(j,i): both anchors valid, qb_j < qb_i, te_j < te_i, gap <= max_gap.
// gcost is the host's f64 table (CPU libm log2), uploaded by the wrapper
// and never recomputed here.  Every f64 step is an explicit
// __dadd_rn/__dsub_rn/__dmul_rn/__ddiv_rn: nvcc would otherwise contract
// x*1000 + 0.5 into an FMA, whose single rounding changes bits, and the
// division must be a true IEEE divide, not a multiply by 1/1000.
//
// What bounds it on the card: as the fast kernel, a read's latency is A
// dependent steps of a bw-wide max/argmax; per pair a few f64 operations
// (one divide) and a table load.  No bandwidth to speak of.
//
// Design: K1's (chain_dp.cu).  One warp per read; lane l takes
// j = i-1-l, i-33-l, ...; a butterfly shuffle reduces (value, j) with the
// larger-j tie rule; the last bw values of f live in a per-warp shared
// ring written by lane 0.  The gap table sits in shared memory beside
// the rings (8 KB at max_gap 1,000); a table too large for that is read
// from device memory instead.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr size_t SMEM_TABLE_MAX = 160 * 1024;

__global__ void chain_dp_exact_kernel(const int* __restrict__ qb,
                                      const long long* __restrict__ tb,
                                      const long long* __restrict__ te,
                                      const uint8_t* __restrict__ valid,
                                      const double* __restrict__ gap_table, int B, int A,
                                      int k, int bw, int ring, int max_gap, int table_smem,
                                      double* __restrict__ f_out, int* __restrict__ pred_out,
                                      double* __restrict__ cmax_out) {
  extern __shared__ double smem[];
  const int n_tab = table_smem ? max_gap + 1 : 0;
  if (table_smem) {
    for (int g = threadIdx.x; g < n_tab; g += blockDim.x) smem[g] = gap_table[g];
  }
  __syncthreads();
  const double* gt = table_smem ? smem : gap_table;
  const int warp_in_block = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp_in_block;
  if (b >= B) return;  // uniform per warp
  double* fr = smem + n_tab + warp_in_block * ring;
  const size_t row = (size_t)b * A;
  const int* qbr = qb + row;
  const long long* tbr = tb + row;
  const long long* ter = te + row;
  const uint8_t* var = valid + row;
  const double k_f = (double)k;
  const int rmask = ring - 1;
  double cm = 0.0;
  for (int i = 0; i < A; ++i) {
    double best = -DBL_MAX;
    int bj = -1;
    if (var[i]) {
      const long long qbi = qbr[i], tbi = tbr[i], tei = ter[i];
      for (int r = lane; r < bw; r += 32) {
        const int j = i - 1 - r;
        if (j < 0) break;
        if (!var[j]) continue;
        const long long qbj = qbr[j], tej = ter[j];
        if (qbj >= qbi || tej >= tei) continue;
        const long long ql = qbi - qbj;
        const long long tl = min(llabs(tbi - tbr[j]), llabs(tei - tej));
        const long long gap = llabs(ql - tl);
        if (gap > max_gap) continue;
        const double mlen = (double)min(min(ql, tl), (long long)k);
        const double x = __dsub_rn(__dadd_rn(fr[j & rmask], mlen), gt[gap]);
        const double y = __dmul_rn(x, 1000.0);
        const double rr = y >= 0.0 ? floor(__dadd_rn(y, 0.5)) : ceil(__dsub_rn(y, 0.5));
        const double p = __ddiv_rn(rr, 1000.0);
        if (p > best || (p == best && j > bj)) {
          best = p;
          bj = j;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
      if (ob > best || (ob == best && oj > bj)) {
        best = ob;
        bj = oj;
      }
    }
    const bool improved = best > k_f;
    const double fi = improved ? best : k_f;
    cm = fmax(cm, best);
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

}  // namespace

extern "C" int vg_chain_dp_exact(const void* qb, const void* tb, const void* te,
                                 const void* valid, const void* gap_table, int B, int A,
                                 int k, int bw, int max_gap, void* f, void* pred, void* cmax,
                                 void* stream) {
  if (B <= 0 || A <= 0) return (int)cudaGetLastError();
  int ring = 32;
  while (ring < bw) ring <<= 1;
  const size_t ring_bytes = (size_t)WARPS * ring * sizeof(double);
  const size_t tab_bytes = (size_t)(max_gap + 1) * sizeof(double);
  const int table_smem = tab_bytes + ring_bytes <= SMEM_TABLE_MAX;
  const size_t smem = ring_bytes + (table_smem ? tab_bytes : 0);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(chain_dp_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const int grid = (B + WARPS - 1) / WARPS;
  chain_dp_exact_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int*)qb, (const long long*)tb, (const long long*)te, (const uint8_t*)valid,
      (const double*)gap_table, B, A, k, bw, ring, max_gap, table_smem, (double*)f,
      (int*)pred, (double*)cmax);
  return (int)cudaGetLastError();
}
