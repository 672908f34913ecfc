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
//     round3(x) = rr / 1000, rr = (y >= 0 ? floor(y + 0.5) : ceil(y - 0.5)),
//     y = x * 1000, mlen = (double)min(ql, tl, k), ql = qb_i - qb_j,
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
// One divide a row (DIV_ONCE).  The lanes compare rr, the integer-valued
// double before the divide, with the larger-j tie rule, and only the
// winner is divided.  A lane packs each pair into one integer key,
// (rr + 2^41 + 1) << 21 | j, whose maximum is the winner under that
// rule; the warp reduces it with two redux.sync maxima (high word, then
// low word among the lanes at the high maximum).  That gives the same j
// and the same value because a -> fl(a / 1000) is strictly increasing on
// the integers |a| <= 2^42:
// the quotient is below 2^33 in magnitude, so its ulp is at most 2^-20,
// and fl(a / 1000) and fl((a + 1) / 1000), each within half an ulp of
// its exact quotient, lie at least 0.001 - 2^-20 > 0 apart.  With a
// table of finite gcost >= 0, |rr| is at most 1000 (A (k + 1) + 2k +
// max gcost) + 1 (every f is at most k + A (k + 0.001), every x at least
// k - max gcost); the wrapper takes this path only when that is below
// 2^41, A <= 2^21 and the table is finite and nonnegative, and otherwise
// the per-pair-divide path, the same kernel with DIV_ONCE false, which
// divides every pair as the plain twin does.
//
// What bounds it on the card: a read's latency, one dependent step per
// anchor row; per pair a few f64 operations and a table load.  No
// bandwidth to speak of.  The design attacks the serial step:
//
//  * a warp owns one read; lane l takes j = i-1-l, i-1-l-32, ...
//    (8 and 16 lanes a read, with a butterfly reduction, were slower on
//    the H100 from the final design on: PERF.md);
//  * the last valid anchor: before the loop the lanes find it
//    (invalid anchors are sorted last, but nothing here assumes that
//    valid anchors form a prefix) and write f = k, pred = -1 to every
//    later row in parallel, which is what the recurrence gives an
//    invalid anchor; the serial loop stops after the last valid row;
//  * the f-independent pair terms (ok, mlen and the gap index) are
//    computed for a block of RB rows in parallel and packed into one
//    32-bit word a pair in shared memory, gap << 8 | mlen, or ~0 for a
//    pair that is not ok (the wrapper checks k <= 255 and
//    max_gap < 2^24 - 1); the serial step is then only the f-dependent
//    add, round and compare.  The block's anchors (rows i0 - bw to
//    i0 + RB) are first copied into shared memory with every load in
//    flight at once, so a row pays one device-memory round trip per
//    block, not several: with loads from device memory in the term loop
//    a lone read took about 1.1 us a row on the H100;
//  * the last bw + 1 values of f live in a ring of shared memory (a
//    power of two above bw, so the slot written at row i is never one a
//    lane still reads); one __syncwarp a row publishes f(i);
//  * an invalid row costs no pair and no reduction;
//  * the gap table sits in shared memory beside the rings and term
//    blocks (8 KB at max_gap 1,000); a table too large for that is read
//    from device memory instead.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr size_t SMEM_MAX = 200 * 1024;
constexpr unsigned NONE = 0xffffffffu;  // a pair that is not ok
constexpr unsigned FULL = 0xffffffffu;
constexpr int J_BITS = 21;                           // j < 2^21 in a row's key
constexpr long long KEY_OFF = (1LL << 41) + 1;       // rr + KEY_OFF in [1, 2^42)

// doubles of shared memory a read takes: the f ring, the anchor window of
// rb + bw rows (tb, te, qb, valid) and rb x bw term words
__host__ __device__ __forceinline__ size_t group_doubles(int ring, int rb, int bw) {
  const size_t wn = (size_t)((rb + bw + 3) & ~3);
  return (size_t)ring + (wn * (8 + 8 + 4 + 1) + (size_t)rb * bw * 4 + 7) / 8;
}

__device__ __forceinline__ double round_half_away(double y) {
  return y >= 0.0 ? floor(__dadd_rn(y, 0.5)) : ceil(__dsub_rn(y, 0.5));
}

template <bool DIV_ONCE>
__global__ void __launch_bounds__(WARPS * 32)
    chain_dp_exact_kernel(const int* __restrict__ qb, const long long* __restrict__ tb,
                          const long long* __restrict__ te, const uint8_t* __restrict__ valid,
                          const double* __restrict__ gap_table, int B, int A, int k, int bw,
                          int ring, int rb, int max_gap, int table_smem,
                          double* __restrict__ f_out, int* __restrict__ pred_out,
                          double* __restrict__ cmax_out) {
  extern __shared__ double smem[];
  const int n_tab = table_smem ? max_gap + 1 : 0;
  if (table_smem) {
    for (int g = threadIdx.x; g < n_tab; g += blockDim.x) smem[g] = gap_table[g];
  }
  __syncthreads();
  const double* gt = table_smem ? smem : gap_table;
  const int gib = threadIdx.x >> 5;  // warp (read) in the block
  const int gl = threadIdx.x & 31;   // lane
  const int b = blockIdx.x * WARPS + gib;
  if (b >= B) return;  // whole warps
  // a read's shared memory: its f ring, then the anchor window of a term
  // block (tb, te, qb, valid for rows i0 - bw .. i0 + rb), then the terms
  const int wn = (rb + bw + 3) & ~3;
  double* fr = smem + n_tab + (size_t)gib * group_doubles(ring, rb, bw);
  long long* tbw = reinterpret_cast<long long*>(fr + ring);
  long long* tew = tbw + wn;
  int* qbw = reinterpret_cast<int*>(tew + wn);
  uint8_t* vw = reinterpret_cast<uint8_t*>(qbw + wn);
  unsigned* terms = reinterpret_cast<unsigned*>(vw + wn);
  const size_t row = (size_t)b * A;
  const int* qbr = qb + row;
  const long long* tbr = tb + row;
  const long long* ter = te + row;
  const uint8_t* var = valid + row;
  const double k_f = (double)k;
  const int rmask = ring - 1;

  // (1) this read's rows after its last valid anchor: f = k, pred = -1
  int last = -1;
  for (int i = gl; i < A; i += 32)
    if (var[i]) last = i;
  const int n_g = __reduce_max_sync(FULL, (unsigned)(last + 1));
  for (int i = n_g + gl; i < A; i += 32) {
    f_out[row + i] = k_f;
    pred_out[row + i] = -1;
  }

  // (2) blocks of rb rows: pair terms in parallel, then the serial steps
  double cm = 0.0;
  for (int i0 = 0; i0 < n_g; i0 += rb) {
    const int rows = min(rb, n_g - i0);
    // the block's anchor window into shared memory, every load in flight at
    // once, after every lane is done with the last block's
    __syncwarp();
    const int wb = i0 - bw;
    for (int t = gl; t < rb + bw; t += 32) {
      const int x = wb + t;
      const bool in = x >= 0 && x < A;
      tbw[t] = in ? tbr[x] : 0;
      tew[t] = in ? ter[x] : 0;
      qbw[t] = in ? qbr[x] : 0;
      vw[t] = in ? var[x] : 0;
    }
    __syncwarp();
#pragma unroll 2
    for (int rr = 0; rr < rows; ++rr) {
      const int ii = bw + rr;  // row i0 + rr at ii in the window
      const bool vi = vw[ii] != 0;
      const long long qbi = qbw[ii], tbi = tbw[ii], tei = tew[ii];
      for (int r = gl; r < bw; r += 32) {
        const int jj = ii - 1 - r;  // j = i - 1 - r; a j below 0 is not valid in the window
        const long long qbj = qbw[jj], tej = tew[jj];
        const long long ql = qbi - qbj;
        const long long tl = min(llabs(tbi - tbw[jj]), llabs(tei - tej));
        const long long gap = llabs(ql - tl);
        const bool ok = vi & (vw[jj] != 0) & (qbj < qbi) & (tej < tei) & (gap <= max_gap);
        terms[rr * bw + r] =
            ok ? ((unsigned)gap << 8) | (unsigned)min(min(ql, tl), (long long)k) : NONE;
      }
    }
    __syncwarp();
    for (int rr = 0; rr < rows; ++rr) {
      const int i = i0 + rr;
      if (vw[bw + rr] == 0) {  // an invalid row: no pair, no reduction
        if (gl == 0) {
          f_out[row + i] = k_f;
          pred_out[row + i] = -1;
        }
        continue;
      }
      double m;
      int bj;
      if constexpr (DIV_ONCE) {
        // the row's winner as one integer key: (rr + 2^41 + 1) << 21 | j, 0 for none
        // two pairs at a time, without a branch, so that their f64 chains
        // overlap; a pair that is not ok reads slot 0 and gives key 0
        long long key = 0;
        for (int r0 = gl; r0 < bw; r0 += 64) {
          long long kk[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int r = r0 + u * 32;
            const unsigned w = r < bw ? terms[rr * bw + r] : NONE;
            const int j = i - 1 - r;
            const double x = __dsub_rn(__dadd_rn(fr[j & rmask], (double)(int)(w & 255u)),
                                       gt[w == NONE ? 0u : w >> 8]);
            const long long a = __double2ll_rn(round_half_away(__dmul_rn(x, 1000.0)));
            kk[u] = w == NONE ? 0 : ((a + KEY_OFF) << J_BITS) | j;
          }
          key = max(key, max(kk[0], kk[1]));
        }
        const unsigned hi = __reduce_max_sync(FULL, (unsigned)(key >> 32));
        const unsigned lo =
            __reduce_max_sync(FULL, (unsigned)(key >> 32) == hi ? (unsigned)key : 0u);
        key = (long long)(((unsigned long long)hi << 32) | lo);
        bj = key ? (int)(key & ((1LL << J_BITS) - 1)) : -1;
        m = key ? __ddiv_rn((double)((key >> J_BITS) - KEY_OFF), 1000.0) : -DBL_MAX;
      } else {
        double best = -DBL_MAX;
        bj = -1;
        for (int r = gl; r < bw; r += 32) {
          const unsigned w = terms[rr * bw + r];
          if (w == NONE) continue;
          const int j = i - 1 - r;
          const double x =
              __dsub_rn(__dadd_rn(fr[j & rmask], (double)(int)(w & 255u)), gt[w >> 8]);
          const double p = __ddiv_rn(round_half_away(__dmul_rn(x, 1000.0)), 1000.0);
          if (p > best || (p == best && j > bj)) {
            best = p;
            bj = j;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const double ob = __shfl_xor_sync(FULL, best, off);
          const int oj = __shfl_xor_sync(FULL, bj, off);
          if (ob > best || (ob == best && oj > bj)) {
            best = ob;
            bj = oj;
          }
        }
        m = best;
      }
      if (gl == 0) {
        const bool improved = m > k_f;
        const double fi = improved ? m : k_f;
        cm = fmax(cm, m);
        fr[i & rmask] = fi;
        f_out[row + i] = fi;
        pred_out[row + i] = improved ? bj : -1;
      }
      __syncwarp();  // publish f(i) to the other lanes
    }
  }
  if (gl == 0) cmax_out[b] = cm;
}

template <bool DIV_ONCE>
cudaError_t launch(const int* qb, const long long* tb, const long long* te, const uint8_t* valid,
                   const double* gap_table, int B, int A, int k, int bw, int ring, int rb,
                   int max_gap, int table_smem, size_t smem, double* f, int* pred, double* cmax,
                   cudaStream_t st) {
  auto kern = chain_dp_exact_kernel<DIV_ONCE>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<(B + WARPS - 1) / WARPS, WARPS * 32, smem, st>>>(
      qb, tb, te, valid, gap_table, B, A, k, bw, ring, rb, max_gap, table_smem, f, pred, cmax);
  return cudaGetLastError();
}

}  // namespace

// div_once: 1 for one divide a row (the caller has checked the 2^41
// bound), 0 for one a pair
extern "C" int vg_chain_dp_exact(const void* qb, const void* tb, const void* te,
                                 const void* valid, const void* gap_table, int B, int A,
                                 int k, int bw, int max_gap, int div_once, void* f, void* pred,
                                 void* cmax, void* stream) {
  if (B <= 0 || A <= 0) return (int)cudaGetLastError();
  if (bw <= 0 || k < 0 || k > 255 || max_gap < 0 || max_gap >= (1 << 24) - 1)
    return (int)cudaErrorInvalidValue;
  int ring = 32;
  while (ring <= bw) ring <<= 1;
  const int rb = max(1, 640 / bw);  // rows a term block: 12 at bw 50
  const size_t group_bytes = (size_t)WARPS * group_doubles(ring, rb, bw) * sizeof(double);
  const size_t tab_bytes = (size_t)(max_gap + 1) * sizeof(double);
  const int table_smem = tab_bytes + group_bytes <= SMEM_MAX;
  const size_t smem = group_bytes + (table_smem ? tab_bytes : 0);
  cudaStream_t st = (cudaStream_t)stream;
  const auto run = div_once ? &launch<true> : &launch<false>;
  return (int)run((const int*)qb, (const long long*)tb, (const long long*)te,
                  (const uint8_t*)valid, (const double*)gap_table, B, A, k, bw, ring, rb, max_gap,
                  table_smem, smem, (double*)f, (int*)pred, (double*)cmax, st);
}
