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
// division must be a true IEEE divide, not a multiply by 1/1000.  (mlen -
// gcost is never formed: (f + mlen) - g rounds twice, as the reference.)
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
// anchor row; per pair a few f64 operations.  No bandwidth to speak of.
// The long-read launch is B 65 x A 16,384 with one read of 9,544 rows to
// its last valid anchor on a nearly empty card, so its time is that
// read's rows times one row's latency.  The design (chain_dp.cu's plan)
// takes everything but that row off the serial path:
//
//  * two warps a read, two reads a block: a producer warp copies block
//    blk + 1's anchor window (rows i0 - bw .. i0 + RB, every load in
//    flight at once) into shared memory and computes its f-independent
//    pair terms into the other of two term buffers, while a consumer warp
//    runs block blk's serial rows, lane l taking j = i-1-l, i-33-l, ...
//    (8 and 16 lanes a read, with a butterfly reduction, were slower);
//    the two meet at one named barrier a block (bar.sync 1 + the read's
//    slot in the block, 64 threads);
//  * the producer looks the gap cost up itself (the table from device
//    memory, through L1; any max_gap), so a term is the f64 gcost and a
//    16-bit mlen, 0xffff for a pair that is not ok (mlen <= k <= 255, so
//    no pair collides with the marker, whatever the table holds); the
//    consumer never touches the table;
//  * the last bw + 1 values of f live in a ring of shared memory (a power
//    of two above bw, so the slot written at row i is never one a lane
//    still reads), written by lane 0; one __syncwarp a row publishes
//    f(i).  Every lane knows f(i - 1) after the reduction, so lane 0 takes
//    its first pair's f from a register, and the other lanes' first two
//    ring values (written a row or more before) and the next row's first
//    two pairs' terms (all of them at bw <= 64) are loaded a row ahead:
//    no shared-memory load stands between one row's f and the next row's
//    adds;
//  * the last valid anchor: both warps find it first (invalid anchors are
//    sorted last, but nothing here assumes that valid anchors form a
//    prefix); the rows stop after it, and the producer writes f = k, pred
//    = -1 to every later row, which is what the recurrence gives an
//    invalid anchor, while the consumer runs the last block.  Every row
//    up to it takes the reduction (an invalid row's pairs are all "not
//    ok": f = k, pred = -1, curr_max untouched, as the twin).
//
// Residency at bw 50 (rb 12, ring 64): 13,856 B of shared memory a read
// (f ring 512, two f64 term buffers 9,600, the window 1,344, two mlen
// buffers 2,400), 27,712 B a block of 128 threads.  The barrier ids are
// constants, so ptxas reserves 3 named barriers a block (an id in a
// register reserves all 16, and the SM's barriers then held the kernel to
// 4 blocks an SM), and __launch_bounds__(128, 8) holds it to 64 registers
// (ptxas gave it 48 without, and the row ran slower), so an SM keeps 8
// blocks, 16 reads: 2,112 on 132 SMs.  The main launch, 4,096 reads, is
// two waves of them, against one wave of the one-warp-a-read plan this
// replaces (32 reads an SM, one warp computing a block's terms and then
// its rows, with the table in shared memory); the two-warp plan was
// faster at every B from 512 to 8,192 on the H100 (PERF.md), so it is
// the only plan.
//
// Edges: an absent read (odd B) returns both its warps before any named
// barrier; a read with no valid anchor has no block, and its two warps
// meet once; the last block may be shorter than RB (its window is rows +
// bw rows), the window's left edge below row 0 reads as invalid, and n_g
// a multiple of RB gives full blocks only.  The producer refills a term
// buffer only after the barrier that ends the consumer's use of it.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int READS = 2;  // reads a block, two warps each
constexpr int THREADS = READS * 64;
constexpr int MIN_BLOCKS = 8;  // blocks an SM: at most 64 registers
constexpr unsigned NONE16 = 0xffffu;  // the mlen of a pair that is not ok
constexpr unsigned FULL = 0xffffffffu;
constexpr int J_BITS = 21;                      // j < 2^21 in a row's key
constexpr long long KEY_OFF = (1LL << 41) + 1;  // rr + KEY_OFF in [1, 2^42)
static_assert(READS == 2, "pair_sync names one barrier a read");

// bytes of shared memory a read takes: the f ring, two buffers of rb x bw
// f64 gap costs, the producer's anchor window of rb + bw rows (tb, te,
// qb, valid) and two buffers of rb x bw 16-bit mlen
__host__ __device__ __forceinline__ size_t group_bytes(int ring, int rb, int bw) {
  const size_t wn = (size_t)((rb + bw + 3) & ~3);
  const size_t nt = (size_t)rb * bw;
  return (8 * ((size_t)ring + 2 * nt) + wn * (8 + 8 + 4 + 1) + 2 * 2 * nt + 7) & ~(size_t)7;
}

__device__ __forceinline__ double round_half_away(double y) {
  return y >= 0.0 ? floor(__dadd_rn(y, 0.5)) : ceil(__dsub_rn(y, 0.5));
}

// the two warps of the block's read rib meet here: named barrier 1 + rib
// of 64 threads.  The id is a constant, so ptxas reserves 3 barriers a
// block, not all 16 (an id in a register reserves 16, and the SM's
// barriers then hold it to 4 blocks)
__device__ __forceinline__ void pair_sync(int rib) {
  if (rib == 0)
    asm volatile("bar.sync 1, 64;" ::: "memory");
  else
    asm volatile("bar.sync 2, 64;" ::: "memory");
}

// DIV_ONCE: a pair's row key, (rr + 2^41 + 1) << 21 | j, 0 for a
// pair that is not ok (its ring slot and g are then never used)
__device__ __forceinline__ long long pair_key(double f, unsigned m, double g, int j) {
  const double x = __dsub_rn(__dadd_rn(f, (double)(int)m), g);
  const long long a = __double2ll_rn(round_half_away(__dmul_rn(x, 1000.0)));
  return m == NONE16 ? 0 : ((a + KEY_OFF) << J_BITS) | j;
}

template <bool DIV_ONCE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    chain_dp_exact_kernel(const int* __restrict__ qb, const long long* __restrict__ tb,
                          const long long* __restrict__ te, const uint8_t* __restrict__ valid,
                          const double* __restrict__ gap_table, int B, int A, int k, int bw,
                          int ring, int rb, int max_gap, double* __restrict__ f_out,
                          int* __restrict__ pred_out, double* __restrict__ cmax_out) {
  extern __shared__ double smem_d[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_d);
  const int warp = threadIdx.x >> 5;
  const int gl = threadIdx.x & 31;  // lane
  const int rib = warp >> 1;        // read in the block
  const bool producer = (warp & 1) != 0;
  const int b = blockIdx.x * READS + rib;
  if (b >= B) return;  // both warps of an absent read, before any barrier
  const int wn = (rb + bw + 3) & ~3;
  const int nt = rb * bw;  // term slots a buffer
  double* fr = reinterpret_cast<double*>(smem + (size_t)rib * group_bytes(ring, rb, bw));
  double* gterm = fr + ring;  // [2][rb * bw] gap costs
  long long* tbw = reinterpret_cast<long long*>(gterm + 2 * nt);
  long long* tew = tbw + wn;
  int* qbw = reinterpret_cast<int*>(tew + wn);
  uint8_t* vw = reinterpret_cast<uint8_t*>(qbw + wn);
  unsigned short* mterm = reinterpret_cast<unsigned short*>(vw + wn);  // [2][rb * bw] mlen
  const size_t row = (size_t)b * A;
  const int* qbr = qb + row;
  const long long* tbr = tb + row;
  const long long* ter = te + row;
  const uint8_t* var = valid + row;
  const double k_f = (double)k;

  // (1) this read's last valid anchor, found by each of its warps
  int last = -1;
  for (int i = gl; i < A; i += 32)
    if (var[i]) last = i;
  const int n_g = (int)__reduce_max_sync(FULL, (unsigned)(last + 1));
  const int nblk = (n_g + rb - 1) / rb;

  if (producer) {
    // (2) the pair terms of block blk + 1 while the consumer runs block
    // blk; one barrier between blocks
    for (int blk = 0; blk <= nblk; ++blk) {
      if (blk < nblk) {
        const int i0 = blk * rb;
        const int rows = min(rb, n_g - i0);
        const int wb = i0 - bw;
        __syncwarp();  // every lane is done with the last block's window
        for (int t = gl; t < rows + bw; t += 32) {
          const int x = wb + t;
          const bool in = x >= 0;  // x < n_g <= A
          tbw[t] = in ? tbr[x] : 0;
          tew[t] = in ? ter[x] : 0;
          qbw[t] = in ? qbr[x] : 0;
          vw[t] = in ? var[x] : 0;
        }
        __syncwarp();
        double* gb = gterm + (blk & 1) * nt;
        unsigned short* mb = mterm + (blk & 1) * nt;
        int rr = gl / bw, r = gl - rr * bw;  // pair p = rr * bw + r
#pragma unroll 2
        for (int p = gl; p < rows * bw; p += 32) {
          const int ii = bw + rr;     // row i0 + rr at ii in the window
          const int jj = ii - 1 - r;  // j = i - 1 - r; a j below 0 is not valid in the window
          const long long qbi = qbw[ii], qbj = qbw[jj], tei = tew[ii], tej = tew[jj];
          const long long ql = qbi - qbj;
          const long long tl = min(llabs(tbw[ii] - tbw[jj]), llabs(tei - tej));
          const long long gap = llabs(ql - tl);
          const bool ok = (vw[ii] != 0) & (vw[jj] != 0) & (qbj < qbi) & (tej < tei) &
                          (gap <= max_gap);
          gb[p] = __ldg(gap_table + (ok ? gap : 0));
          mb[p] = ok ? (unsigned short)min(min(ql, tl), (long long)k) : (unsigned short)NONE16;
          r += 32;
          while (r >= bw) {
            r -= bw;
            ++rr;
          }
        }
      } else {
        // rows after the last valid anchor: f = k, pred = -1, while the
        // consumer runs the last block
        for (int i = n_g + gl; i < A; i += 32) {
          f_out[row + i] = k_f;
          pred_out[row + i] = -1;
        }
      }
      pair_sync(rib);
    }
    return;
  }

  // (3) the consumer: the serial rows, block by block as the producer
  // fills them.  Every lane knows f(i - 1) after the reduction (fprev),
  // so lane 0 takes its first pair's f from there, and the other lanes'
  // first two ring values, f(i - 1 - gl) and f(i - 33 - gl), written a
  // row or more before, are loaded a row ahead: no shared-memory load
  // stands between one row's f and the next row's adds.
  const int rmask = ring - 1;
  double cm = 0.0, fprev = 0.0, rf0 = 0.0, rf1 = 0.0;
  pair_sync(rib);
  for (int blk = 0; blk < nblk; ++blk) {
    const int i0 = blk * rb;
    const int rows = min(rb, n_g - i0);
    const double* gb = gterm + (blk & 1) * nt;
    const unsigned short* mb = mterm + (blk & 1) * nt;
    // a row's first two pairs (r = gl, gl + 32) in registers, the next
    // row's loaded while this one runs
    double g0 = 0.0, g1 = 0.0;
    unsigned m0 = NONE16, m1 = NONE16;
    auto load = [&](int rr) {
      m0 = gl < bw ? mb[rr * bw + gl] : NONE16;
      g0 = gl < bw ? gb[rr * bw + gl] : 0.0;
      m1 = gl + 32 < bw ? mb[rr * bw + gl + 32] : NONE16;
      g1 = gl + 32 < bw ? gb[rr * bw + gl + 32] : 0.0;
    };
    load(0);
    for (int rr = 0; rr < rows; ++rr) {
      const int i = i0 + rr;
      const double cg0 = g0, cg1 = g1;
      const unsigned cm0 = m0, cm1 = m1;
      const double f0 = gl == 0 ? fprev : rf0, f1 = rf1;
      rf0 = fr[(i - gl) & rmask];  // the next row's (lane 0's slot is replaced by fprev)
      rf1 = fr[(i - 32 - gl) & rmask];
      if (rr + 1 < rows) load(rr + 1);
      const int j0 = i - 1 - gl, j1 = i - 33 - gl;
      double m;
      int bj;
      if constexpr (DIV_ONCE) {
        long long key = max(pair_key(f0, cm0, cg0, j0), pair_key(f1, cm1, cg1, j1));
        for (int r0 = gl + 64; r0 < bw; r0 += 64) {  // bw over 64: from shared memory
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int r = r0 + u * 32;
            const unsigned w = r < bw ? mb[rr * bw + r] : NONE16;
            const double g = r < bw ? gb[rr * bw + r] : 0.0;
            const int j = i - 1 - r;
            key = max(key, pair_key(fr[j & rmask], w, g, j));
          }
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
        auto take = [&](double fj, unsigned w, double g, int j) {
          if (w == NONE16) return;
          const double x = __dsub_rn(__dadd_rn(fj, (double)(int)w), g);
          const double p = __ddiv_rn(round_half_away(__dmul_rn(x, 1000.0)), 1000.0);
          if (p > best || (p == best && j > bj)) {
            best = p;
            bj = j;
          }
        };
        take(f0, cm0, cg0, j0);
        take(f1, cm1, cg1, j1);
        for (int r = gl + 64; r < bw; r += 32)
          take(fr[(i - 1 - r) & rmask], mb[rr * bw + r], gb[rr * bw + r], i - 1 - r);
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
      const bool improved = m > k_f;
      fprev = improved ? m : k_f;
      if (gl == 0) {
        cm = fmax(cm, m);
        fr[i & rmask] = fprev;
        f_out[row + i] = fprev;
        pred_out[row + i] = improved ? bj : -1;
      }
      __syncwarp();  // publish f(i) to the ring
    }
    pair_sync(rib);  // the block's terms may be overwritten; the next block is ready
  }
  if (gl == 0) cmax_out[b] = cm;
}

struct Config {
  int ring, rb;  // f ring slots (a power of two above bw), rows a term block
  size_t smem;   // dynamic shared memory a block
};

Config configure(int bw) {
  Config c;
  c.ring = 32;
  while (c.ring <= bw) c.ring <<= 1;
  c.rb = max(1, 640 / bw);  // rows a term block: 12 at bw 50
  c.smem = (size_t)READS * group_bytes(c.ring, c.rb, bw);
  return c;
}

template <bool DIV_ONCE>
cudaError_t prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(chain_dp_exact_kernel<DIV_ONCE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// div_once: 1 for one divide a row (the caller has checked the 2^41
// bound), 0 for one a pair
extern "C" int vg_chain_dp_exact(const void* qb, const void* tb, const void* te,
                                 const void* valid, const void* gap_table, int B, int A,
                                 int k, int bw, int max_gap, int div_once, void* f, void* pred,
                                 void* cmax, void* stream) {
  if (B <= 0 || A <= 0) return (int)cudaGetLastError();
  if (bw <= 0 || k < 0 || k > 255 || max_gap < 0) return (int)cudaErrorInvalidValue;
  const Config c = configure(bw);
  const cudaError_t e = div_once ? prepare<true>(c.smem) : prepare<false>(c.smem);
  if (e != cudaSuccess) return (int)e;
  auto kern = div_once ? chain_dp_exact_kernel<true> : chain_dp_exact_kernel<false>;
  kern<<<(B + READS - 1) / READS, THREADS, c.smem, (cudaStream_t)stream>>>(
      (const int*)qb, (const long long*)tb, (const long long*)te, (const uint8_t*)valid,
      (const double*)gap_table, B, A, k, bw, c.ring, c.rb, max_gap, (double*)f, (int*)pred,
      (double*)cmax);
  return (int)cudaGetLastError();
}

// out[0..2]: reads a block, blocks an SM keeps resident, dynamic shared
// memory a block in bytes, at band bw
extern "C" int vg_chain_dp_exact_occupancy(int bw, int div_once, int* out) {
  if (bw <= 0) return (int)cudaErrorInvalidValue;
  const Config c = configure(bw);
  cudaError_t e = div_once ? prepare<true>(c.smem) : prepare<false>(c.smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, div_once ? chain_dp_exact_kernel<true> : chain_dp_exact_kernel<false>, THREADS,
        c.smem);
  out[0] = READS;
  out[1] = blocks;
  out[2] = (int)c.smem;
  return (int)e;
}
