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
// Every value fits in i32: f grows by at most k*1000 a row, so f <= k *
// 1000 * (A + 1), 7.2e8 at k 11 and A 65,536 (the mapper's cap), and a
// pair's term is above -(10 k max_gap + 500 log2(max_gap) + 1).
//
// What bounds it on the card: the DP is serial along anchors within a
// read (f(i) depends on f(i-1)), so a launch takes about its longest
// read's rows times one step's latency; work is tiny (about 40 integer
// and f32 ops a pair, 50 pairs a row) and there are no bytes to speak of.
// The long-read launch is B 65 x A 16,384 with one read of 9,544 valid
// anchors on a nearly empty card, so the design attacks the serial step
// (chain_dp_exact.cu's plan):
//
//  * two warps a read, and two reads a block: a consumer warp runs the
//    serial rows, lane l taking j = i-1-l, i-33-l, ... of a row's window
//    (32 lanes a read beat 8 and 16 for K5), while a producer warp
//    computes the f-independent pair terms of the next block of RB rows,
//    ok(j,i) and min(ql,tl,k)*1000 - gc(gap) (INT_MIN for a pair that is
//    not ok), from an anchor window it copies into shared memory, into
//    the other of two term buffers; the two meet at one named barrier a
//    block.  The serial step is then one ring load, an add and a compare
//    a pair, and the pair terms (the gap cost's f32 polynomial, the
//    window loads) are off its path;
//  * the last valid anchor: before the loop each warp finds it (nothing
//    assumes that the valid anchors form a prefix) and the producer
//    writes f = k*1000, pred = -1 to every later row in parallel, which
//    is what the recurrence gives there (their m is -2^30, which
//    curr_max, starting at 0, ignores); the rows stop after the last
//    valid one;
//  * the reduction is two redux.sync: the max of p, then the max of j
//    among the lanes at that max (the larger-j tie rule); a lane's first
//    pair at its own max already has its largest j;
//  * the last values of f live in a ring of shared memory (a power of two
//    above bw, so the slot written at row i is never one a lane still
//    reads), written by lane 0; one __syncwarp a row publishes f(i);
//  * an invalid row costs no pair and no reduction.
//
// The gap cost is computed per pair from a degree-7 f32 polynomial of
// log2 whose bits come from one IEEE rounding after every multiply and
// every add; nvcc would contract a*b+c into an FMA, so every step is an
// explicit __fmul_rn/__fadd_rn.  The coefficients are the f32 roundings
// of ops/chain.py's _LOG2_COEF, written as bit patterns.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEGI = -(1 << 30);
constexpr int NONE = INT_MIN;  // the term of a pair that is not ok
constexpr int READS = 2;       // reads a block, two warps each
constexpr unsigned FULL = 0xffffffffu;

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

// ints of shared memory a read takes: the f ring, the producer's anchor
// window of rb + bw rows (qb, tb, te, and valid as bytes), and two
// buffers of rb x bw term words and rb row flags
__host__ __device__ __forceinline__ size_t group_ints(int ring, int rb, int bw) {
  const size_t wn = (size_t)((rb + bw + 3) & ~3);
  return (size_t)ring + wn * 3 + wn / 4 + 2 * ((size_t)rb * bw + rb);
}

// the two warps of a read meet here: a named barrier of 64 threads
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

__global__ void __launch_bounds__(READS * 64)
    chain_dp_kernel(const int* __restrict__ qb, const int* __restrict__ tb,
                    const int* __restrict__ te, const uint8_t* __restrict__ valid, int B, int A,
                    int k, int bw, int ring, int rb, int max_gap, int* __restrict__ f_out,
                    int* __restrict__ pred_out, int* __restrict__ cmax_out) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int gl = threadIdx.x & 31;  // lane
  const int rib = warp >> 1;        // read in the block
  const bool producer = (warp & 1) != 0;
  const int b = blockIdx.x * READS + rib;
  if (b >= B) return;  // both warps of a read
  const int wn = (rb + bw + 3) & ~3;
  int* fr = smem + (size_t)rib * group_ints(ring, rb, bw);
  int* qbw = fr + ring;
  int* tbw = qbw + wn;
  int* tew = tbw + wn;
  uint8_t* vw = reinterpret_cast<uint8_t*>(tew + wn);
  int* terms = reinterpret_cast<int*>(vw + wn);  // [2][rb * bw]
  int* rowv = terms + 2 * rb * bw;              // [2][rb]
  const size_t row = (size_t)b * A;
  const int* qbr = qb + row;
  const int* tbr = tb + row;
  const int* ter = te + row;
  const uint8_t* var = valid + row;
  const int k_i = k * 1000;
  const int bar = 1 + rib;

  // (1) this read's last valid anchor, found by each of its warps
  int last = -1;
  for (int i = gl; i < A; i += 32)
    if (var[i]) last = i;
  const int n_g = (int)__reduce_max_sync(FULL, (unsigned)(last + 1));
  const int nblk = (n_g + rb - 1) / rb;

  if (producer) {
    // rows after the last valid anchor: f = k * 1000, pred = -1
    for (int i = n_g + gl; i < A; i += 32) {
      f_out[row + i] = k_i;
      pred_out[row + i] = -1;
    }
    // (2) the f-independent pair terms of block blk + 1 while the consumer
    // runs block blk; one barrier between blocks
    for (int blk = 0; blk <= nblk; ++blk) {
      if (blk < nblk) {
        const int i0 = blk * rb;
        const int rows = min(rb, n_g - i0);
        const int wb = i0 - bw;
        __syncwarp();  // every lane is done with the last block's window
#pragma unroll 2
        for (int t = gl; t < rows + bw; t += 32) {
          const int x = wb + t;
          const bool in = x >= 0;  // x < n_g <= A
          qbw[t] = in ? qbr[x] : 0;
          tbw[t] = in ? tbr[x] : 0;
          tew[t] = in ? ter[x] : 0;
          vw[t] = in ? var[x] : 0;
        }
        __syncwarp();
        int* tm = terms + (blk & 1) * rb * bw;
#pragma unroll 4
        for (int p = gl; p < rows * bw; p += 32) {
          const int rr = p / bw, r = p - rr * bw;
          const int ii = bw + rr;     // row i0 + rr at ii in the window
          const int jj = ii - 1 - r;  // j = i - 1 - r; a j below 0 is not valid in the window
          const int qbi = qbw[ii], qbj = qbw[jj], tei = tew[ii], tej = tew[jj];
          const int ql = qbi - qbj;
          const int tl = min(abs(tbw[ii] - tbw[jj]), abs(tei - tej));
          const int gap = abs(ql - tl);
          const bool ok = vw[ii] != 0 && vw[jj] != 0 && qbj < qbi && tej < tei && gap <= max_gap;
          tm[p] = ok ? min(min(ql, tl), k) * 1000 - gap_cost_scaled(gap, k) : NONE;
        }
        for (int rr = gl; rr < rows; rr += 32) rowv[(blk & 1) * rb + rr] = vw[bw + rr];
      }
      pair_sync(bar);
    }
    return;
  }

  // (3) the serial rows, block by block as the producer fills them
  const int rmask = ring - 1;
  int cm = 0;
  pair_sync(bar);
  for (int blk = 0; blk < nblk; ++blk) {
    const int i0 = blk * rb;
    const int rows = min(rb, n_g - i0);
    const int* tm = terms + (blk & 1) * rb * bw;
    const int* rv = rowv + (blk & 1) * rb;
    for (int rr = 0; rr < rows; ++rr) {
      const int i = i0 + rr;
      if (rv[rr] == 0) {  // an invalid row: no pair, no reduction
        if (gl == 0) {
          f_out[row + i] = k_i;
          pred_out[row + i] = -1;
        }
        continue;
      }
      // the lane's best; r ascending is j descending, so the first pair at
      // the lane's max has its largest j
      int best = NEGI, bj = -1;
#pragma unroll 2
      for (int r = gl; r < bw; r += 32) {
        const int t = tm[rr * bw + r];
        const int j = i - 1 - r;
        const int p = t == NONE ? NEGI : fr[j & rmask] + t;
        if (p > best) {
          best = p;
          bj = j;
        }
      }
      const int m = __reduce_max_sync(FULL, best);
      const int mj = __reduce_max_sync(FULL, best == m ? bj : -1);
      if (gl == 0) {
        const bool improved = m > k_i;
        const int fi = improved ? m : k_i;
        cm = max(cm, m);
        fr[i & rmask] = fi;
        f_out[row + i] = fi;
        pred_out[row + i] = improved ? mj : -1;
      }
      __syncwarp();  // publish f(i) to the other lanes
    }
    pair_sync(bar);  // the block's terms may be overwritten; the next block is ready
  }
  if (gl == 0) cmax_out[b] = cm;
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
  if (bw <= 0) return (int)cudaErrorInvalidValue;
  int ring = 32;
  while (ring <= bw) ring <<= 1;
  const int rb = max(1, 640 / bw);  // rows a term block: 12 at bw 50
  const size_t smem = (size_t)READS * group_ints(ring, rb, bw) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  auto kern = chain_dp_kernel;
  kern<<<(B + READS - 1) / READS, READS * 64, smem, (cudaStream_t)stream>>>(
      (const int*)qb, (const int*)tb, (const int*)te, (const uint8_t*)valid, B, A, k, bw,
      ring, rb, max_gap, (int*)f, (int*)pred, (int*)cmax);
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
