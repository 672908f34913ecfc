// Local gapless partial-order alignment (rspoa engine), DP + traceback,
// for sm_90a: rows of W = 512-16,384 columns (reads of 256-16,383 bp), one
// thread-block cluster a problem.
//
// Replaces, at those widths: vgaligner_tpu/ops/poa_device.py::
// poa_local_kernel (:1075), a device loop (an XLA fori_loop over the
// vertices, then a scan for the traceback) with no Pallas kernel.  Its
// outputs are bit-identical to ops/poa_device.py::poa_local_plain: best
// [B] f32, tape [B, W] i32 (the END fill included), tlen and qend.  Rows
// of up to 256 columns take poa_local_warp.cu.  The recurrence:
//   cand_p[j] = H[pred_p][j-1] for a live slot, 0 for a dead one, 0 at j = 0;
//   m_best = max(max_p cand_p, 0); slot = the first live slot at m_best
//     when m_best > 0, else 15;
//   row[0] = 0, row[j] = max(m_best[j] + sub(q[j-1], code[v]), 0);
//   cell byte = slot | (row > 0) << 4;
// best is the largest row value over v < nv[b] at its first cell in
// (v, j) scan order, and the walk takes match steps from there.
//
// What bounds it on the card: the one plane that must reach device
// memory is the cell bytes, 1 byte a cell below nv.  The vertex loop is
// serial within a problem and the walk is a chain of dependent loads, so
// the design attacks each problem's latency, the bytes around it, and
// the SMs that one block a problem would leave idle:
//
//  * a cluster of N = W / S CTAs a problem, S = min(SLICE, W) columns a
//    CTA (N = 1, one CTA and no cluster barrier, up to W 2,048; 2, 4 and
//    8 at W 4,096, 8,192 and 16,384: a portable cluster size throughout),
//    CTA r owning columns [r*S, (r+1)*S) and
//    thread t of it the C = 4 columns from r*S + 4t; each problem runs its
//    own nv[b] rows, not the batch maximum.  SLICE 2,048 was chosen by
//    timing 512, 1,024 and 2,048 on the long reads' largest rspoa batch
//    (vgaligner_tpu_torch/kernel_probe.py, PERF.md);
//  * H lives in shared memory as int16, exact: a cell's value is 2 a match
//    along a run of at most min(nv, L) matches, so 0 <= H <= 2 min(nv, L)
//    <= 2 x 16,383 = 32,766 <= 32,767 at every width the kernel takes
//    (16,384 at most at V 8,192, the device route's vertex cap),
//    with poa_local_warp.cu's plan: a ring of SLOTS = 16 rows serving
//    predecessors up to RING = 8 rows back, PINS = 4 pinned rows for the
//    first far-referenced vertices, and past them a global int16 backing
//    store sized by the rows the host counts (back_off: each problem's
//    first row in it), never zeroed.  Each CTA keeps its own columns of
//    the ring and pins and writes its own columns of a backing row;
//  * the one value that crosses a slice: the M term of a CTA's first
//    column reads column r*S - 1 of the predecessor row, which CTA r - 1
//    owns.  Before the row's one cluster barrier, the thread owning CTA
//    r - 1's last column pushes that row's H (one int16) through
//    distributed shared memory into CTA r's halo, which has the ring's
//    and the pins' slots; a backing row's column comes from the global
//    row itself.  A ring slot is 16 rows old when it is reused, so no
//    halo slot is overwritten while a later row can still read it.  The
//    barrier is release/acquire at cluster scope, which also makes the
//    other CTAs' backing rows visible before any later row reads them;
//  * the best cell: each thread keeps its first strict best in (v, j)
//    scan order; a warp reduction, then the CTA's warps, then CTA 0 over
//    the cluster's CTAs (each pushes its result through distributed
//    shared memory) take the larger value, then the smaller v, then the
//    smaller j;
//  * cells: one 4-byte store a thread a row into a u8 plane that is never
//    zeroed (a walk reads only rows below nv that its problem wrote);
//  * the walk: after a last release/acquire cluster barrier, warp 0 of
//    CTA 0 walks.  The cell plane is far larger than L2 by then, so a
//    step's cell load is a round trip to device memory; a round therefore
//    loads at once the cells of every vertex the walk can reach in the
//    next DEPTH steps (P^d vertices d steps on, one a lane: 31 lanes at
//    P 2, depth 4), then follows the slots through them by shuffles,
//    taking up to DEPTH + 1 steps a round trip.  The predecessor ids come
//    from a copy of vpred in the ring's shared memory where it fits.  The
//    CTA writes the END tail.  No CTA's shared memory is read by another
//    after that barrier.
//
// Shared memory a CTA: (SLOTS + PINS) rows of 2S bytes, the halo, the
// far-vertex bitmap and its prefix counts: 82 KB at S 2,048 (V 2,048),
// 84,336 bytes at V 8,192, so two CTAs fit an SM.
//
// The backing store holds the rows the host counted for each problem; a
// problem whose far vertices need more (the host and the kernel
// disagree) gets tlen -1, which the caller treats as an error.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MATCH = 2, MISMATCH = -4;
constexpr int VIRT_SLOT = 15;
constexpr int RING = 8;    // rows back that the ring serves
constexpr int SLOTS = 16;  // ring slots, a power of two >= 2 RING
constexpr int PINS = 4;
constexpr int NROWS = SLOTS + PINS;
constexpr int HALO = 32;       // int16 halo slots kept (NROWS used), 64 bytes
constexpr int C = 4;           // columns a thread
constexpr int SLICE = 2048;    // columns a CTA at most
constexpr int MAX_THREADS = SLICE / C;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_CTAS = 8;    // at W 16,384
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

__device__ __forceinline__ void load_cols(const int16_t* p, int (&x)[C]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = (int)(int16_t)(u.x & 0xffffu);
  x[1] = (int)(int16_t)(u.x >> 16);
  x[2] = (int)(int16_t)(u.y & 0xffffu);
  x[3] = (int)(int16_t)(u.y >> 16);
}

__device__ __forceinline__ void store_cols(int16_t* p, const int (&x)[C]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(((unsigned)x[0] & 0xffffu) | ((unsigned)x[1] << 16),
                 ((unsigned)x[2] & 0xffffu) | ((unsigned)x[3] << 16));
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
// below it that are not pinned
__device__ __forceinline__ int back_rank(const unsigned* bm, const int* bm_pre, int v) {
  return bm_pre[v >> 5] + __popc(bm[v >> 5] & ((1u << (v & 31)) - 1u));
}

template <int P>
__global__ void __launch_bounds__(MAX_THREADS)
    poa_local_cluster_kernel(const int8_t* __restrict__ vcodes, const int* __restrict__ vpred,
                             const int* __restrict__ nv, const int8_t* __restrict__ q, int V,
                             int L, int S, int bm_words, const int* __restrict__ back_off,
                             int16_t* __restrict__ backing, uint8_t* __restrict__ cells,
                             float* __restrict__ best_out, int* __restrict__ tape,
                             int* __restrict__ tlen, int* __restrict__ qend,
                             int* __restrict__ n_backing) {
  extern __shared__ uint4 smem_v4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int N = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / N;  // a cluster's CTAs are consecutive in x
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int W = L + 1;
  const int j0 = r * S + t * C;  // this thread's first column

  int16_t* rows = reinterpret_cast<int16_t*>(smem_v4);  // [NROWS][S]
  int16_t* halo = rows + NROWS * S;                     // column r*S - 1 of each row slot
  unsigned* bm = reinterpret_cast<unsigned*>(halo + HALO);
  int* bm_pre = reinterpret_cast<int*>(bm + bm_words);
  int* red = bm_pre + bm_words;      // [MAX_WARPS][3]
  int* parts = red + 3 * MAX_WARPS;  // [MAX_CTAS][3], CTA 0's
  int* misc = parts + 3 * MAX_CTAS;  // far-vertex count, walk length

  const int nvb = nv[b];
  const int* vp_b = vpred + (size_t)b * V * P;
  const int8_t* vc_b = vcodes + (size_t)b * V;

  // (1) far-referenced vertices into the bitmap; the first PINS are
  // pinned, the rest numbered in the backing store.  Every CTA plans the
  // same from vpred.
  for (int i = t; i < bm_words; i += T) bm[i] = 0u;
  __syncthreads();
  for (int v = RING + 1 + t; v < nvb; v += T) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int pp = vp_b[(size_t)v * P + p];
      if (pp >= 0 && pp < v - RING) atomicOr(&bm[pp >> 5], 1u << (pp & 31));
    }
  }
  __syncthreads();
  int pin[PINS];
  {
    int from = 0;
#pragma unroll
    for (int k = 0; k < PINS; ++k) {
      int found = -1;
      for (int i = from >> 5; i < bm_words; ++i) {
        unsigned m = bm[i];
        if (i == (from >> 5)) m &= ~0u << (from & 31);
        if (m) {
          found = (i << 5) + __ffs(m) - 1;
          break;
        }
      }
      pin[k] = found;
      from = found < 0 ? (bm_words << 5) : found + 1;
    }
  }
  __syncthreads();
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < PINS; ++k)
      if (pin[k] >= 0) bm[pin[k] >> 5] &= ~(1u << (pin[k] & 31));
    int acc = 0;
    for (int i = 0; i < bm_words; ++i) {
      bm_pre[i] = acc;
      acc += __popc(bm[i]);
    }
    misc[0] = acc;
    if (r == 0) n_backing[b] = acc;
  }
  __syncthreads();
  // the rows the host counted for this problem; a row past them is
  // neither written nor read, and the walk's tlen says -1
  const int n_back = min(misc[0], back_off[b + 1] - back_off[b]);
  int16_t* back_b = backing + (size_t)back_off[b] * W;

  // (2) the thread's query codes, -1 where no vertex code matches (N, and
  // column 0, whose row value is 0)
  int qm[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    const int qc = j >= 1 ? (int)q[(size_t)b * L + j - 1] : 4;
    qm[c] = qc < 4 ? qc : -1;
  }
  int16_t* halo_next = r + 1 < N ? cluster.map_shared_rank(halo, (unsigned)(r + 1)) : nullptr;
  // every CTA of the cluster runs before any shared memory is written
  // across CTAs
  cluster.sync();

  // (3) the vertex loop, to this problem's own nv
  int cur_pr[P], nxt_pr[P], cur_code, nxt_code;
  load_meta<P>(vp_b, vc_b, lane, nvb, cur_pr, cur_code);
  load_meta<P>(vp_b, vc_b, 32 + lane, nvb, nxt_pr, nxt_code);
  int tbest = 0, tv = 0, tj = 0;
  uint8_t* cells_b = cells + (size_t)b * V * W;
  const int ts = t * C;  // this thread's first column in the CTA's rows

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
        int srow = -1;          // shared-memory row slot, or -1 for the backing store
        if (v - pp <= RING) {
          srow = pp & (SLOTS - 1);
        } else {
#pragma unroll
          for (int k = 0; k < PINS; ++k)
            if (pin[k] == pp) srow = SLOTS + k;
        }
        int own[C], left = 0;  // left: column j0 - 1 (0 at j0 = 0, unused there)
        if (srow >= 0) {
          const int16_t* s = rows + srow * S + ts;
          load_cols(s, own);
          if (t > 0) {
            left = s[-1];
          } else if (r > 0) {
            left = halo[srow];
          }
        } else {
          const int rank = back_rank(bm, bm_pre, pp);
          if (rank < n_back) {
            const int16_t* g = back_b + (size_t)rank * W;
            load_cols(g + j0, own);
            if (j0 > 0) left = g[j0 - 1];
          } else {
#pragma unroll
            for (int c = 0; c < C; ++c) own[c] = 0;
          }
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

    int hrow[C];
    unsigned cell = 0u;
    int rmax = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // a vertex code of 4 (N) matches no qm; column 0 has qm -1, m 0, so row 0
      const int row = max(mbest[c] + (qm[c] == vcode ? MATCH : MISMATCH), 0);
      hrow[c] = row;
      cell |= (unsigned)(mslot[c] | ((row > 0) << 4)) << (8 * c);
      rmax = max(rmax, row);
    }
    if (rmax > tbest) {  // the thread's first strict best: its first column at rmax
      tbest = rmax;
      tv = v;
      tj = j0 + C - 1;
#pragma unroll
      for (int c = C - 1; c >= 0; --c)
        if (hrow[c] == rmax) tj = j0 + c;
    }
    store_cols(rows + (v & (SLOTS - 1)) * S + ts, hrow);
    if (pin[0] >= 0) {
#pragma unroll
      for (int k = 0; k < PINS; ++k)
        if (pin[k] == v) store_cols(rows + (SLOTS + k) * S + ts, hrow);
    }
    if (n_back > 0 && ((bm[v >> 5] >> (v & 31)) & 1u)) {
      const int rank = back_rank(bm, bm_pre, v);
      if (rank < n_back) store_cols(back_b + (size_t)rank * W + j0, hrow);
    }
    *reinterpret_cast<unsigned*>(cells_b + (size_t)v * W + j0) = cell;
    if (t == T - 1 && halo_next != nullptr) {  // this CTA's last column, to the next CTA
      halo_next[v & (SLOTS - 1)] = (int16_t)hrow[C - 1];
#pragma unroll
      for (int k = 0; k < PINS; ++k)
        if (pin[k] == v) halo_next[SLOTS + k] = (int16_t)hrow[C - 1];
    }
    if (N > 1) {
      cluster.sync();  // row v (and its halo column) visible to later rows
    } else {
      __syncthreads();
    }
  }

  // (4) the best cell: larger value, then earlier cell in scan order;
  // the thread, the warp, the CTA, then the cluster in CTA 0
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
  if (lane == 0) {
    red[3 * w] = tbest;
    red[3 * w + 1] = tv;
    red[3 * w + 2] = tj;
  }
  __syncthreads();
  if (t == 0) {
    int bb = red[0], bv = red[1], bj = red[2];
    for (int i = 1; i < T / 32; ++i) {
      if (before(red[3 * i], red[3 * i + 1], red[3 * i + 2], bb, bv, bj)) {
        bb = red[3 * i];
        bv = red[3 * i + 1];
        bj = red[3 * i + 2];
      }
    }
    int* dst = cluster.map_shared_rank(parts, 0u) + 3 * r;
    dst[0] = bb;
    dst[1] = bv;
    dst[2] = bj;
  }
  // every CTA's cell rows and result are written and visible; no CTA's
  // shared memory is read by another after this
  cluster.sync();
  if (r != 0) return;

  // (5) the walk: match steps until the zero floor or j == 0, by warp 0.
  // A round loads the cells of every path DEPTH steps ahead at once (the
  // P^d vertices d steps from the current one, a lane each), so it takes
  // one dependent load from device memory for up to DEPTH + 1 steps; the
  // vertex ids come from a copy of vpred in the ring's shared memory
  // where it fits, else from device memory.
  int* tp = tape + (size_t)b * W;
  const bool vp_in_smem = (size_t)V * P * 4 <= (size_t)NROWS * S * 2;
  if (vp_in_smem) {
    int* vps_s = reinterpret_cast<int*>(rows);
    for (int i = t; i < V * P; i += T) vps_s[i] = vp_b[i];
  }
  __syncthreads();
  if (w == 0) {
    const int* vps = vp_in_smem ? reinterpret_cast<const int*>(rows) : vp_b;
    int bb = parts[0], bv = parts[1], bj = parts[2];
    for (int i = 1; i < N; ++i) {
      if (before(parts[3 * i], parts[3 * i + 1], parts[3 * i + 2], bb, bv, bj)) {
        bb = parts[3 * i];
        bv = parts[3 * i + 1];
        bj = parts[3 * i + 2];
      }
    }
    constexpr int DEPTH = P == 2 ? 4 : (P == 4 ? 2 : 1);  // 31, 21 or 9 lanes
    // this lane's node: depth d, index idx among the P^d nodes there, whose
    // base-P digits are the slots taken from the round's first vertex
    int d = 0, first = 0, cnt = 1;
    while (d < DEPTH && lane >= first + cnt) {
      first += cnt;
      cnt *= P;
      ++d;
    }
    const bool node = lane < first + cnt;
    const int idx = lane - first;
    int n = 0, v = bv, j = bj;
    for (bool go = true; go;) {
      int u = v, bits = 0;
      if (node) {
        for (int pw = cnt / P; pw >= 1 && u >= 0; pw /= P) u = vps[(size_t)u * P + (idx / pw) % P];
        if (u >= 0 && j - d > 0) bits = cells_b[(size_t)u * W + (j - d)];
      }
      // follow the slots down the tree: node c's child by slot g is at
      // first(depth + 1) + (c - first(depth)) * P + g
      int cur = 0, lf = 0, lc = 1;
      for (int dd = 0; dd <= DEPTH; ++dd) {
        const int cb = __shfl_sync(FULL, bits, cur);
        const int cu = __shfl_sync(FULL, u, cur);
        if (n >= W || cu < 0 || j - dd <= 0 || (cb >> 4) == 0) {
          go = false;
          break;
        }
        if (lane == 0) tp[n] = OP_M | ((cu + 2) << 2);
        ++n;
        const int slot = cb & 15;
        if (slot == VIRT_SLOT) {  // the virtual source: the next step stops
          go = false;
          break;
        }
        const int g = min(slot, P - 1);
        if (dd == DEPTH) {
          v = vps[(size_t)cu * P + g];
          j -= DEPTH + 1;
          break;
        }
        cur = lf + lc + (cur - lf) * P + g;
        lf += lc;
        lc *= P;
      }
    }
    if (lane == 0) {
      best_out[b] = (float)bb;
      tlen[b] = n_back < misc[0] ? -1 : n;
      qend[b] = bj;
      misc[1] = n;
    }
  }
  __syncthreads();
  for (int i = misc[1] + t; i < W; i += T) tp[i] = END_FILL;
}

int bitmap_words(int V) { return (((V + 31) >> 5) + 3) & ~3; }  // keeps what follows 16-B aligned

size_t smem_bytes(int V, int S) {
  return (size_t)NROWS * S * 2 + HALO * 2 + (size_t)2 * bitmap_words(V) * 4 +
         (size_t)(3 * MAX_WARPS + 3 * MAX_CTAS + 4) * 4;
}

// columns a CTA at row width W, or 0 where the kernel does not take it
int cta_cols(int W) {
  const int s = W < SLICE ? W : SLICE;
  if (s % (32 * C) != 0 || W % s != 0) return 0;
  const int n = W / s;
  return n <= MAX_CTAS && (n & (n - 1)) == 0 ? s : 0;
}

template <int P>
cudaError_t configure(int B, int V, int W, cudaStream_t st, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  const int S = cta_cols(W);
  if (S == 0 || V <= 0) return cudaErrorInvalidValue;
  const int N = W / S;
  const size_t smem = smem_bytes(V, S);
  const cudaError_t e = cudaFuncSetAttribute(
      poa_local_cluster_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(B * N), 1, 1);
  cfg->blockDim = dim3((unsigned)(S / C), 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return e;
}

template <int P>
cudaError_t launch(int B, int V, int L, cudaStream_t st, const int8_t* vcodes,
                   const int* vpred, const int* nv, const int8_t* q, const int* back_off,
                   int16_t* backing, uint8_t* cells, float* best, int* tape, int* tlen,
                   int* qend, int* n_backing) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<P>(B, V, L + 1, st, &cfg, attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, poa_local_cluster_kernel<P>, vcodes, vpred, nv, q, V, L,
                         cta_cols(L + 1), bitmap_words(V), back_off, backing, cells, best,
                         tape, tlen, qend, n_backing);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int P>
cudaError_t occupancy(int W, int V, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<P>(1, V, W, nullptr, &cfg, attr);
  if (e != cudaSuccess) return e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, poa_local_cluster_kernel<P>, &cfg);
  out[0] = W / cta_cols(W);
  out[1] = clusters;
  out[2] = (int)cfg.dynamicSmemBytes;
  return e;
}

}  // namespace

// back_off [B + 1] int32: problem b's backing rows are [back_off[b],
// back_off[b + 1]) of backing [back_off[B], W] int16
extern "C" int vg_poa_local_cluster(const void* vcodes, const void* vpred, const void* nv,
                                    const void* q, int B, int V, int P, int L,
                                    const void* back_off, void* backing, void* cells, void* best,
                                    void* tape, void* tlen, void* qend, void* n_backing,
                                    void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
#define VG_LC_LAUNCH(PP)                                                                    \
  launch<PP>(B, V, L, (cudaStream_t)stream, (const int8_t*)vcodes, (const int*)vpred, \
             (const int*)nv, (const int8_t*)q, (const int*)back_off, (int16_t*)backing,      \
             (uint8_t*)cells, (float*)best, (int*)tape, (int*)tlen, (int*)qend,             \
             (int*)n_backing)
  switch (P) {
    case 2: return (int)VG_LC_LAUNCH(2);
    case 4: return (int)VG_LC_LAUNCH(4);
    case 8: return (int)VG_LC_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VG_LC_LAUNCH
}

// out[0..2]: CTAs a cluster, clusters the card keeps resident at once,
// dynamic shared memory per CTA in bytes
extern "C" int vg_poa_local_cluster_occupancy(int P, int W, int V, int* out) {
  switch (P) {
    case 2: return (int)occupancy<2>(W, V, out);
    case 4: return (int)occupancy<4>(W, V, out);
    case 8: return (int)occupancy<8>(W, V, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
