// POA traceback over the packed decision bits, for sm_90a.
//
// Replaces: vgaligner_tpu/ops/poa_device.py::traceback_batch, a device
// loop (an XLA while_loop of scans) with no Pallas kernel.  Bit-identical
// tape[b, :tlen[b]] and tlen.
//
// Per problem b, a walk from (v, j) = (best_sink[b], nq[b]) in state H
// through the H/E/F state machine until it reaches the virtual source
// (v = -2) at column 0:
//   H: a match case consumes (v, j) -> (pred, j-1); an E1/E2/F1/F2 case
//      switches state without a step of its own;
//   E (graph deletion): emit D at v, move to the stored pred slot, back
//      to H when that cell was opened (not extended);
//   F (in-row insertion): emit I at v, j-1, back to H when opened;
//   at the virtual source every remaining column is an insertion.
// Each step writes op | (vid + 2) << 2 (vid -1 for the source); the rest
// of the T = V + W + 1 entries hold OP_END | 1 << 2, and tlen counts the
// non-END entries.  The tape is int32 here (the JAX tape is u16 with the
// same values); the host unpacks op = e & 3, vid = (e >> 2) - 2.
// Out-of-range indices are normalised and clamped as JAX's gathers do,
// so padding problems walk junk safely.
//
// What bounds it on the card: a walk is a chain of dependent loads (the
// decision word, then the predecessor id), about nq + deletions steps,
// so latency, not bandwidth or arithmetic.
//
// Design: one thread per problem; the walk's state lives in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_END = 3;
constexpr int END_FILL = OP_END | (1 << 2);
constexpr int VIRT_SLOT = 15;

__global__ void poa_traceback_kernel(const int* __restrict__ tbits,
                                     const int* __restrict__ vpred,
                                     const int* __restrict__ best_sink,
                                     const int* __restrict__ nq, int B, int V, int C,
                                     int P, int T, int* __restrict__ tape,
                                     int* __restrict__ tlen) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int v = best_sink[b], j = nq[b], st = 0;
  int* tp = tape + (size_t)b * T;
  int n = 0;
  for (; n < T; ++n) {
    if (v == -2 && j == 0) break;
    const int vc = min(max(v, 0), V - 1);
    int jj = j < 0 ? j + C : j;
    jj = min(max(jj, 0), C - 1);
    const int bits = tbits[((size_t)b * V + vc) * C + jj];
    const int cas = bits & 7;
    const int m_slot = (bits >> 3) & 15;
    const bool at_h = st == 0;
    const bool is_match = at_h && cas == 0;
    const int sw = (at_h && !is_match) ? cas : st;
    const bool in_e = sw == 1 || sw == 2;
    const int e_opn = sw == 1 ? (bits >> 7) & 1 : (bits >> 12) & 1;
    const int e_slot = sw == 1 ? (bits >> 8) & 15 : (bits >> 13) & 15;
    const int go_slot = in_e ? e_slot : m_slot;
    const int go_nxt =
        go_slot == VIRT_SLOT ? -2 : vpred[((size_t)b * V + vc) * P + min(go_slot, P - 1)];
    const bool in_f = sw == 3 || sw == 4;
    const int f_opn = sw == 3 ? (bits >> 17) & 1 : (bits >> 18) & 1;
    const bool from_virtual = v == -2;

    const int op = (from_virtual || in_f) ? OP_I : (in_e ? OP_D : OP_M);
    const int vid = from_virtual ? -1 : v;
    tp[n] = (op | ((vid + 2) << 2)) & 0xFFFF;
    const int v2 = (from_virtual || in_f) ? v : go_nxt;
    const int j2 = (from_virtual || in_f || is_match) ? j - 1 : j;
    int st2;
    if (from_virtual || is_match) {
      st2 = 0;
    } else if (in_e) {
      st2 = e_opn ? 0 : sw;
    } else if (in_f) {
      st2 = f_opn ? 0 : sw;
    } else {
      st2 = st;
    }
    v = v2;
    j = j2;
    st = st2;
  }
  tlen[b] = n;
  for (int t = n; t < T; ++t) tp[t] = END_FILL;
}

}  // namespace

extern "C" int vg_poa_traceback(const void* tbits, const void* vpred,
                                const void* best_sink, const void* nq, int B, int V,
                                int C, int P, void* tape, void* tlen, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int T = V + C + 1;
  const int threads = 128;
  poa_traceback_kernel<<<(B + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
      (const int*)tbits, (const int*)vpred, (const int*)best_sink, (const int*)nq, B, V,
      C, P, T, (int*)tape, (int*)tlen);
  return (int)cudaGetLastError();
}
