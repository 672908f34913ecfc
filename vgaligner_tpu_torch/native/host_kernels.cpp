// TPU-native host runtime kernels for vgaligner_tpu.
//
// The device side of the framework is JAX/XLA (chaining DP, POA DP);
// this library is the native host runtime around it, replacing the
// Python hot loops that feed and drain the device:
//
//   * vg_kmer_index      — graph k-mer DFS enumeration + linearized
//                          position conversion (the index-build hot
//                          loops; behavioral reference
//                          rs-vgaligner src/kmer.rs:93-505,816-928,
//                          mirrored from vgaligner_tpu/index/kmer_gen.py)
//   * vg_build_poa_batch — chain-implied subgraph -> padded POA problem
//                          arrays (topological order + base-level
//                          expansion; reference align.rs:670-724,
//                          mirrors ops/poa.py build_base_graph +
//                          ops/poa_device.py prepare_problem)
//   * vg_finish_tapes    — device op tapes -> CIGAR / cs strings and
//                          node paths (reference align.rs:1096-1167,
//                          mirrors ops/poa.py _finish_result)
//
// Exact-parity contract: each function must produce byte-identical
// results to its Python reference implementation (tests/test_native.py
// asserts equivalence); the Python paths remain as fallbacks.
//
// Build: g++ -O3 -march=native -shared -fPIC (see native/__init__.py).

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <deque>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// Host-side data parallelism for the per-read runtime helpers.  The
// reference is single-threaded by accident (rayon compiled out,
// SURVEY.md §1); this framework's host runtime parallelizes its
// per-read loops — the comparison baseline (vg_baseline_*) stays
// single-threaded and does NOT use this.
int64_t vg_threads() {
  const char* e = std::getenv("VGALIGNER_NATIVE_THREADS");
  if (e && *e) {
    long v = std::atol(e);
    return v >= 1 ? (int64_t)v : 1;
  }
  unsigned hc = std::thread::hardware_concurrency();
  int64_t v = hc ? (int64_t)hc : 1;
  return v > 16 ? 16 : v;
}

template <class F>
void parallel_for(int64_t n, F&& f) {
  int64_t nt = vg_threads();
  if (nt > n) nt = n;
  if (nt <= 1) {
    for (int64_t i = 0; i < n; ++i) f(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> ts;
  ts.reserve((size_t)nt);
  for (int64_t t = 0; t < nt; ++t)
    ts.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(16);
        if (i >= n) break;
        int64_t e = i + 16 < n ? i + 16 : n;
        for (int64_t j = i; j < e; ++j) f(j);
      }
    });
  for (auto& t : ts) t.join();
}

}  // namespace

namespace {

// record the SMALLEST failing problem index (1-based) under concurrent
// reporters — a plain store would let an arbitrary thread's index win
inline void store_min_err(std::atomic<int64_t>& err, int64_t v) {
  int64_t cur = err.load(std::memory_order_relaxed);
  while ((cur == 0 || v < cur) &&
         !err.compare_exchange_weak(cur, v, std::memory_order_relaxed)) {
  }
}

inline int8_t base_code(char c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return 4;
  }
}

// dna.rs:19-33 switch_base semantics (U->A, unknown->'N', case kept)
inline char complement(char c) {
  switch (c) {
    case 'a': return 't'; case 'c': return 'g'; case 't': return 'a';
    case 'g': return 'c'; case 'u': return 'a';
    case 'A': return 'T'; case 'C': return 'G'; case 'T': return 'A';
    case 'G': return 'C'; case 'U': return 'A';
    default: return 'N';
  }
}

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

}  // namespace

extern "C" {

void vg_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// K-mer enumeration + position conversion (kmer.rs:93-505, 816-928)
// ---------------------------------------------------------------------------

namespace {

struct Km {
  char seq[32];
  int32_t len;
  int8_t begin_orient, end_orient;  // 0 fwd, 1 rev (of the *handle*)
  int32_t begin_off, end_off;
  int64_t first_handle, last_handle;
  uint8_t handle_orient;
  int32_t forks;
};


// ---------------------------------------------------------------------------
// ahash 0.7.6 zero-seed fallback hash (reconstruction; see
// vgaligner_tpu/utils/ahash.py for provenance + caveat).  Used by the
// modimizer so `-r` samples the same k-mer set as the reference's
// generate_hash (kmer.rs:931-934).
// ---------------------------------------------------------------------------
namespace ahash07 {
constexpr uint64_t kMultiple = 6364136223846793005ull;
constexpr int kRot = 23;
constexpr uint64_t kPi2[4] = {0x452821E638D01377ull, 0xBE5466CF34E90C6Cull,
                              0xC0AC29B7C97C50DDull, 0x3F84D5B5B5470917ull};

inline uint64_t folded_multiply(uint64_t s, uint64_t by) {
  unsigned __int128 r = (unsigned __int128)s * by;
  return (uint64_t)r ^ (uint64_t)(r >> 64);
}
inline uint64_t rotl64(uint64_t x, unsigned n) {
  n &= 63;
  return n ? (x << n) | (x >> (64 - n)) : x;
}
inline uint64_t read_le(const char* p, int n) {
  uint64_t v = 0;
  for (int i = n - 1; i >= 0; --i) v = (v << 8) | (uint8_t)p[i];
  return v;
}

struct Hasher {
  uint64_t buffer, pad, xk0, xk1;
  Hasher()
      : buffer(kPi2[0]), pad(kPi2[1]), xk0(kPi2[2]), xk1(kPi2[3]) {}
  void update(uint64_t v) { buffer = folded_multiply(v ^ buffer, kMultiple); }
  void large_update(uint64_t lo, uint64_t hi) {
    uint64_t combined = folded_multiply(lo ^ xk0, hi ^ xk1);
    buffer = rotl64((buffer + pad) ^ combined, kRot);
  }
  void write(const char* data, int64_t n) {
    buffer = (buffer + (uint64_t)n) * kMultiple;
    if (n > 8) {
      if (n > 16) {
        large_update(read_le(data + n - 16, 8), read_le(data + n - 8, 8));
        while (n > 16) {
          large_update(read_le(data, 8), read_le(data + 8, 8));
          data += 16;
          n -= 16;
        }
      } else {
        large_update(read_le(data, 8), read_le(data + n - 8, 8));
      }
    } else if (n >= 2) {
      if (n >= 4) {
        large_update(read_le(data, 4), read_le(data + n - 4, 4));
      } else {
        large_update(read_le(data, 2), (uint8_t)data[n - 1]);
      }
    } else if (n == 1) {
      large_update((uint8_t)data[0], (uint8_t)data[0]);
    } else {
      large_update(0, 0);
    }
  }
  uint64_t finish() const {
    return rotl64(folded_multiply(buffer, pad), (unsigned)(buffer & 63));
  }
};

// RandomState::with_seeds(0,0,0,0) + String::hash + finish
inline uint64_t hash_str(const char* s, int64_t n) {
  Hasher h;
  h.write(s, n);
  h.update(0xff);  // write_u8 terminator of str::hash
  return h.finish();
}
}  // namespace ahash07

extern "C" uint64_t vg_ahash07(const char* s, int64_t n) {
  return ahash07::hash_str(s, n);
}

struct U128Hash {
  size_t operator()(unsigned __int128 v) const {
    uint64_t lo = (uint64_t)v, hi = (uint64_t)(v >> 64);
    return (size_t)(lo ^ (hi * 0x9e3779b97f4a7c15ull));
  }
};

inline bool km_key_eq(const Km& a, const Km& b) {
  return a.len == b.len && std::memcmp(a.seq, b.seq, a.len) == 0 &&
         a.begin_orient == b.begin_orient && a.begin_off == b.begin_off &&
         a.end_orient == b.end_orient && a.end_off == b.end_off &&
         a.first_handle == b.first_handle && a.last_handle == b.last_handle &&
         a.handle_orient == b.handle_orient && a.forks == b.forks;
}

struct GraphView {
  int64_t n;
  const char* labels;
  const int64_t* label_off;  // [n+1]
  const int64_t* l_off;      // [n+1] left-edge CSR
  const int64_t* l_dat;      // packed handles, insertion order
  const int64_t* r_off;
  const int64_t* r_dat;

  int64_t label_len(int64_t id) const {  // ids are 1-based contiguous
    return label_off[id] - label_off[id - 1];
  }
  // base at position p of the handle-oriented label (revcomp for reverse)
  char base_at(int64_t handle, int64_t p) const {
    int64_t id = handle >> 1;
    const char* lab = labels + label_off[id - 1];
    int64_t len = label_len(id);
    if (handle & 1) return complement(lab[len - 1 - p]);
    return lab[p];
  }
  // right_neighbors(handle): rev ? flipped left list : right list
  void right_neighbors(int64_t handle, std::vector<int64_t>& out) const {
    out.clear();
    int64_t id = handle >> 1;
    if (handle & 1) {
      for (int64_t e = l_off[id - 1]; e < l_off[id]; ++e)
        out.push_back(l_dat[e] ^ 1);
    } else {
      for (int64_t e = r_off[id - 1]; e < r_off[id]; ++e)
        out.push_back(r_dat[e]);
    }
  }
};

// All k-mers starting in `handle` (kmer.rs:347-505). Returns false when
// the whole handle+orientation is aborted by an N (drop_handle_on_n).
// state_cap bounds the DFS states (start offsets + stack pops) per
// handle+orientation: the reference's fork cap (max_furcations, default
// 100) never binds at k <= 100, so dense hubs of 1 bp nodes enumerate
// k-mer paths exponentially (measured 4e8 instances on HLA-zoo 5-B3106,
// one start alone 5e7 — the reference blows up identically).  The cap
// truncates enumeration in such regions (sensitivity loss only there);
// <= 0 disables.  Returns the number of capped starts via *capped.
int64_t g_states_used = 0;  // states consumed by the last call

bool kmers_for_handle_orient(const GraphView& g, int64_t handle,
                             bool orient, int32_t k, int64_t edge_max,
                             int64_t degree_max, int64_t sampling_rate,
                             int32_t sampling_mode,
                             bool drop_handle_on_n, int64_t state_cap,
                             int64_t* capped,
                             std::vector<Km>& complete_out,
                             std::vector<Km>& scratch_stack,
                             std::vector<int64_t>& nbrs,
                             std::vector<int64_t>& nbrs2,
                             std::unordered_set<unsigned __int128, U128Hash>*
                                 seen_states) {
  size_t base_out = complete_out.size();
  int64_t states = 0;
  struct StatesOut {
    int64_t* s;
    ~StatesOut() { g_states_used = *s; }
  } states_out{&states};
  // DFS state merging (dedup-positions mode): two pending states with
  // the same (begin_off, prefix, pending handle) complete to identical
  // position rows, differing at most in the reference's fork-count
  // field — exactly the records its adjacent-only dedup fails to
  // collapse (measured 104x duplicate rows on HLA-zoo 5-B3106).
  // Merging them turns the exponential fork-path enumeration into a
  // polynomial walk.  Key packs begin_off(32) len(6) handle(34)
  // prefix(2 bits/base), exact for k <= 27; chars outside ACGT skip
  // merging for that state.
  if (seen_states) seen_states->clear();
  auto try_push = [&](std::vector<Km>& stack, const Km& inc) {
    ++states;  // attempts count as work: state merging must not let a
               // hub region spend the whole global budget productively
               // enumerating forever (MICB-class graphs)
    if (seen_states && k <= 27) {
      unsigned __int128 key = (uint32_t)inc.begin_off;
      key |= (unsigned __int128)(uint32_t)inc.len << 32;
      key |= (unsigned __int128)(uint64_t)inc.last_handle << 38;
      bool pack_ok = true;
      unsigned __int128 sk = 0;
      for (int32_t i2 = 0; i2 < inc.len; ++i2) {
        char ch = inc.seq[i2];
        // uppercase ACGT only: base_code folds case, and merging 'a'
        // with 'A' would collapse records the seq sort distinguishes
        if (ch != 'A' && ch != 'C' && ch != 'G' && ch != 'T') {
          pack_ok = false;
          break;
        }
        sk = (sk << 2) | (unsigned __int128)(uint8_t)base_code(ch);
      }
      if (pack_ok) {
        key |= sk << 72;
        if (!seen_states->insert(key).second) return;
      }
    }
    stack.push_back(inc);
  };
  g.right_neighbors(handle, nbrs);
  if (degree_max >= 0 && (int64_t)nbrs.size() > degree_max) return true;

  int64_t id = handle >> 1;
  int64_t handle_len = g.label_len(id);
  int8_t h_or = (handle & 1) ? 1 : 0;
  bool limits = edge_max >= 0 || degree_max >= 0;

  auto keep = [&](const Km& km) {
    if (sampling_rate <= 0) return true;
    if (sampling_mode == 0)  // ahash: the reference's sampled set
      return ahash07::hash_str(km.seq, km.len) % (uint64_t)sampling_rate ==
             0;
    uint64_t code = 0;
    for (int32_t i = 0; i < km.len; ++i) {
      int8_t c = base_code(km.seq[i]);
      if (c >= 4) { code = (uint64_t)(-1); break; }
      code = (code << 2) | (uint64_t)c;
    }
    return splitmix64(code) % (uint64_t)sampling_rate == 0;
  };

  std::vector<Km>& incomplete = scratch_stack;
  incomplete.clear();

  for (int64_t i = 0; i < handle_len; ++i) {
    int64_t end = std::min<int64_t>(i + k, handle_len);
    Km km;
    km.len = (int32_t)(end - i);
    bool has_n = false;
    for (int64_t p = i; p < end; ++p) {
      char c = g.base_at(handle, p);
      km.seq[p - i] = c;
      if (c == 'N') has_n = true;
    }
    km.begin_orient = h_or;
    km.begin_off = (int32_t)i;
    km.end_orient = h_or;
    km.end_off = (int32_t)end;
    km.first_handle = handle;
    km.last_handle = handle;
    km.handle_orient = orient ? 1 : 0;
    km.forks = 0;

    if (has_n) {
      if (drop_handle_on_n) { complete_out.resize(base_out); return false; }
      continue;
    }
    if (km.len == k) {
      if (keep(km)) complete_out.push_back(km);
    } else {
      int64_t next_count = limits ? (int64_t)nbrs.size() : 0;
      if ((edge_max < 0 && degree_max < 0) ||
          (degree_max >= 0 && next_count < degree_max) ||
          (edge_max >= 0 && km.forks < edge_max)) {
        for (int64_t nb : nbrs) {
          Km inc = km;
          inc.last_handle = nb;
          if (next_count > 1) inc.forks += 1;
          try_push(incomplete, inc);
        }
      }
    }
  }

  // LIFO completion across edges (kmer.rs:449-497)
  while (!incomplete.empty()) {
    if (state_cap > 0 && ++states > state_cap) {
      ++*capped;
      break;
    }
    Km km = incomplete.back();
    incomplete.pop_back();
    int64_t h = km.last_handle;
    int64_t h_len = g.label_len(h >> 1);
    int64_t end = std::min<int64_t>(k - km.len, h_len);
    bool has_n = false;
    for (int64_t p = 0; p < end; ++p) {
      char c = g.base_at(h, p);
      km.seq[km.len + p] = c;
      if (c == 'N') has_n = true;
    }
    km.len += (int32_t)end;
    km.end_orient = (h & 1) ? 1 : 0;
    km.end_off = (int32_t)end;
    km.last_handle = h;

    if (has_n) {
      if (drop_handle_on_n) { complete_out.resize(base_out); return false; }
      continue;
    }
    if (km.len == k) {
      if (keep(km)) complete_out.push_back(km);
    } else {
      g.right_neighbors(h, nbrs2);
      int64_t next_count = limits ? (int64_t)nbrs2.size() : 0;
      for (int64_t nb : nbrs2) {
        if ((edge_max < 0 && degree_max < 0) ||
            (degree_max >= 0 && next_count < degree_max) ||
            (edge_max >= 0 && km.forks < edge_max)) {
          Km inc = km;
          inc.last_handle = nb;
          if (next_count > 1) inc.forks += 1;
          try_push(incomplete, inc);
        }
      }
    }
  }
  return true;
}

}  // namespace

// Enumerate, sort, dedup graph k-mers and convert to grouped linearized
// positions. Node ids must be contiguous 1..n (enforced by the caller,
// as in index.rs:489-498). Returns n_unique; outputs are malloc'd and
// must be released with vg_free.
// Shared tail of the k-mer table builders: stable sort by sequence,
// adjacent-duplicate dedup, group by sequence, convert to linearized
// position rows, and emit malloc'd arrays.  Factored out of
// vg_kmer_index so the native path-guided generator (vg_path_kmers)
// produces byte-identical table structure.
static int64_t finish_kmer_table(
    std::vector<Km>& kmers, const GraphView& g, const int64_t* node_starts,
    int64_t seq_len, int32_t dedup_positions, bool timing,
    int64_t** out_codes, int64_t** out_offsets, int64_t** out_counts,
    int64_t* out_n_pos, int64_t** out_positions) {
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  auto t_dfs = now();
  // stable sort by sequence only (kmer.rs:295-298), then dedup runs of
  // fully identical records (kmer.rs:299-301).  Sorting (packed key,
  // index) pairs and permuting once beats stable_sort moving ~80-byte
  // Km records with a memcmp comparator (tens of seconds on
  // budget-bound hub graphs like MICB, ~20M records): left-aligned
  // 2-bit base codes order exactly like memcmp (A<C<G<T in both), the
  // length in the low bits reproduces the shorter-first tie-break, and
  // the original index as the final key keeps the sort stable (the
  // reference's adjacent-duplicates dedup is insertion-order
  // dependent, so stability is a parity requirement).
  {
    typedef unsigned __int128 u128;
    struct KeyIdx { u128 key; };
    const size_t nk = kmers.size();
    std::vector<KeyIdx> ki(nk);
    // the 2-bit key is only memcmp-equivalent for uppercase ACGT
    // (base_code folds case and maps U/other to 4, which overflows the
    // slot); any other character falls back to the memcmp comparator
    bool plain_acgt = true;
    for (size_t t = 0; t < nk && plain_acgt; ++t) {
      const Km& km = kmers[t];
      u128 key = 0;
      for (int32_t p = 0; p < km.len; ++p) {
        char c = km.seq[p];
        if (c != 'A' && c != 'C' && c != 'G' && c != 'T') {
          plain_acgt = false;
          break;
        }
        key |= (u128)(uint8_t)base_code(c) << (120 - 2 * p);
      }
      // low 38 bits: len (6) then original index (32) for stability
      key |= (u128)(uint32_t)km.len << 32;
      key |= (u128)(uint32_t)t;
      ki[t].key = key;
    }
    if (!plain_acgt) {
      ki.clear(); ki.shrink_to_fit();
      std::stable_sort(kmers.begin(), kmers.end(),
                       [](const Km& a, const Km& b) {
        int c = std::memcmp(a.seq, b.seq, std::min(a.len, b.len));
        if (c != 0) return c < 0;
        return a.len < b.len;
      });
    } else {
      std::sort(ki.begin(), ki.end(),
                [](const KeyIdx& a, const KeyIdx& b) { return a.key < b.key; });
      // apply the permutation in place (sorted[j] = old[idx_j]); marking
      // consumed slots avoids a second ~GB-scale Km buffer
      std::vector<uint32_t> idx(nk);
      for (size_t t = 0; t < nk; ++t)
        idx[t] = (uint32_t)(ki[t].key & 0xffffffffu);
      ki.clear(); ki.shrink_to_fit();
      const uint32_t DONE = 0xffffffffu;
      for (size_t i = 0; i < nk; ++i) {
        if (idx[i] == DONE || idx[i] == i) { idx[i] = DONE; continue; }
        size_t j = i;
        Km tmp = kmers[i];
        while (true) {
          size_t src = idx[j];
          idx[j] = DONE;
          if (src == i) { kmers[j] = tmp; break; }
          kmers[j] = kmers[src];
          j = src;
        }
      }
    }
  }
  std::vector<Km> dedup;
  dedup.reserve(kmers.size());
  for (const Km& km : kmers) {
    if (!dedup.empty() && km_key_eq(dedup.back(), km)) continue;
    dedup.push_back(km);
  }
  auto t_sort = now();
  if (timing)
    fprintf(stderr, "vg_kmer_index: sort+dedup %.1fs (%zu unique records)\n",
            secs(t_dfs, t_sort), dedup.size());

  // group by sequence; positions on the linearization (kmer.rs:752-928)
  struct Row { int64_t so, s, eo, e; };
  std::vector<int64_t> codes, offsets, counts;
  std::vector<Row> rows;
  auto seq_pos = [&](int64_t handle) -> int64_t {
    int64_t id = handle >> 1;
    int64_t start = node_starts[id - 1];
    if (handle & 1) return seq_len - start - g.label_len(id);
    return start;
  };
  size_t i = 0;
  while (i < dedup.size()) {
    size_t j = i;
    while (j < dedup.size() && dedup[j].len == dedup[i].len &&
           std::memcmp(dedup[j].seq, dedup[i].seq, dedup[i].len) == 0)
      ++j;
    int64_t code = 0;
    bool bad = false;
    for (int32_t p = 0; p < dedup[i].len; ++p) {
      int8_t c = base_code(dedup[i].seq[p]);
      if (c >= 4) { bad = true; break; }
      code = (code << 2) | (int64_t)c;
    }
    codes.push_back(bad ? -1 : code);
    offsets.push_back((int64_t)rows.size());
    counts.push_back((int64_t)(j - i));
    size_t row0 = rows.size();
    for (size_t t = i; t < j; ++t) {
      const Km& km = dedup[t];
      rows.push_back(Row{(int64_t)km.begin_orient,
                         seq_pos(km.first_handle) + km.begin_off,
                         (int64_t)km.end_orient,
                         seq_pos(km.last_handle) + km.end_off});
    }
    std::sort(rows.begin() + row0, rows.end(),
              [](const Row& a, const Row& b) {
                if (a.so != b.so) return a.so < b.so;
                if (a.s != b.s) return a.s < b.s;
                if (a.eo != b.eo) return a.eo < b.eo;
                return a.e < b.e;
              });
    if (dedup_positions) {
      // exact duplicate rows only waste space and inflate per-read
      // anchor counts 100x on fork-dense graphs (the reference keeps
      // them only because its adjacent-only dedup misses non-adjacent
      // records, kmer.rs:299-301); --keep-duplicate-positions restores
      // the quirk
      auto it = std::unique(rows.begin() + row0, rows.end(),
                            [](const Row& a, const Row& b) {
                              return a.so == b.so && a.s == b.s &&
                                     a.eo == b.eo && a.e == b.e;
                            });
      rows.erase(it, rows.end());
      counts.back() = (int64_t)(rows.size() - row0);
    }
    i = j;
  }

  auto t_conv = now();
  if (timing)
    fprintf(stderr, "vg_kmer_index: convert %.1fs (%zu groups)\n",
            secs(t_sort, t_conv), codes.size());
  int64_t n_unique = (int64_t)codes.size();
  int64_t n_pos = (int64_t)rows.size();
  *out_codes = (int64_t*)std::malloc(sizeof(int64_t) * std::max<int64_t>(n_unique, 1));
  *out_offsets = (int64_t*)std::malloc(sizeof(int64_t) * std::max<int64_t>(n_unique, 1));
  *out_counts = (int64_t*)std::malloc(sizeof(int64_t) * std::max<int64_t>(n_unique, 1));
  *out_positions = (int64_t*)std::malloc(sizeof(int64_t) * std::max<int64_t>(n_pos * 4, 1));
  std::memcpy(*out_codes, codes.data(), sizeof(int64_t) * n_unique);
  std::memcpy(*out_offsets, offsets.data(), sizeof(int64_t) * n_unique);
  std::memcpy(*out_counts, counts.data(), sizeof(int64_t) * n_unique);
  for (int64_t r = 0; r < n_pos; ++r) {
    (*out_positions)[r * 4 + 0] = rows[r].so;
    (*out_positions)[r * 4 + 1] = rows[r].s;
    (*out_positions)[r * 4 + 2] = rows[r].eo;
    (*out_positions)[r * 4 + 3] = rows[r].e;
  }
  *out_n_pos = n_pos;
  return n_unique;
}

int64_t vg_kmer_index(
    int64_t n_nodes, const char* labels, const int64_t* label_off,
    const int64_t* l_off, const int64_t* l_dat, const int64_t* r_off,
    const int64_t* r_dat, const int64_t* node_starts, int64_t seq_len,
    int32_t k, int64_t edge_max, int64_t degree_max, int64_t sampling_rate,
    int32_t sampling_mode, int32_t drop_handle_on_n, int32_t dedup_positions,
    int64_t state_cap,
    int64_t* out_capped,
    int64_t** out_codes, int64_t** out_offsets, int64_t** out_counts,
    int64_t* out_n_pos, int64_t** out_positions) {
  GraphView g{n_nodes, labels, label_off, l_off, l_dat, r_off, r_dat};

  // env-gated phase timing (VGALIGNER_NATIVE_TIMING=1): the DFS /
  // sort / convert split on hub-dense graphs drives tuning decisions
  const bool timing = std::getenv("VGALIGNER_NATIVE_TIMING") != nullptr;
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  auto t_start = now();

  std::vector<Km> kmers;
  std::vector<Km> stack;
  std::vector<int64_t> nbrs, nbrs2;
  std::unordered_set<unsigned __int128, U128Hash> seen_states;
  int64_t capped = 0;
  // global budget: 8x the per-call cap (deterministic first-come
  // deduction; bounds the whole build on hub-dense graphs where even
  // per-call caps x thousands of handles explode the sort/convert —
  // with DFS state merging each budget unit is productive, so a 4M
  // budget covers more distinct k-mers than the old 20M did through
  // duplicate fork paths)
  int64_t budget = state_cap > 0 ? state_cap * 8 : 0;
  for (int64_t id = 1; id <= n_nodes; ++id) {
    // orientation order True, False (kmer_gen.py generate_kmers)
    for (int o = 0; o < 2; ++o) {
      int64_t cap = state_cap;
      if (state_cap > 0) {
        if (budget <= 0) { ++capped; continue; }
        cap = std::min(state_cap, budget);
      }
      int64_t before = capped;
      size_t n_before = kmers.size();
      kmers_for_handle_orient(g, (id << 1) | o, o == 0, k, edge_max,
                              degree_max, sampling_rate, sampling_mode,
                              drop_handle_on_n != 0, cap,
                              &capped, kmers, stack, nbrs, nbrs2,
                              dedup_positions ? &seen_states : nullptr);
      (void)before; (void)n_before;
      if (state_cap > 0) budget -= g_states_used;
    }
  }
  if (out_capped) *out_capped = capped;
  auto t_dfs = now();
  if (timing)
    fprintf(stderr, "vg_kmer_index: dfs %.1fs (%zu records)\n",
            secs(t_start, t_dfs), kmers.size());

  int64_t n_unique = finish_kmer_table(
      kmers, g, node_starts, seq_len, dedup_positions, timing,
      out_codes, out_offsets, out_counts, out_n_pos, out_positions);
  return n_unique;
}



// Path-guided k-mer enumeration (kmer.rs:510-728; mirrors
// kmer_gen.py generate_kmers_linearly including its quirks: freshly
// started reverse-strand k-mers store `begin` in end_offset
// (kmer.rs:685) and extension overwrites end_offset with the ADDED
// length (extend_kmer, kmer.rs:80-84); N-containing k-mers are
// dropped, k > 32 rejected).  Emits the same table structure as
// vg_kmer_index via finish_kmer_table.
int64_t vg_path_kmers(
    int64_t n_nodes, const char* labels, const int64_t* label_off,
    const int64_t* node_starts, int64_t seq_len,
    int64_t n_paths, const int64_t* path_off, const int64_t* path_handles,
    int32_t k, int32_t dedup_positions,
    int64_t** out_codes, int64_t** out_offsets, int64_t** out_counts,
    int64_t* out_n_pos, int64_t** out_positions) {
  if (k > 32) return -1;
  GraphView g{n_nodes, labels, label_off, nullptr, nullptr, nullptr,
              nullptr};
  const bool timing = std::getenv("VGALIGNER_NATIVE_TIMING") != nullptr;
  std::vector<Km> kmers;
  std::vector<Km> prev_inc, curr_inc;
  std::string hseq;
  for (int rev = 0; rev < 2; ++rev) {
    for (int64_t p = 0; p < n_paths; ++p) {
      int64_t p0 = path_off[p], p1 = path_off[p + 1];
      prev_inc.clear();
      for (int64_t t = 0; t < p1 - p0; ++t) {
        int64_t h = rev ? (path_handles[p1 - 1 - t] ^ 1)
                        : path_handles[p0 + t];
        int64_t h_len = g.label_len(h >> 1);
        int8_t h_or = (h & 1) ? 1 : 0;
        hseq.resize((size_t)h_len);
        for (int64_t i = 0; i < h_len; ++i) hseq[(size_t)i] = g.base_at(h, i);
        curr_inc.clear();
        for (Km km : prev_inc) {  // FIFO completion
          int64_t end = std::min<int64_t>(k - km.len, h_len);
          bool has_n = false;
          for (int64_t i2 = 0; i2 < end; ++i2) {
            km.seq[km.len + i2] = hseq[(size_t)i2];
            if (hseq[(size_t)i2] == 'N') has_n = true;
          }
          km.len += (int32_t)end;
          km.end_orient = h_or;
          km.end_off = (int32_t)end;  // extend_kmer: length added
          km.last_handle = h;
          if (has_n) continue;
          if (km.len == k) kmers.push_back(km);
          else curr_inc.push_back(km);
        }
        for (int64_t i = 0; i < h_len; ++i) {
          int64_t end = std::min<int64_t>(i + k, h_len);
          Km km;
          km.len = (int32_t)(end - i);
          bool has_n = false;
          for (int64_t p2 = i; p2 < end; ++p2) {
            km.seq[p2 - i] = hseq[(size_t)p2];
            if (hseq[(size_t)p2] == 'N') has_n = true;
          }
          km.begin_orient = h_or;
          km.begin_off = (int32_t)i;
          km.end_orient = h_or;
          // reference quirk: the reverse generator stores `begin` as
          // the end offset (kmer.rs:685)
          km.end_off = (int32_t)(rev ? i : end);
          km.first_handle = h;
          km.last_handle = h;
          km.handle_orient = rev ? 0 : 1;
          km.forks = 0;
          if (has_n) continue;
          if (km.len == k) kmers.push_back(km);
          else curr_inc.push_back(km);
        }
        prev_inc.swap(curr_inc);
      }
    }
  }
  return finish_kmer_table(kmers, g, node_starts, seq_len,
                           dedup_positions, timing, out_codes, out_offsets,
                           out_counts, out_n_pos, out_positions);
}


// Single-pass POA v4 wire packer (ops/poa_device.py kernel_prepare's
// d_pack stage): row-pack the vertex-code and slot-0-delta planes as
// nibbles and collect the exception list, in ONE traversal of the
// dense [B,V,P] predecessor table.  The numpy pipeline it replaces
// (encode_pred_deltas + pack_rows + nibble_fold x3 +
// exception_pred_deltas) materialized ~7 temporaries and measured
// ~115 ms/drain on the 1-core bench host; as a ctypes call it also
// runs with the GIL released, so the streaming pipeline's worker can
// overlap it.  Returns 0, or -1 when an exception delta falls outside
// uint16 (caller falls back to the int32-pred v3 wire).
int64_t vg_pack_poa_wire(
    int64_t B, int64_t V, int64_t P,
    const int8_t* vcodes /* [B,V] code | sink<<5 */,
    const int32_t* vpred /* [B,V,P] */, const int32_t* nv /* [B] */,
    int64_t max_delta,
    uint8_t* vnib /* [t_pad/2] zeroed */, uint8_t* dnib /* [t_pad/2] */,
    int32_t** out_exc_idx, uint16_t** out_exc_pd, int64_t* out_n_exc,
    int64_t* out_dmax) {
  std::vector<int32_t> exc_idx;
  std::vector<uint16_t> exc_pd;
  int64_t dmax = 0;
  int64_t t = 0;  // row-packed output position
  for (int64_t b = 0; b < B; ++b) {
    const int64_t n = nv[b];
    const int8_t* vc = vcodes + b * V;
    const int32_t* vp = vpred + b * V * P;
    for (int64_t v = 0; v < n; ++v, ++t) {
      uint8_t vn = (uint8_t)((vc[v] & 7) | (((vc[v] >> 5) & 1) << 3));
      uint8_t dn = 0;
      const int32_t* pr = vp + v * P;
      int32_t p0 = pr[0];
      if (p0 >= 0) {
        int64_t d = v - p0;
        if (d >= 1 && d <= max_delta) {
          dn = (uint8_t)d;
        } else {
          if (d < 1 || d > 0xFFFF) return -1;
          exc_idx.push_back((int32_t)((b * V + v) * P));
          exc_pd.push_back((uint16_t)d);
        }
        if (d > dmax) dmax = d;
      }
      for (int64_t sp = 1; sp < P; ++sp) {
        int32_t pv = pr[sp];
        if (pv < 0) continue;
        int64_t d = (int64_t)v - pv;
        if (d < 1 || d > 0xFFFF) return -1;
        exc_idx.push_back((int32_t)((b * V + v) * P + sp));
        exc_pd.push_back((uint16_t)d);
        if (d > dmax) dmax = d;
      }
      if (t & 1) {
        vnib[t >> 1] |= (uint8_t)(vn << 4);
        dnib[t >> 1] |= (uint8_t)(dn << 4);
      } else {
        vnib[t >> 1] = vn;
        dnib[t >> 1] = dn;
      }
    }
  }
  int64_t e = (int64_t)exc_idx.size();
  *out_exc_idx =
      (int32_t*)std::malloc(sizeof(int32_t) * std::max<int64_t>(e, 1));
  *out_exc_pd =
      (uint16_t*)std::malloc(sizeof(uint16_t) * std::max<int64_t>(e, 1));
  std::memcpy(*out_exc_idx, exc_idx.data(), sizeof(int32_t) * e);
  std::memcpy(*out_exc_pd, exc_pd.data(), sizeof(uint16_t) * e);
  *out_n_exc = e;
  *out_dmax = dmax;
  return 0;
}

// ---------------------------------------------------------------------------
// Batch subgraph -> padded POA problem arrays (align.rs:670-724;
// mirrors ops/poa.py build_base_graph + ops/poa_device.py
// prepare_problem, including the FIFO Kahn order and cycle fallback)
// ---------------------------------------------------------------------------

// Inputs are a batch of B problems, concatenated:
//   labels / label_off[prob_node_off[B]+1]: node labels per problem
//   prob_node_off[B+1]: node-count prefix; prob_edge_off[B+1]
//   edges[2*total_edges] (a, b) 0-based within each problem
// Caller-allocated outputs:
//   vcodes   int8  [B * v_pad]   (pad value 4)
//   vpred    int32 [B * v_pad * p_max] (-1 pad)
//   is_sink  uint8 [B * v_pad]
//   nv       int32 [B]
//   node_of  int32 [B * v_pad]   (original node index per vertex)
//   off_in   int32 [B * v_pad]
// `sel` picks which of the concatenated problems to build (batch row s
// reads problem sel[s]) so bucket slicing never copies label data.
// Returns 0 on success; (s+1) if row s exceeds v_pad or fan-in p_max.
int64_t vg_build_poa_batch(
    int64_t B, const int64_t* sel, const char* labels,
    const int64_t* label_off, const int64_t* prob_node_off,
    const int64_t* prob_edge_off, const int64_t* edges, int64_t v_pad,
    int64_t p_max, int8_t* vcodes, int32_t* vpred, uint8_t* is_sink,
    int32_t* nv, int32_t* node_of, int32_t* off_in) {
  std::memset(vcodes, 4, (size_t)(B * v_pad));
  std::fill(vpred, vpred + B * v_pad * p_max, -1);
  std::memset(is_sink, 0, (size_t)(B * v_pad));
  std::memset(node_of, 0, sizeof(int32_t) * (size_t)(B * v_pad));
  std::memset(off_in, 0, sizeof(int32_t) * (size_t)(B * v_pad));

  // per-problem outputs land in disjoint [s*v_pad, (s+1)*v_pad) ranges,
  // so problems build data-parallel (thread-local scratch); the smallest
  // failing problem index (1-based) is reported (store_min_err)
  std::atomic<int64_t> err(0);
  parallel_for(B, [&](int64_t s) {
    if (err.load(std::memory_order_relaxed)) return;
    std::vector<int64_t> out_head, out_next, out_dst;
    std::vector<int64_t> indeg, topo, order_pos, node_first, node_last;
    std::vector<uint8_t> seen, has_pred, has_succ;
    int64_t p = sel ? sel[s] : s;
    int64_t n0 = prob_node_off[p], n1 = prob_node_off[p + 1];
    int64_t e0 = prob_edge_off[p], e1 = prob_edge_off[p + 1];
    int64_t n = n1 - n0;

    // Kahn's algorithm, FIFO, stable in list order (ops/poa.py:70-89)
    out_head.assign(n, -1);
    out_next.assign(std::max<int64_t>(e1 - e0, 1), -1);
    out_dst.assign(std::max<int64_t>(e1 - e0, 1), -1);
    indeg.assign(n, 0);
    // adjacency preserving edge order: build reversed then walk reversed
    for (int64_t e = e1 - 1; e >= e0; --e) {
      int64_t a = edges[2 * e], b = edges[2 * e + 1];
      int64_t slot = e - e0;
      out_dst[slot] = b;
      out_next[slot] = out_head[a];
      out_head[a] = slot;
      indeg[b] += 1;
    }
    topo.clear();
    seen.assign(n, 0);
    std::deque<int64_t> ready;
    for (int64_t v = 0; v < n; ++v)
      if (indeg[v] == 0) ready.push_back(v);
    while (!ready.empty()) {
      int64_t cur = ready.front();
      ready.pop_front();
      topo.push_back(cur);
      seen[cur] = 1;
      for (int64_t s = out_head[cur]; s != -1; s = out_next[s]) {
        if (--indeg[out_dst[s]] == 0) ready.push_back(out_dst[s]);
      }
    }
    if ((int64_t)topo.size() < n)  // cycle fallback: remaining in order
      for (int64_t v = 0; v < n; ++v)
        if (!seen[v]) topo.push_back(v);

    order_pos.assign(n, 0);
    for (int64_t t = 0; t < n; ++t) order_pos[topo[t]] = t;

    // base-level expansion in topo order
    node_first.assign(n, 0);
    node_last.assign(n, 0);
    int64_t vid = 0;
    int8_t* vc = vcodes + s * v_pad;
    int32_t* no = node_of + s * v_pad;
    int32_t* oi = off_in + s * v_pad;
    for (int64_t t = 0; t < n; ++t) {
      int64_t node = topo[t];
      int64_t g0 = label_off[n0 + node], g1 = label_off[n0 + node + 1];
      node_first[node] = vid;
      if (vid + (g1 - g0) > v_pad) { store_min_err(err, s + 1); return; }
      for (int64_t c = g0; c < g1; ++c) {
        vc[vid] = base_code(labels[c]);
        no[vid] = (int32_t)node;
        oi[vid] = (int32_t)(c - g0);
        ++vid;
      }
      node_last[node] = vid - 1;
    }
    nv[s] = (int32_t)vid;

    // predecessors: edge preds on node_first (edge order, skipping
    // cycle-fallback back-edges), then the intra-node chain
    int32_t* vp = vpred + s * v_pad * p_max;
    std::vector<int8_t> np_count(vid, 0);
    has_pred.assign(n, 0);
    has_succ.assign(n, 0);
    for (int64_t e = e0; e < e1; ++e) {
      int64_t a = edges[2 * e], b = edges[2 * e + 1];
      if (order_pos[a] < order_pos[b]) {
        int64_t v = node_first[b];
        if (np_count[v] >= p_max) { store_min_err(err, s + 1); return; }
        vp[v * p_max + np_count[v]++] = (int32_t)node_last[a];
        has_pred[b] = 1;
        has_succ[a] = 1;
      }
    }
    for (int64_t t = 0; t < n; ++t) {
      int64_t node = topo[t];
      for (int64_t v = node_first[node] + 1; v <= node_last[node]; ++v) {
        if (np_count[v] >= p_max) { store_min_err(err, s + 1); return; }
        vp[v * p_max + np_count[v]++] = (int32_t)(v - 1);
      }
    }
    uint8_t* sk = is_sink + s * v_pad;
    for (int64_t node = 0; node < n; ++node)
      if (!has_succ[node]) sk[node_last[node]] = 1;
  });
  return err.load();
}

// ---------------------------------------------------------------------------
// Chain -> subgraph extraction (align.rs:267-724; mirrors
// models/poa_aligner.py find_range_chain + extend_range_chain +
// find_nodes_edges over the index arrays)
// ---------------------------------------------------------------------------

namespace {

struct IndexView {
  int64_t n;                    // n_nodes
  const int64_t* node_starts;   // [n+1]
  const int64_t* edges;         // packed handles
  const int64_t* edge_idx;      // [n+1]
  const int64_t* edges_to_node; // [n]
  const char* seq_fwd;
  const char* seq_rev;
  int64_t seq_len;

  int64_t label_len(int64_t id) const {
    return node_starts[id] - node_starts[id - 1];
  }
  // index.rs:559-606 edge slices
  void incoming(int64_t handle, std::vector<int64_t>& out) const {
    out.clear();
    if (handle & 1) {
      std::vector<int64_t> tmp;
      outgoing(handle ^ 1, tmp);
      for (auto it = tmp.rbegin(); it != tmp.rend(); ++it) out.push_back(*it ^ 1);
      return;
    }
    int64_t id = handle >> 1;
    int64_t lo = edge_idx[id - 1];
    int64_t etn = edges_to_node[id - 1];
    for (int64_t e = lo; e < lo + etn; ++e) out.push_back(edges[e]);
  }
  void outgoing(int64_t handle, std::vector<int64_t>& out) const {
    out.clear();
    if (handle & 1) {
      std::vector<int64_t> tmp;
      incoming(handle ^ 1, tmp);
      for (auto it = tmp.rbegin(); it != tmp.rend(); ++it) out.push_back(*it ^ 1);
      return;
    }
    int64_t id = handle >> 1;
    int64_t lo = edge_idx[id - 1], hi = edge_idx[id];
    int64_t etn = edges_to_node[id - 1];
    for (int64_t e = lo + etn; e < hi; ++e) out.push_back(edges[e]);
  }
  // node_id_from_seqpos (index.rs:388-411): searchsorted equivalents
  int64_t node_id_fwd(int64_t pos) const {  // side='right' over [n+1]
    const int64_t* lo = node_starts;
    const int64_t* hi = node_starts + n + 1;
    return std::upper_bound(lo, hi, pos) - lo;
  }
  int64_t node_id_rev(int64_t pos) const {  // side='left' over [:n]
    const int64_t* lo = node_starts;
    const int64_t* hi = node_starts + n;
    return std::lower_bound(lo, hi, seq_len - pos) - lo;
  }
};

}  // namespace

// Batch chain -> (handles, node labels, edges) extraction.
// Chains are concatenated anchor arrays with anchor_off[B+1]; aso/aeo
// may be null (forward-only production chains, map.rs:62).
// All outputs are malloc'd; status[p] != 0 marks a failed problem
// (BFS guard, align-path divergence) for per-problem Python fallback.
int64_t vg_extract_subgraphs(
    int64_t n_nodes, const int64_t* node_starts, const int64_t* edges,
    const int64_t* edge_idx, const int64_t* edges_to_node,
    const char* seq_fwd, const char* seq_rev, int64_t seq_len,
    int64_t B, const int64_t* anchor_off, const int64_t* aqb,
    const int64_t* atb, const int64_t* ate, const int8_t* aso,
    const int8_t* aeo, const int64_t* qlen, int64_t k, int32_t closure,
    int64_t** out_handle_off, int64_t** out_handles,
    int64_t** out_label_off, int64_t** out_lbase, char** out_labels,
    int64_t** out_edge_off, int64_t** out_edges,
    uint8_t** out_status) {
  IndexView ix{n_nodes, node_starts, edges, edge_idx, edges_to_node,
               seq_fwd, seq_rev, seq_len};

  std::vector<int64_t> handle_off(1, 0), handles_all;
  std::vector<int64_t> label_off(1, 0), lbase_all;
  std::string labels_all;
  std::vector<int64_t> edge_off(1, 0), edges_all;
  std::vector<uint8_t> status(B, 0);

  // problems extract data-parallel into per-problem buffers
  // (thread-local scratch), then concatenate serially below
  struct PerProb {
    std::vector<int64_t> handles;
    std::string labels;
    std::vector<int64_t> llen;   // label length per handle
    std::vector<int64_t> lbase;  // label's base offset within the node
                                 // (corridor flank trim 'from'; 0 else)
    std::vector<int64_t> edges;  // (i, j) pairs flattened
  };
  std::vector<PerProb> results((size_t)B);

  parallel_for(B, [&](int64_t p) {
    // thread-local scratch: constructing these (the hash map above
    // all) per problem measured as real churn across a 4k-chain batch
    thread_local std::vector<int64_t> hlist, nbrs;
    thread_local std::vector<std::pair<int64_t, int64_t>> frontier, nxt;
    // corridor-mode flank-node label trims: handle -> [from, to) within
    // the node label (see corridor block)
    thread_local std::unordered_map<int64_t,
                                    std::pair<int64_t, int64_t>> trim;
    hlist.clear();
    nbrs.clear();
    frontier.clear();
    nxt.clear();
    trim.clear();
    PerProb& R = results[(size_t)p];
    int64_t a0 = anchor_off[p], a1 = anchor_off[p + 1];
    int64_t na = a1 - a0;

    // ---- find_range_chain (align.rs:267-402) -------------------------
    int64_t min_handle = INT64_MAX, max_handle = INT64_MIN;
    for (int64_t a = a0; a < a1; ++a) {
      for (int s = 0; s < 2; ++s) {
        int64_t pos = s == 0 ? atb[a] : ate[a] - 1;
        int8_t orient = 0;
        if (s == 0 && aso) orient = aso[a];
        if (s == 1 && aeo) orient = aeo[a];
        int64_t id = orient == 0 ? ix.node_id_fwd(pos) : ix.node_id_rev(pos);
        int64_t h = (id << 1) | (orient != 0 ? 1 : 0);
        min_handle = std::min(min_handle, h);
        max_handle = std::max(max_handle, h);
      }
    }
    int64_t lo = min_handle >> 1, hi = max_handle >> 1;
    bool min_rev = min_handle & 1, max_rev = max_handle & 1;
    int orient_kind;  // 0 fwd, 1 rev, 2 both
    if (!min_rev && !max_rev) {
      orient_kind = 0;
      for (int64_t i = lo; i <= hi; ++i) hlist.push_back(i << 1);
    } else if (min_rev && max_rev) {
      orient_kind = 1;
      for (int64_t i = lo; i <= hi; ++i) hlist.push_back((i << 1) | 1);
    } else {
      orient_kind = 2;
      for (int64_t i = lo; i <= hi; ++i) {
        hlist.push_back(i << 1);
        hlist.push_back((i << 1) | 1);
      }
    }
    if (hlist.empty() && min_handle == max_handle) hlist.push_back(min_handle);
    int64_t first_handle = hlist.front(), last_handle = hlist.back();

    bool failed = false;
    bool corridor_done = false;

    // ---- corridor range (closure == 2; topology-aware replacement for
    // the contiguous-id range — see models/poa_aligner.py
    // find_range_chain_corridor for the rationale and measured wins).
    // Forward-orient chains only; anything else keeps the reference
    // range below. --------------------------------------------------
    if (closure == 2 && orient_kind == 0 && na > 0) {
      // densest anchor window: a chain can ladder across tandem repeat
      // copies far beyond the read (anchors of a 100 bp read spanning
      // kb of target — the gap cost bounds each LINK, not the total);
      // keep the window with the most anchors whose target span fits
      // qlen + 2*slack and build the corridor between ITS endpoints
      // (mirrors models/poa_aligner.py find_range_chain_corridor)
      int64_t bi = a0, bj = a1 - 1;
      int64_t span_cap = qlen[p] + 2 * 128;
      if (ate[a1 - 1] - atb[a0] > span_cap) {
        int64_t best_cnt = 0, i = a0;
        for (int64_t j = a0; j < a1; ++j) {
          while (ate[j] - atb[i] > span_cap) ++i;
          if (j - i + 1 > best_cnt) {
            best_cnt = j - i + 1;
            bi = i;
            bj = j;
          }
        }
      }
      int64_t start_id = ix.node_id_fwd(atb[bi]);
      int64_t end_id = ix.node_id_fwd(ate[bj] - 1);
      int64_t start_h = start_id << 1, end_h = end_id << 1;
      int64_t budget = qlen[p] + 128;
      // budgeted orientation-preserving walk; best remaining per handle
      auto walk = [&](int64_t seed, int64_t bud, bool inc,
                      std::unordered_map<int64_t, int64_t>& best) {
        frontier.clear();
        frontier.emplace_back(bud, seed);
        int guard = 0;
        while (!frontier.empty()) {
          if (++guard > 10000) { failed = true; return; }
          nxt.clear();
          for (auto& fr : frontier) {
            int64_t rem = fr.first, h = fr.second;
            auto it = best.find(h);
            if (it != best.end() && it->second >= rem) continue;
            best[h] = rem;
            int64_t rem2 = rem - ix.label_len(h >> 1);
            if (rem2 > 0) {
              if (inc) ix.incoming(h, nbrs); else ix.outgoing(h, nbrs);
              for (int64_t t : nbrs)
                if (!(t & 1)) nxt.emplace_back(rem2, t);
            }
          }
          frontier.swap(nxt);
        }
      };
      std::unordered_map<int64_t, int64_t> bf, bb, ext;
      // forward budget: the read starts (atb0 - node_start) bases into
      // the start node and extends <= qlen + slack, so the walk's
      // remaining budget after consuming the start node is
      // qlen + slack - (bases of start node past the anchor) — anchors
      // deep inside a huge node correctly keep the corridor inside it
      walk(start_h,
           (atb[bi] - node_starts[start_id - 1]) + budget, false, bf);
      if (!failed)
        walk(end_h,
             (node_starts[end_id] - ate[bj]) + budget, true, bb);
      if (!failed) {
        std::unordered_set<int64_t> members;
        for (auto& kv : bf)
          if (bb.count(kv.first)) members.insert(kv.first);
        members.insert(start_h);
        members.insert(end_h);
        // unaligned query prefix/suffix beyond the anchored nodes
        // (extend_range_chain_2 analog)
        int64_t prefix = aqb[bi];
        int64_t son = atb[bi] - node_starts[start_id - 1];
        prefix -= son > 0 ? son : 0;
        if (prefix > 0) {
          ix.incoming(start_h, nbrs);
          std::vector<int64_t> seeds(nbrs);
          for (int64_t s : seeds) {
            if ((s & 1) || failed) continue;
            walk(s, prefix, true, ext);
          }
          for (auto& kv : ext) members.insert(kv.first);
        }
        int64_t suffix = qlen[p] - (aqb[bj] + k);
        int64_t eon = node_starts[end_id] - ate[bj];
        suffix -= eon > 0 ? eon : 0;
        if (!failed && suffix > 0) {
          ext.clear();
          ix.outgoing(end_h, nbrs);
          std::vector<int64_t> seeds(nbrs);
          for (int64_t s : seeds) {
            if ((s & 1) || failed) continue;
            walk(s, suffix, false, ext);
          }
          for (auto& kv : ext) members.insert(kv.first);
        }
        if (!failed) {
          // Kahn topological order, smallest handle first on ties; a
          // cyclic remainder is appended in id order (its unresolved
          // in-edges are dropped by the position filter, matching
          // build_base_graph's cycle handling)
          std::unordered_map<int64_t, int64_t> indeg;
          std::unordered_map<int64_t, std::vector<int64_t>> succ;
          for (int64_t h : members) indeg.emplace(h, 0);
          for (int64_t h : members) {
            ix.outgoing(h, nbrs);
            for (int64_t t : nbrs)
              if (t != h && indeg.count(t)) {
                succ[h].push_back(t);
                ++indeg[t];
              }
          }
          std::priority_queue<int64_t, std::vector<int64_t>,
                              std::greater<int64_t>> ready;
          for (auto& kv : indeg)
            if (kv.second == 0) ready.push(kv.first);
          std::vector<int64_t> order;
          order.reserve(members.size());
          while (!ready.empty()) {
            int64_t h = ready.top();
            ready.pop();
            order.push_back(h);
            auto it = succ.find(h);
            if (it != succ.end())
              for (int64_t t : it->second)
                if (--indeg[t] == 0) ready.push(t);
          }
          if (order.size() < members.size()) {
            std::unordered_set<int64_t> done(order.begin(), order.end());
            std::vector<int64_t> rest;
            for (int64_t h : members)
              if (!done.count(h)) rest.push_back(h);
            std::sort(rest.begin(), rest.end());
            order.insert(order.end(), rest.begin(), rest.end());
          }
          hlist.swap(order);
          corridor_done = true;

          // ---- flank-node label trimming -------------------------------
          // A single huge node (e.g. 4-A3105's ~53 kb backbone nodes)
          // makes the POA subgraph tens of thousands of base vertices
          // for a 100 bp read: the global DP is then forced through
          // kilobases of deletions and both accuracy and speed collapse
          // (the reference behaves identically, align.rs:190-202 gets
          // the whole node label).  Corridor mode trims the START
          // node's label to begin at most `budget` bases before the
          // first anchor and the END node's to stop at most `budget`
          // bases after the last anchor.  The label's base offset
          // within the node rides the lbase output so GAF node offsets
          // are rebased to UNTRIMMED coordinates downstream (node ids
          // are unaffected).
          int64_t sN = node_starts[start_id - 1];
          int64_t sLen = ix.label_len(start_id);
          int64_t from = atb[bi] - sN - budget;
          if (from > 0) trim[start_h] = {from, sLen};
          int64_t eN = node_starts[end_id - 1];
          int64_t eLen = ix.label_len(end_id);
          int64_t to = ate[bj] - eN + budget;
          if (to < eLen) {
            auto it = trim.find(end_h);
            int64_t f0 = it == trim.end() ? 0 : it->second.first;
            trim[end_h] = {f0, to};
          }
        }
      }
      failed = false;  // corridor failure falls back to the id range
    }

    // ---- extend_range_chain (align.rs:523-665) ------------------------
    // u64 wrapping reproduced (reference release-build wrap semantics)
    uint64_t prefix_diff = (uint64_t)aqb[a0];
    uint64_t start_on_node =
        (uint64_t)atb[a0] - (uint64_t)node_starts[(first_handle >> 1) - 1];
    if (start_on_node < prefix_diff) prefix_diff -= start_on_node;
    else prefix_diff = 0;
    auto bfs = [&](uint64_t diff, int64_t seed_handle, bool incoming_dir) {
      // Frontier entries are deduped per level keeping the MAX remaining
      // budget: a handle reached with budget r collects a superset of
      // what any smaller budget collects, and only the final handle SET
      // matters (it is sorted+deduped below) — without this the walk is
      // exponential in bubbly regions (path multiplicity).
      frontier.clear();
      if (incoming_dir) ix.incoming(seed_handle, nbrs);
      else ix.outgoing(seed_handle, nbrs);
      for (int64_t h : nbrs) frontier.emplace_back((int64_t)diff, h);
      std::unordered_map<int64_t, int64_t> best;
      int guard = 0;
      while (!frontier.empty()) {
        if (++guard > 10000) { failed = true; return; }
        best.clear();
        for (auto& fr : frontier) {
          auto it = best.find(fr.second);
          if (it == best.end() || it->second < fr.first) best[fr.second] = fr.first;
          else if (it != best.end()) continue;
        }
        nxt.clear();
        for (auto& fr : frontier) {
          int64_t remaining = fr.first, h = fr.second;
          hlist.push_back(h);
          if (best[h] != remaining) continue;  // a larger budget covers this
          best[h] = INT64_MIN;                 // expand each handle once
          int64_t sl = ix.label_len(h >> 1);
          if (sl < remaining) {
            int64_t rem = remaining - sl;
            if (incoming_dir) ix.incoming(h, nbrs); else ix.outgoing(h, nbrs);
            for (int64_t nb : nbrs) nxt.emplace_back(rem, nb);
          }
        }
        frontier.swap(nxt);
      }
    };
    if (!corridor_done && prefix_diff > 0) bfs(prefix_diff, first_handle, true);

    uint64_t suffix_diff = (uint64_t)(qlen[p] - (aqb[a1 - 1] + k));
    // get_bv_select(id+1) - 1 - (ate[-1]-1), u64-wrapped
    uint64_t end_on_node = (uint64_t)node_starts[(last_handle >> 1)] - 1 -
                           ((uint64_t)ate[a1 - 1] - 1);
    if (end_on_node > suffix_diff) suffix_diff = 0;
    else suffix_diff -= end_on_node;
    if (!corridor_done && !failed && suffix_diff > 0)
      bfs(suffix_diff, last_handle, false);

    if (failed) {
      status[p] = 1;
      return;
    }

    if (!corridor_done) {
      std::sort(hlist.begin(), hlist.end());
      hlist.erase(std::unique(hlist.begin(), hlist.end()), hlist.end());
    }

    // ---- bubble closure (surgical extension beyond the reference) -----
    // Two reference behaviors lose bubble alt-alleles on spoa/smooth HLA
    // graphs, whose alt-node ids sit far from their flanks:
    //   (a) the contiguous node-id range (align.rs:267-402) omits the
    //       alt node entirely when no chained anchor touches it;
    //   (b) the edge filter keeps only id-increasing edges
    //       (align.rs:717-721), so even an in-range alt node with id
    //       above its successor loses its return edge.
    // With closure on (forward ranges): a forward node x whose in-range
    // predecessors P and successors S are both nonempty with
    // max(P) < min(S) is a bubble alt between those flanks; if its id
    // does not already sit between them (or it is out of range), it is
    // (re)placed right after max(P), so the i<j filter keeps exactly
    // its bubble edges.  Everything else keeps the reference's id
    // order — the id filter doubles as a linearity prior that prunes
    // spurious long-range shortcuts, so a full topological reorder
    // measurably hurts (it legalizes those shortcuts).
    if (closure == 1 && orient_kind == 0) {
      std::unordered_set<int64_t> inset(hlist.begin(), hlist.end());
      std::vector<int64_t> cands;  // out-of-range one-hop candidates
      for (int64_t h : hlist) {
        ix.outgoing(h, nbrs);
        for (int64_t t : nbrs)
          if (!(t & 1) && !inset.count(t)) cands.push_back(t);
      }
      std::sort(cands.begin(), cands.end());
      cands.erase(std::unique(cands.begin(), cands.end()), cands.end());
      cands.insert(cands.end(), hlist.begin(), hlist.end());

      std::unordered_map<int64_t, int64_t> anchor;     // bubble x -> max(P)
      std::unordered_map<int64_t, std::vector<int64_t>> children;
      for (int64_t x : cands) {
        int64_t max_p = INT64_MIN, min_s = INT64_MAX;
        ix.incoming(x, nbrs);
        for (int64_t p : nbrs)
          if (inset.count(p)) max_p = std::max(max_p, p);
        ix.outgoing(x, nbrs);
        for (int64_t m : nbrs)
          if (inset.count(m)) min_s = std::min(min_s, m);
        if (max_p == INT64_MIN || min_s == INT64_MAX || max_p >= min_s)
          continue;
        if (inset.count(x) && max_p < x && x < min_s) continue;  // placed ok
        anchor[x] = max_p;
        children[max_p].push_back(x);
      }
      if (!anchor.empty()) {
        std::vector<int64_t> merged;
        merged.reserve(hlist.size() + anchor.size());
        std::unordered_set<int64_t> emitted;
        // emit id-ordered members (skipping relocated ones), splicing
        // each bubble after its anchor; anchors that are themselves
        // bubbles chain through the recursion
        std::vector<int64_t> stack;
        auto emit = [&](int64_t h0) {
          stack.clear();
          stack.push_back(h0);
          while (!stack.empty()) {
            int64_t h = stack.back();
            stack.pop_back();
            if (!emitted.insert(h).second) continue;
            merged.push_back(h);
            auto it = children.find(h);
            if (it != children.end()) {
              std::sort(it->second.rbegin(), it->second.rend());
              for (int64_t c : it->second) stack.push_back(c);
            }
          }
        };
        for (int64_t h : hlist)
          if (!anchor.count(h)) emit(h);
        // bubbles whose anchor chain never reached a non-bubble member
        // (shouldn't happen on a DAG, but stay total): append id-sorted
        std::vector<int64_t> rest;
        for (auto& kv : anchor)
          if (!emitted.count(kv.first)) rest.push_back(kv.first);
        std::sort(rest.begin(), rest.end());
        for (int64_t h : rest) emit(h);
        hlist.swap(merged);
      }
    }

    // ---- find_nodes_edges (align.rs:670-724) --------------------------
    // labels in handle orientation (index.rs:503-533)
    std::unordered_map<int64_t, int64_t> hpos;
    hpos.reserve(hlist.size() * 2);
    for (size_t i = 0; i < hlist.size(); ++i) hpos[hlist[i]] = (int64_t)i;
    for (int64_t h : hlist) {
      int64_t id = h >> 1;
      int64_t s0 = node_starts[id - 1], e = node_starts[id];
      size_t before = R.labels.size();
      int64_t from = 0;
      if (h & 1) {
        R.labels.append(seq_rev + (seq_len - e), (size_t)(e - s0));
      } else {
        int64_t to = e - s0;
        auto it = trim.find(h);
        if (it != trim.end()) {
          from = it->second.first;
          to = it->second.second;
        }
        R.labels.append(seq_fwd + s0 + from, (size_t)(to - from));
      }
      R.llen.push_back((int64_t)(R.labels.size() - before));
      R.lbase.push_back(from);
      R.handles.push_back(h);
    }
    // edges: outgoing within range; loop removal by orientation
    for (size_t i = 0; i < hlist.size(); ++i) {
      ix.outgoing(hlist[i], nbrs);
      for (int64_t tgt : nbrs) {
        auto it = hpos.find(tgt);
        if (it == hpos.end()) continue;
        int64_t j = it->second;
        if (orient_kind == 0 && !((int64_t)i < j)) continue;
        if (orient_kind == 1 && !(j < (int64_t)i)) continue;
        R.edges.push_back((int64_t)i);
        R.edges.push_back(j);
      }
    }
  });

  for (int64_t p = 0; p < B; ++p) {
    PerProb& R = results[(size_t)p];
    for (size_t i = 0; i < R.handles.size(); ++i) {
      handles_all.push_back(R.handles[i]);
      label_off.push_back(label_off.back() + R.llen[i]);
      lbase_all.push_back(R.lbase[i]);
    }
    labels_all.append(R.labels);
    edges_all.insert(edges_all.end(), R.edges.begin(), R.edges.end());
    handle_off.push_back((int64_t)handles_all.size());
    edge_off.push_back((int64_t)edges_all.size() / 2);
  }

  auto alloc64 = [](const std::vector<int64_t>& v) {
    int64_t* p = (int64_t*)std::malloc(sizeof(int64_t) * std::max<size_t>(v.size(), 1));
    std::memcpy(p, v.data(), sizeof(int64_t) * v.size());
    return p;
  };
  *out_handle_off = alloc64(handle_off);
  *out_handles = alloc64(handles_all);
  *out_label_off = alloc64(label_off);
  *out_lbase = alloc64(lbase_all);
  *out_labels = (char*)std::malloc(std::max<size_t>(labels_all.size(), 1));
  std::memcpy(*out_labels, labels_all.data(), labels_all.size());
  *out_edge_off = alloc64(edge_off);
  *out_edges = alloc64(edges_all);
  *out_status = (uint8_t*)std::malloc(std::max<int64_t>(B, 1));
  std::memcpy(*out_status, status.data(), (size_t)B);
  return (int64_t)labels_all.size();
}

// ---------------------------------------------------------------------------
// Device op tapes -> CIGAR / cs strings + node paths
// (align.rs:1096-1167; mirrors ops/poa.py _finish_result and the tape
// decoding of ops/poa_device.py _align_bucket)
// ---------------------------------------------------------------------------

// Per problem: the raw tape ops[T]/vids[T] with valid length t (to be
// reversed), base-graph arrays and the query codes.  String buffers are
// caller-allocated with stride buf_stride; returns 0.
// op codes: 0 M, 1 I, 2 D (3 END, never inside the valid tape).
int64_t vg_finish_tapes(
    int64_t B, int64_t T, const int8_t* ops, const int32_t* vids,
    const int32_t* tlens,
    // per-problem base-graph views (concatenated, bg_off[B+1])
    const int64_t* bg_off, const int8_t* bg_codes, const int32_t* bg_node_of,
    const int32_t* bg_off_in_node,
    // queries, padded [B, q_stride]
    const int8_t* q, int64_t q_stride,
    // outputs
    char* cigar_buf, int64_t cigar_stride, int32_t* cigar_len,
    char* cs_buf, int64_t cs_stride, int32_t* cs_len,
    int32_t* node_path_buf, int64_t np_stride, int32_t* np_len,
    int32_t* path_v_buf, int64_t pv_stride, int32_t* pv_len,
    // scalars per problem: n_aligned, residue, first_v, last_v,
    // path_start_offset, path_end_offset
    int32_t* scalars /* [B * 6] */) {
  static const char* kBaseL = "acgtn";
  for (int64_t p = 0; p < B; ++p) {
    const int8_t* po = ops + p * T;
    const int32_t* pv = vids + p * T;
    int64_t t = tlens[p];
    const int8_t* codes = bg_codes + bg_off[p];
    const int32_t* nodeof = bg_node_of + bg_off[p];
    const int32_t* offin = bg_off_in_node + bg_off[p];
    const int8_t* qp = q + p * q_stride;

    char* cg = cigar_buf + p * cigar_stride;
    char* cs = cs_buf + p * cs_stride;
    int32_t* npb = node_path_buf + p * np_stride;
    int32_t* pvb = path_v_buf + p * pv_stride;
    int64_t cg_n = 0, cs_n = 0, np_n = 0, pv_n = 0;

    std::memcpy(cs + cs_n, "cs:Z:", 5);
    cs_n += 5;

    // walk the tape in forward order (reverse of the emitted order),
    // classifying M as match/mismatch by query-vs-vertex base
    char run_op = 0;
    int64_t run_len = 0;
    auto flush_cigar = [&]() {
      if (run_op) {
        cg_n += std::snprintf(cg + cg_n, 16, "%lld", (long long)run_len);
        cg[cg_n++] = run_op;
      }
    };
    int64_t match_run = 0;
    auto flush_match = [&]() {
      if (match_run) {
        cs[cs_n++] = ':';
        cs_n += std::snprintf(cs + cs_n, 16, "%lld", (long long)match_run);
        match_run = 0;
      }
    };
    char prev_cs_op = 0;  // for I/D run grouping in cs
    int32_t n_aligned = 0, residue = 0;
    int64_t qpos = 0;
    int32_t first_v = -1, last_v = -1;

    for (int64_t s = t - 1; s >= 0; --s) {
      int8_t op = po[s];
      int32_t v = pv[s];
      char c;  // cigar class
      if (op == 0) {  // M (match or mismatch)
        bool is_match = v >= 0 && qp[qpos] == codes[v];
        c = 'M';
        n_aligned += 1;
        if (is_match) {
          residue += 1;
          match_run += 1;
          prev_cs_op = 0;
        } else {
          flush_match();
          cs[cs_n++] = '*';
          cs[cs_n++] = kBaseL[codes[v] > 4 ? 4 : codes[v]];
          cs[cs_n++] = kBaseL[qp[qpos] > 4 ? 4 : qp[qpos]];
          prev_cs_op = 0;
        }
        qpos += 1;
      } else if (op == 1) {  // I
        c = 'I';
        flush_match();
        if (prev_cs_op != 'I') cs[cs_n++] = '+';
        cs[cs_n++] = kBaseL[qp[qpos] > 4 ? 4 : qp[qpos]];
        prev_cs_op = 'I';
        qpos += 1;
      } else {  // D
        c = 'D';
        flush_match();
        if (prev_cs_op != 'D') cs[cs_n++] = '-';
        cs[cs_n++] = kBaseL[codes[v] > 4 ? 4 : codes[v]];
        prev_cs_op = 'D';
      }
      if (c == run_op) {
        run_len += 1;
      } else {
        flush_cigar();
        run_op = c;
        run_len = 1;
      }
      if ((op == 0 || op == 2) && v >= 0) {  // path vertices: M/X/D
        pvb[pv_n++] = v;
        if (first_v < 0) first_v = v;
        last_v = v;
        int32_t n = nodeof[v];
        if (np_n == 0 || npb[np_n - 1] != n) npb[np_n++] = n;
      }
    }
    flush_cigar();
    flush_match();

    cigar_len[p] = (int32_t)cg_n;
    cs_len[p] = (int32_t)cs_n;
    np_len[p] = (int32_t)np_n;
    pv_len[p] = (int32_t)pv_n;
    int32_t fv = first_v < 0 ? 0 : first_v;
    int32_t lv = last_v < 0 ? 0 : last_v;
    scalars[p * 6 + 0] = n_aligned;
    scalars[p * 6 + 1] = residue;
    scalars[p * 6 + 2] = fv;
    scalars[p * 6 + 3] = lv;
    scalars[p * 6 + 4] = first_v < 0 ? 0 : offin[fv];
    scalars[p * 6 + 5] = last_v < 0 ? 0 : offin[lv];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Host global-POA for oversized problems (ops/poa.py align_global_host
// semantics, bit-for-bit): reference-faithful chain ranges occasionally
// span huge unrelated nodes (e.g. a 52 kb N-node inside the id range),
// yielding 100k-vertex DPs where a one-off device executable or the
// numpy oracle are both far too slow.
// ---------------------------------------------------------------------------

namespace {
constexpr int64_t kNeg = -1000000000ll;  // ops/poa.py NEG
constexpr int kMatch = 2, kMismatch = -4;
constexpr int kO1 = 4, kE1 = 2, kO2 = 24, kE2 = 1;
}  // namespace

// One problem: labels/label_off (n+1) + edges -> topo expansion happens
// here (FIFO Kahn, cycle fallback, same as vg_build_poa_batch) with CSR
// predecessors (unbounded fan-in).  Outputs the walk-order op tape
// (OP_M/I/D as in the device kernel) plus the base-graph arrays needed
// by vg_finish_tapes.  All malloc'd; returns the best score.
int64_t vg_poa_global_host(
    const char* labels, const int64_t* label_off, int64_t n_nodes,
    const int64_t* edges, int64_t n_edges, const int8_t* q, int64_t L,
    int8_t** out_ops, int32_t** out_vids, int64_t* out_t,
    int8_t** out_vcodes, int32_t** out_node_of, int32_t** out_off_in,
    int64_t* out_V) {
  // ---- topological order (mirror ops/poa.py build_base_graph) ----------
  std::vector<int64_t> out_head(n_nodes, -1), out_next(std::max<int64_t>(n_edges, 1)),
      out_dst(std::max<int64_t>(n_edges, 1));
  std::vector<int64_t> indeg(n_nodes, 0);
  for (int64_t e = n_edges - 1; e >= 0; --e) {
    int64_t a = edges[2 * e], b = edges[2 * e + 1];
    out_dst[e] = b;
    out_next[e] = out_head[a];
    out_head[a] = e;
    indeg[b] += 1;
  }
  std::deque<int64_t> ready;
  std::vector<int64_t> topo;
  std::vector<uint8_t> seen(n_nodes, 0);
  for (int64_t v = 0; v < n_nodes; ++v)
    if (indeg[v] == 0) ready.push_back(v);
  while (!ready.empty()) {
    int64_t cur = ready.front();
    ready.pop_front();
    topo.push_back(cur);
    seen[cur] = 1;
    for (int64_t s = out_head[cur]; s != -1; s = out_next[s])
      if (--indeg[out_dst[s]] == 0) ready.push_back(out_dst[s]);
  }
  for (int64_t v = 0; v < n_nodes; ++v)
    if (!seen[v]) topo.push_back(v);
  std::vector<int64_t> order_pos(n_nodes);
  for (size_t t = 0; t < topo.size(); ++t) order_pos[topo[t]] = (int64_t)t;

  // base-level expansion
  int64_t V = label_off[n_nodes];
  std::vector<int8_t> vcodes(V);
  std::vector<int32_t> node_of(V), off_in(V);
  std::vector<int64_t> node_first(n_nodes), node_last(n_nodes);
  {
    int64_t vid = 0;
    for (int64_t t = 0; t < n_nodes; ++t) {
      int64_t node = topo[t];
      node_first[node] = vid;
      for (int64_t c = label_off[node]; c < label_off[node + 1]; ++c) {
        vcodes[vid] = base_code(labels[c]);
        node_of[vid] = (int32_t)node;
        off_in[vid] = (int32_t)(c - label_off[node]);
        ++vid;
      }
      node_last[node] = vid - 1;
    }
  }
  // CSR predecessors: edge preds on node heads (edge order), then chains
  std::vector<int32_t> pred_cnt(V, 0);
  std::vector<uint8_t> has_succ(n_nodes, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t a = edges[2 * e], b = edges[2 * e + 1];
    if (order_pos[a] < order_pos[b]) {
      pred_cnt[node_first[b]] += 1;
      has_succ[a] = 1;
    }
  }
  for (int64_t node = 0; node < n_nodes; ++node)
    for (int64_t v = node_first[node] + 1; v <= node_last[node]; ++v)
      pred_cnt[v] = 1;
  std::vector<int64_t> pred_off(V + 1, 0);
  for (int64_t v = 0; v < V; ++v) pred_off[v + 1] = pred_off[v] + pred_cnt[v];
  std::vector<int32_t> pred_dat(std::max<int64_t>(pred_off[V], 1));
  {
    std::vector<int64_t> fill(V, 0);
    for (int64_t e = 0; e < n_edges; ++e) {
      int64_t a = edges[2 * e], b = edges[2 * e + 1];
      if (order_pos[a] < order_pos[b]) {
        int64_t v = node_first[b];
        pred_dat[pred_off[v] + fill[v]++] = (int32_t)node_last[a];
      }
    }
    for (int64_t node = 0; node < n_nodes; ++node)
      for (int64_t v = node_first[node] + 1; v <= node_last[node]; ++v)
        pred_dat[pred_off[v]] = (int32_t)(v - 1);
  }
  std::vector<uint8_t> is_sink(V, 0);
  for (int64_t node = 0; node < n_nodes; ++node)
    if (!has_succ[node]) is_sink[node_last[node]] = 1;

  // ---- DP (mirror align_global_host; int64 scores) ----------------------
  const int64_t W = L + 1;
  std::vector<int64_t> init(W);
  init[0] = 0;
  for (int64_t j = 1; j < W; ++j)
    init[j] = -std::min<int64_t>(kO1 + j * kE1, kO2 + j * kE2);
  std::vector<int64_t> H((size_t)V * W), E1((size_t)V * W), E2((size_t)V * W);
  // traceback: cell1 = case(3b) | opens(4b at 15..18); slots in cell2/3
  std::vector<int32_t> cell1((size_t)V * W), mslot((size_t)V * W),
      eslot((size_t)V * W);  // eslot = e1slot | e2slot<<16 (16b each)
  constexpr int32_t kVirt = 0xFFFF;

  std::vector<int64_t> e1b(W), e2b(W), mb(W);
  std::vector<int32_t> e1s(W), e2s(W), ms(W);
  std::vector<uint8_t> e1o(W), e2o(W);
  for (int64_t v = 0; v < V; ++v) {
    int8_t vc = vcodes[v];
    int64_t p0 = pred_off[v], p1 = pred_off[v + 1];
    for (int64_t j = 0; j < W; ++j) {
      e1b[j] = kNeg; e2b[j] = kNeg; mb[j] = kNeg;
      e1s[j] = kVirt; e2s[j] = kVirt; ms[j] = kVirt;
      e1o[j] = 0; e2o[j] = 0;
    }
    int64_t n_pl = (p1 > p0) ? (p1 - p0) : 1;
    for (int64_t pi = 0; pi < n_pl; ++pi) {
      bool virt = (p1 == p0);
      const int64_t* Hp = virt ? init.data() : &H[(size_t)pred_dat[p0 + pi] * W];
      const int64_t* E1p = virt ? nullptr : &E1[(size_t)pred_dat[p0 + pi] * W];
      const int64_t* E2p = virt ? nullptr : &E2[(size_t)pred_dat[p0 + pi] * W];
      int32_t slot = virt ? kVirt : (int32_t)pi;
      for (int64_t j = 0; j < W; ++j) {
        int64_t o1 = Hp[j] - (kO1 + kE1);
        int64_t x1 = virt ? kNeg - kE1 : E1p[j] - kE1;
        int64_t c1 = o1 > x1 ? o1 : x1;
        if (c1 > e1b[j]) { e1b[j] = c1; e1s[j] = slot; e1o[j] = o1 >= x1; }
        int64_t o2 = Hp[j] - (kO2 + kE2);
        int64_t x2 = virt ? kNeg - kE2 : E2p[j] - kE2;
        int64_t c2 = o2 > x2 ? o2 : x2;
        if (c2 > e2b[j]) { e2b[j] = c2; e2s[j] = slot; e2o[j] = o2 >= x2; }
        if (j > 0) {
          int8_t qc = q[j - 1];
          int64_t sub = (qc == vc && qc < 4 && vc < 4) ? kMatch : kMismatch;
          int64_t mc = Hp[j - 1] + sub;
          if (mc > mb[j]) { mb[j] = mc; ms[j] = slot; }
        }
      }
    }
    // combine + in-row F scan (serial, mirrors the oracle loop)
    int64_t f1 = kNeg, f2 = kNeg;
    int64_t* Hrow = &H[(size_t)v * W];
    for (int64_t j = 0; j < W; ++j) {
      int64_t e_max = e1b[j] > e2b[j] ? e1b[j] : e2b[j];
      int64_t h = mb[j] >= e_max ? mb[j] : e_max;
      int32_t c = mb[j] >= e_max ? 0 : (e1b[j] >= e2b[j] ? 1 : 2);
      uint8_t f1open = 0, f2open = 0;
      if (j > 0) {
        int64_t o1 = Hrow[j - 1] - (kO1 + kE1), x1 = f1 - kE1;
        f1open = o1 >= x1;
        f1 = o1 > x1 ? o1 : x1;
        int64_t o2 = Hrow[j - 1] - (kO2 + kE2), x2 = f2 - kE2;
        f2open = o2 >= x2;
        f2 = o2 > x2 ? o2 : x2;
        if (f1 > h) { h = f1; c = 3; }
        if (f2 > h) { h = f2; c = 4; }
      }
      Hrow[j] = h;
      E1[(size_t)v * W + j] = e1b[j];
      E2[(size_t)v * W + j] = e2b[j];
      cell1[(size_t)v * W + j] =
          c | ((int32_t)e1o[j] << 15) | ((int32_t)e2o[j] << 16) |
          ((int32_t)f1open << 17) | ((int32_t)f2open << 18);
      mslot[(size_t)v * W + j] = ms[j];
      eslot[(size_t)v * W + j] = (e1s[j] & 0xFFFF) | ((int32_t)(e2s[j] & 0xFFFF) << 16);
    }
  }

  // best sink: first in topo order achieving the max (oracle:288-293)
  int64_t best_sink = -1, best = 0;
  bool any_sink = false;
  for (int64_t v = 0; v < V; ++v) {
    if (!is_sink[v]) continue;
    if (!any_sink || H[(size_t)v * W + L] > best) {
      any_sink = true;
      best = H[(size_t)v * W + L];
      best_sink = v;
    }
  }
  if (!any_sink) { best_sink = V - 1; best = H[(size_t)(V - 1) * W + L]; }

  // ---- traceback (walk order, device tape conventions) ------------------
  std::vector<int8_t> tape_ops;
  std::vector<int32_t> tape_vids;
  tape_ops.reserve((size_t)(V < 4096 ? V : 4096) + L + 2);
  int64_t v = best_sink, j = L;
  int state = 0;  // 0 H, 1 E1, 2 E2, 3 F1, 4 F2
  auto slot_to_pred = [&](int64_t vv, int32_t slot) -> int64_t {
    if (slot == kVirt) return -2;
    return pred_dat[pred_off[vv] + slot];
  };
  while (!(v == -2 && j == 0)) {
    if (v == -2) {  // leading insertion against the virtual source
      tape_ops.push_back(1); tape_vids.push_back(-1); --j;
      continue;
    }
    size_t cix = (size_t)v * W + j;
    if (state == 0) {
      int32_t c = cell1[cix] & 7;
      if (c == 0) {
        tape_ops.push_back(0); tape_vids.push_back((int32_t)v);
        v = slot_to_pred(v, mslot[cix]); --j;
      } else {
        state = (int)c;
      }
    } else if (state == 1 || state == 2) {
      int32_t slot = state == 1 ? (eslot[cix] & 0xFFFF) : ((eslot[cix] >> 16) & 0xFFFF);
      uint8_t opn = state == 1 ? ((cell1[cix] >> 15) & 1) : ((cell1[cix] >> 16) & 1);
      tape_ops.push_back(2); tape_vids.push_back((int32_t)v);
      v = slot_to_pred(v, slot);
      if (opn) state = 0;
    } else {
      uint8_t opn = state == 3 ? ((cell1[cix] >> 17) & 1) : ((cell1[cix] >> 18) & 1);
      tape_ops.push_back(1); tape_vids.push_back((int32_t)v);
      --j;
      if (opn) state = 0;
    }
  }
  // tape is in START->END order here? No: the walk goes end->start, and
  // the device convention is walk order — exactly what we appended.

  int64_t t = (int64_t)tape_ops.size();
  *out_ops = (int8_t*)std::malloc(std::max<int64_t>(t, 1));
  std::memcpy(*out_ops, tape_ops.data(), (size_t)t);
  *out_vids = (int32_t*)std::malloc(sizeof(int32_t) * std::max<int64_t>(t, 1));
  std::memcpy(*out_vids, tape_vids.data(), sizeof(int32_t) * (size_t)t);
  *out_t = t;
  *out_vcodes = (int8_t*)std::malloc(std::max<int64_t>(V, 1));
  std::memcpy(*out_vcodes, vcodes.data(), (size_t)V);
  *out_node_of = (int32_t*)std::malloc(sizeof(int32_t) * std::max<int64_t>(V, 1));
  std::memcpy(*out_node_of, node_of.data(), sizeof(int32_t) * (size_t)V);
  *out_off_in = (int32_t*)std::malloc(sizeof(int32_t) * std::max<int64_t>(V, 1));
  std::memcpy(*out_off_in, off_in.data(), sizeof(int32_t) * (size_t)V);
  *out_V = V;
  return best;
}

// ---------------------------------------------------------------------------
// Read-side helpers for the mapping pipeline (models/mapper.py)
// ---------------------------------------------------------------------------

// Exact anchor totals per read: window k-mer codes + binary search over
// the sorted code table, summing forward-only position counts.
// Mirrors Mapper._anchor_totals.
// lut: optional dense 4^k code->group table (int32, -1 absent); when
// given it replaces the binary search (one load per window).
int64_t vg_count_anchors(
    int64_t n_reads, const char* seqs, const int64_t* seq_off,
    int32_t k, const int64_t* kmer_codes, const int64_t* fo_counts,
    int64_t n_kmers, int64_t* out_totals, const int32_t* lut) {
  parallel_for(n_reads, [&](int64_t rix) {
    const char* s = seqs + seq_off[rix];
    int64_t len = seq_off[rix + 1] - seq_off[rix];
    int64_t total = 0;
    if (len >= k) {
      uint64_t code = 0;
      const uint64_t mask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
      int32_t run = 0;  // valid-base run length
      for (int64_t i = 0; i < len; ++i) {
        int8_t c = base_code(s[i]);
        if (c >= 4) {
          run = 0;
          code = 0;
          continue;
        }
        code = ((code << 2) | (uint64_t)c) & mask;
        if (++run >= k) {
          int64_t idx = -1;
          if (lut) {
            idx = lut[code];
          } else {
            const int64_t* lo = kmer_codes;
            const int64_t* hi = kmer_codes + n_kmers;
            const int64_t* it = std::lower_bound(lo, hi, (int64_t)code);
            if (it != hi && *it == (int64_t)code) idx = it - lo;
          }
          if (idx >= 0) total += fo_counts[idx];
        }
      }
    }
    out_totals[rix] = total;
  });
  return 0;
}

// Host-side anchor coordinates for chain members.  Re-derives, per
// read, the anchors the device materialized (ops/lookup.py: ascending
// query-kmer-window order, each found window contributing its
// forward-only index positions in table order, truncated at a_max),
// then reproduces the chaining DP's stable sort by target_end
// (ops/chain.py, chain.rs:386-389).  Member ids are *sorted positions*
// (what the DP's backtrack emits); outputs are their (qb, tb, te).
int64_t vg_anchor_coords(
    int64_t n_reads, const char* seqs, const int64_t* seq_off, int32_t k,
    const int64_t* kmer_codes, const int64_t* fo_counts,
    const int64_t* fo_offsets, const int64_t* fo_start, const int64_t* fo_end,
    int64_t n_kmers, const int64_t* a_max /* [n_reads] device anchor cap */,
    const int64_t* mem_off /* [n_reads+1] members per read prefix */,
    const int32_t* mem_slots /* flat member sorted-position ids */,
    int64_t* out_qb, int64_t* out_tb, int64_t* out_te,
    const int32_t* lut /* optional dense 4^k code->group table */) {
  struct Anc {
    int64_t qb, tb, te;
  };
  std::atomic<int64_t> err(0);
  parallel_for(n_reads, [&](int64_t rix) {
    // thread-local scratch: per-read vector construction + the temp
    // buffer std::stable_sort allocates measured as a visible slice of
    // the 4k-read coords phase on the 1-core bench host
    thread_local std::vector<Anc> anc;
    thread_local std::vector<int64_t> order;
    const int64_t m0 = mem_off[rix], m1 = mem_off[rix + 1];
    if (m0 == m1 || err.load(std::memory_order_relaxed)) return;
    const char* s = seqs + seq_off[rix];
    const int64_t len = seq_off[rix + 1] - seq_off[rix];
    const int64_t cap = a_max[rix];
    anc.clear();
    uint64_t code = 0;
    const uint64_t mask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
    int32_t run = 0;
    // staged per-read pipeline: the LUT (4^k x i32) and the
    // counts/offsets tables miss cache on nearly every k-mer, so the
    // rolling-code loop issues all lookups per stage with prefetches
    // ahead — the phase is memory-latency-bound, and overlapping the
    // misses is worth ~2x on the 1-core bench host
    thread_local std::vector<std::pair<int64_t, uint64_t>> qk;  // (qb, code)
    thread_local std::vector<int64_t> idxs;
    qk.clear();
    for (int64_t i = 0; i < len; ++i) {
      int8_t c = base_code(s[i]);
      if (c >= 4) {
        run = 0;
        code = 0;
        continue;
      }
      code = ((code << 2) | (uint64_t)c) & mask;
      if (++run >= k) {
        if (lut) __builtin_prefetch(&lut[code], 0, 0);
        qk.emplace_back(i - k + 1, code);
      }
    }
    idxs.resize(qk.size());
    for (size_t j = 0; j < qk.size(); ++j) {
      int64_t idx = -1;
      if (lut) {
        idx = lut[qk[j].second];
      } else {
        const int64_t* lo = kmer_codes;
        const int64_t* hi = kmer_codes + n_kmers;
        const int64_t* it =
            std::lower_bound(lo, hi, (int64_t)qk[j].second);
        if (it != hi && *it == (int64_t)qk[j].second) idx = it - lo;
      }
      idxs[j] = idx;
      if (idx >= 0) {
        __builtin_prefetch(&fo_counts[idx], 0, 0);
        __builtin_prefetch(&fo_offsets[idx], 0, 0);
      }
    }
    for (size_t j = 0; j < qk.size() && (int64_t)anc.size() < cap; ++j) {
      const int64_t idx = idxs[j];
      if (idx < 0) continue;
      if (j + 4 < qk.size() && idxs[j + 4] >= 0)
        __builtin_prefetch(&fo_start[fo_offsets[idxs[j + 4]]], 0, 0);
      const int64_t cnt = fo_counts[idx];
      for (int64_t p = 0; p < cnt && (int64_t)anc.size() < cap; ++p) {
        const int64_t row = fo_offsets[idx] + p;
        anc.push_back({qk[j].first, fo_start[row], fo_end[row]});
      }
    }
    // stable sort by te (generation order within ties), as the DP
    // does: pack (te << 24 | j) so a plain std::sort is stable — j is
    // bounded by the device anchor cap (< 2^24) and te by the doubled
    // linearization length, well inside int64
    order.resize(anc.size());
    for (size_t j = 0; j < anc.size(); ++j)
      order[j] = (anc[j].te << 24) | (int64_t)j;
    std::sort(order.begin(), order.end());
    for (size_t j = 0; j < order.size(); ++j) order[j] &= (1 << 24) - 1;
    for (int64_t j = m0; j < m1; ++j) {
      const int64_t p = (int64_t)mem_slots[j];
      if (p < 0 || p >= (int64_t)anc.size()) {
        store_min_err(err, rix + 1);
        return;
      }
      const Anc& a = anc[(size_t)order[(size_t)p]];
      out_qb[j] = a.qb;
      out_tb[j] = a.tb;
      out_te[j] = a.te;
    }
  });
  return err.load();
}

// Chain backtracking over sorted anchor positions (chain.rs:464-557;
// mirrors Mapper._backtrack_positions).  For each read: visit chain
// starts in descending position order, walk predecessors nulling them,
// keep chains of >= min_anchors, positions ascending per chain.
// Outputs (malloc'd): per-read chain-count, per-chain position counts,
// and the flat ascending position lists.
int64_t vg_backtrack(
    int64_t B, int64_t A, int32_t* pred /* [B*A], mutated */,
    const uint8_t* starts /* [B*A] */, const int32_t* n_valid /* [B] */,
    int64_t min_anchors,
    int64_t** out_read_off /* [B+1], chains per read prefix */,
    int64_t** out_chain_off /* [n_chains+1], positions prefix */,
    int32_t** out_positions) {
  std::vector<int64_t> read_off(1, 0);
  std::vector<int64_t> chain_off(1, 0);
  std::vector<int32_t> positions;
  std::vector<int32_t> walk;
  for (int64_t b = 0; b < B; ++b) {
    int32_t* pr = pred + b * A;
    const uint8_t* st = starts + b * A;
    int64_t n = n_valid[b];
    for (int64_t i = n - 1; i >= 0; --i) {
      if (!st[i] || pr[i] == -1) continue;
      walk.clear();
      int32_t cur = (int32_t)i;
      while (pr[cur] != -1) {
        int32_t p = pr[cur];
        pr[cur] = -1;
        walk.push_back(cur);
        cur = p;
      }
      walk.push_back(cur);
      if ((int64_t)walk.size() >= min_anchors) {
        positions.insert(positions.end(), walk.rbegin(), walk.rend());
        chain_off.push_back((int64_t)positions.size());
      }
    }
    read_off.push_back((int64_t)chain_off.size() - 1);
  }
  *out_read_off = (int64_t*)std::malloc(sizeof(int64_t) * read_off.size());
  std::memcpy(*out_read_off, read_off.data(), sizeof(int64_t) * read_off.size());
  *out_chain_off = (int64_t*)std::malloc(sizeof(int64_t) * chain_off.size());
  std::memcpy(*out_chain_off, chain_off.data(), sizeof(int64_t) * chain_off.size());
  *out_positions = (int32_t*)std::malloc(
      sizeof(int32_t) * std::max<size_t>(positions.size(), 1));
  std::memcpy(*out_positions, positions.data(), sizeof(int32_t) * positions.size());
  return (int64_t)(chain_off.size() - 1);
}


// Delta-plane variant of vg_backtrack: walks the map wire's u8 plane
// directly (delta = slot - pred in bits 0-6, chain-start in bit 7),
// skipping the ~4 MB of numpy temporaries the int32 decode
// materialized per batch.  `plane` is consumed (visited predecessors
// nulled, exactly like the reference's walk, chain.rs:476-498).
int64_t vg_backtrack_delta(
    int64_t B, int64_t A, uint8_t* plane /* [B*A], mutated */,
    const int32_t* n_valid /* [B] */, int64_t min_anchors,
    int64_t** out_read_off, int64_t** out_chain_off,
    int32_t** out_positions) {
  std::vector<int64_t> read_off(1, 0);
  std::vector<int64_t> chain_off(1, 0);
  std::vector<int32_t> positions;
  std::vector<int32_t> walk;
  for (int64_t b = 0; b < B; ++b) {
    uint8_t* pl = plane + b * A;
    int64_t n = n_valid[b];
    for (int64_t i = n - 1; i >= 0; --i) {
      if (!(pl[i] & 0x80) || !(pl[i] & 0x7F)) continue;
      walk.clear();
      int32_t cur = (int32_t)i;
      while (pl[cur] & 0x7F) {
        int32_t p = cur - (int32_t)(pl[cur] & 0x7F);
        pl[cur] &= 0x80;  // null the predecessor, keep the start bit
        walk.push_back(cur);
        cur = p;
      }
      walk.push_back(cur);
      if ((int64_t)walk.size() >= min_anchors) {
        positions.insert(positions.end(), walk.rbegin(), walk.rend());
        chain_off.push_back((int64_t)positions.size());
      }
    }
    read_off.push_back((int64_t)chain_off.size() - 1);
  }
  *out_read_off = (int64_t*)std::malloc(sizeof(int64_t) * read_off.size());
  std::memcpy(*out_read_off, read_off.data(), sizeof(int64_t) * read_off.size());
  *out_chain_off = (int64_t*)std::malloc(sizeof(int64_t) * chain_off.size());
  std::memcpy(*out_chain_off, chain_off.data(),
              sizeof(int64_t) * chain_off.size());
  *out_positions = (int32_t*)std::malloc(
      sizeof(int32_t) * std::max<size_t>(positions.size(), 1));
  std::memcpy(*out_positions, positions.data(),
              sizeof(int32_t) * positions.size());
  return (int64_t)(chain_off.size() - 1);
}

// Inverse of the device-side u8 delta tape encoding
// (ops/poa_device.py _encode_tape_u8): entry = op (2 bits) | code
// (6 bits), code 1..61 = vid delta + 31, code 62 = exception whose
// absolute vid rides (excpos, excval), sorted by flat position.  One
// serial pass per row into caller-allocated (ops, vids) buffers — the
// numpy reconstruction needs ~6 full-matrix passes, which on the
// 1-core deployment would eat most of the bytes-halved link win.
int64_t vg_decode_tape_u8(
    int64_t B, int64_t T, const uint8_t* tape /* [B*T] */,
    const int32_t* starts /* [B] */,
    const int32_t* excpos /* [n_exc], ascending flat positions */,
    const int32_t* excval /* [n_exc] */, int64_t n_exc,
    int8_t* out_ops /* [B*T] */, int32_t* out_vids /* [B*T] */) {
  int64_t e = 0;
  for (int64_t b = 0; b < B; ++b) {
    const uint8_t* row = tape + b * T;
    int8_t* ops = out_ops + b * T;
    int32_t* vids = out_vids + b * T;
    int32_t v = starts[b];
    const int64_t base = b * T;
    for (int64_t j = 0; j < T; ++j) {
      uint8_t entry = row[j];
      ops[j] = (int8_t)(entry & 3);
      int32_t code = entry >> 2;
      if (code == 62) {
        if (e >= n_exc || excpos[e] != base + j) return -1;  // corrupt
        v = excval[e++];
      } else if (j > 0) {
        v += code - 31;
      }
      vids[j] = v;
    }
  }
  return e == n_exc ? 0 : -1;
}

// ---------------------------------------------------------------------------
// Single-threaded CPU baseline: a native restatement of the reference's
// per-read loop (map.rs:56-111 + align.rs:58-145), used by bench.py as the
// measured stand-in for the Rust reference (no Rust toolchain in-image).
// Deliberately GENEROUS to the reference: lookup is O(log n) binary search
// over the sorted code table (the reference does an O(n_kmers) membership
// scan per query k-mer, index.rs:319) and rank/select are binary searches
// (the reference loops O(seq_len), index.rs:427-480).
// ---------------------------------------------------------------------------

static inline double baseline_score_anchor(
    int64_t aqb, int64_t aqe, int64_t ate_, double af, int64_t atb,
    int64_t bqb, int64_t bqe, int64_t btb, int64_t bte,
    int64_t k, int64_t max_gap) {
  // score_anchor (chain.rs:274-368), forward-only orients
  const double NEGMAX = -std::numeric_limits<double>::max();
  if (aqe >= bqe || ate_ >= bte) return NEGMAX;
  int64_t ql = std::min(bqb - aqb, bqe - aqe);
  int64_t tbd = btb > atb ? btb - atb : atb - btb;
  int64_t ted = bte > ate_ ? bte - ate_ : ate_ - bte;
  int64_t tl = std::min(tbd, ted);
  int64_t gap = ql > tl ? ql - tl : tl - ql;
  if (gap > max_gap) return NEGMAX;
  double gcost = gap == 0
      ? 0.0
      : 0.01 * (double)k * (double)gap + 0.5 * std::log2((double)gap);
  double mlen = (double)std::min(std::min(ql, tl), k);
  // f64::round == round-half-away-from-zero (chain.rs:361-363)
  return std::round((af + mlen - gcost) * 1000.0) / 1000.0;
}

namespace {

struct BAnchor {
  int64_t qb, qe, tb, te;
};

// Per-read anchoring + chaining, shared by vg_baseline_map_align and
// vg_map_read_chains.  Fills `chains` with anchor lists in reference emit
// order (descending backtrack start, members ascending; chain.rs:455-558).
void baseline_map_one_read(
    const char* s, int64_t len, int32_t k, int64_t n_kmers,
    const int64_t* kmer_codes, const int64_t* fo_counts,
    const int64_t* fo_offsets, const int64_t* fo_start, const int64_t* fo_end,
    int64_t bandwidth, int64_t max_gap, int64_t min_anchors,
    std::vector<std::vector<BAnchor>>& chains) {
  chains.clear();
  // ---- anchors_for_query, forward-only (chain.rs:134-173, map.rs:62)
  std::vector<BAnchor> anc;
  if (len >= k) {
    uint64_t code = 0;
    const uint64_t mask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
    int32_t run = 0;
    for (int64_t i = 0; i < len; ++i) {
      int8_t c = base_code(s[i]);
      if (c >= 4) {
        run = 0;
        code = 0;
        continue;
      }
      code = ((code << 2) | (uint64_t)c) & mask;
      if (++run >= k) {
        const int64_t* it =
            std::lower_bound(kmer_codes, kmer_codes + n_kmers, (int64_t)code);
        if (it != kmer_codes + n_kmers && *it == (int64_t)code) {
          const int64_t idx = it - kmer_codes;
          for (int64_t p = 0; p < fo_counts[idx]; ++p) {
            const int64_t row = fo_offsets[idx] + p;
            anc.push_back({i - k + 1, i + 1, fo_start[row], fo_end[row]});
          }
        }
      }
    }
  }

  // ---- chain_anchors (chain.rs:370-655): stable sort by target_end,
  // banded f64 DP, global-max backtrack with predecessor nulling
  const int64_t n = (int64_t)anc.size();
  std::vector<int64_t> order(n);
  for (int64_t j = 0; j < n; ++j) order[j] = j;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return anc[a].te < anc[b].te; });
  std::vector<double> f(n, (double)k);
  std::vector<int64_t> pred(n, -1);
  double curr_max = 0.0;
  for (int64_t i = 1; i < n; ++i) {
    const BAnchor& bi = anc[order[i]];
    const int64_t min_j = bandwidth > i ? 0 : i - bandwidth;
    for (int64_t j = i - 1; j >= min_j; --j) {
      const BAnchor& aj = anc[order[j]];
      double prop = baseline_score_anchor(
          aj.qb, aj.qe, aj.te, f[j], aj.tb,
          bi.qb, bi.qe, bi.tb, bi.te, k, max_gap);
      if (prop > f[i]) {
        f[i] = prop;
        pred[i] = j;
      }
      if (prop > curr_max) curr_max = prop;
    }
  }
  std::vector<int64_t> walk;
  for (int64_t i = n - 1; i >= 0; --i) {
    if (pred[i] == -1 || f[i] != curr_max) continue;
    walk.clear();
    int64_t cur = i;
    while (pred[cur] != -1) {
      int64_t p = pred[cur];
      pred[cur] = -1;
      walk.push_back(cur);
      cur = p;
    }
    walk.push_back(cur);
    if ((int64_t)walk.size() >= min_anchors) {
      chains.emplace_back();
      auto& c = chains.back();
      for (auto it = walk.rbegin(); it != walk.rend(); ++it)
        c.push_back(anc[order[*it]]);
    }
  }
}

}  // namespace

// Exact unbounded single-read chaining (native host fallback for reads
// whose anchor count exceeds the device bucket cap).  Outputs malloc'd:
// chain_off [n_chains+1] and flattened member coordinate triples.
int64_t vg_map_read_chains(
    const char* s, int64_t len, int32_t k, int64_t n_kmers,
    const int64_t* kmer_codes, const int64_t* fo_counts,
    const int64_t* fo_offsets, const int64_t* fo_start, const int64_t* fo_end,
    int64_t bandwidth, int64_t max_gap, int64_t min_anchors,
    int64_t** out_chain_off, int64_t** out_qb, int64_t** out_tb,
    int64_t** out_te) {
  std::vector<std::vector<BAnchor>> chains;
  baseline_map_one_read(s, len, k, n_kmers, kmer_codes, fo_counts,
                        fo_offsets, fo_start, fo_end, bandwidth, max_gap,
                        min_anchors, chains);
  int64_t total = 0;
  for (auto& c : chains) total += (int64_t)c.size();
  *out_chain_off = (int64_t*)std::malloc(sizeof(int64_t) * (chains.size() + 1));
  *out_qb = (int64_t*)std::malloc(sizeof(int64_t) * std::max<int64_t>(total, 1));
  *out_tb = (int64_t*)std::malloc(sizeof(int64_t) * std::max<int64_t>(total, 1));
  *out_te = (int64_t*)std::malloc(sizeof(int64_t) * std::max<int64_t>(total, 1));
  int64_t off = 0;
  (*out_chain_off)[0] = 0;
  for (size_t ci = 0; ci < chains.size(); ++ci) {
    for (const BAnchor& a : chains[ci]) {
      (*out_qb)[off] = a.qb;
      (*out_tb)[off] = a.tb;
      (*out_te)[off] = a.te;
      ++off;
    }
    (*out_chain_off)[ci + 1] = off;
  }
  return (int64_t)chains.size();
}

int64_t vg_baseline_map_align(
    // index arrays (IndexView layout)
    int64_t n_nodes, const int64_t* node_starts, const int64_t* edges,
    const int64_t* edge_idx, const int64_t* edges_to_node,
    const char* seq_fwd, const char* seq_rev, int64_t seq_len,
    // sorted k-mer code table + forward-only position sub-table
    int32_t k, int64_t n_kmers, const int64_t* kmer_codes,
    const int64_t* fo_counts, const int64_t* fo_offsets,
    const int64_t* fo_start, const int64_t* fo_end,
    // reads (concatenated ASCII)
    int64_t n_reads, const char* seqs, const int64_t* seq_off,
    // chaining parameters (map_main.rs:100-117 defaults)
    int64_t bandwidth, int64_t max_gap, int64_t min_anchors,
    int32_t also_align,
    // outputs [n_reads]: chains found; POA tape length (0 = placeholder)
    int64_t* out_n_chains, int64_t* out_tape_len) {
  std::vector<std::vector<BAnchor>> chains;

  for (int64_t rix = 0; rix < n_reads; ++rix) {
    const char* s = seqs + seq_off[rix];
    const int64_t len = seq_off[rix + 1] - seq_off[rix];
    baseline_map_one_read(s, len, k, n_kmers, kmer_codes, fo_counts,
                          fo_offsets, fo_start, fo_end, bandwidth, max_gap,
                          min_anchors, chains);
    out_n_chains[rix] = (int64_t)chains.size();
    out_tape_len[rix] = 0;

    // ---- --also-align on the best chain (align_best_n=1 default):
    // obtain_base_level_alignment (align.rs:58-145)
    if (also_align && !chains.empty()) {
      const std::vector<BAnchor>& best_chain = chains[0];
      const int64_t na = (int64_t)best_chain.size();
      std::vector<int64_t> aqb(na), atb(na), ate(na);
      for (int64_t j = 0; j < na; ++j) {
        const BAnchor& a = best_chain[j];
        aqb[j] = a.qb;
        atb[j] = a.tb;
        ate[j] = a.te;
      }
      int64_t anchor_off[2] = {0, na};
      int64_t qlen[1] = {len};
      int64_t* h_off = nullptr;
      int64_t* handles = nullptr;
      int64_t* l_off = nullptr;
      int64_t* l_base = nullptr;
      char* labels = nullptr;
      int64_t* e_off = nullptr;
      int64_t* sub_edges = nullptr;
      uint8_t* status = nullptr;
      vg_extract_subgraphs(
          n_nodes, node_starts, edges, edge_idx, edges_to_node,
          seq_fwd, seq_rev, seq_len, 1, anchor_off, aqb.data(), atb.data(),
          ate.data(), nullptr, nullptr, qlen, k, 0,
          &h_off, &handles, &l_off, &l_base, &labels, &e_off, &sub_edges,
          &status);
      if (status && status[0] == 0 && h_off && h_off[1] > 0) {
        std::vector<int8_t> q(len);
        for (int64_t i = 0; i < len; ++i) q[i] = base_code(s[i]);
        int8_t* o_ops = nullptr;
        int32_t* o_vids = nullptr;
        int64_t o_t = 0;
        int8_t* o_vc = nullptr;
        int32_t* o_no = nullptr;
        int32_t* o_oi = nullptr;
        int64_t o_v = 0;
        vg_poa_global_host(labels, l_off, h_off[1],
                           sub_edges ? sub_edges + 2 * e_off[0] : nullptr,
                           e_off[1] - e_off[0], q.data(), len,
                           &o_ops, &o_vids, &o_t, &o_vc, &o_no, &o_oi, &o_v);
        out_tape_len[rix] = o_t;
        std::free(o_ops);
        std::free(o_vids);
        std::free(o_vc);
        std::free(o_no);
        std::free(o_oi);
      }
      std::free(h_off);
      std::free(handles);
      std::free(l_off);
      std::free(l_base);
      std::free(labels);
      std::free(e_off);
      std::free(sub_edges);
      std::free(status);
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Batch chains-GAF assembly (GAFAlignment::from_chain + to_string,
// align.rs:762-930, 971-1027): the last non-native host phase of the
// map stream.  One pass over the flat per-chain anchor arrays emits the
// full chains-GAF text blob — node-id rank/select via binary search on
// the node_starts prefix array, the "(>id:off,>id:off)," tuple per
// anchor, the both-strands '-' flip (back-to-front tuples, mirrored
// offsets, flipped signs), and the placeholder (unmapped) row.
// Row order is the caller's flat chain order (reads in input order,
// chains per read in discovery order) — identical bytes to the Python
// from_chain/to_string path, which stays as the fallback and the
// equivalence-test oracle.
// ---------------------------------------------------------------------------

namespace {
inline int64_t gaf_node_id_fwd(const int64_t* node_starts, int64_t n_nodes,
                               int64_t pos) {
  // np.searchsorted(node_starts[:n_nodes+1], pos, side='right')
  const int64_t* e = node_starts + n_nodes + 1;
  return std::upper_bound(node_starts, e, pos) - node_starts;
}
inline int64_t gaf_node_id_rev(const int64_t* node_starts, int64_t n_nodes,
                               int64_t seq_len, int64_t pos) {
  // np.searchsorted(node_starts[:n_nodes], seq_len - pos, side='left')
  const int64_t* e = node_starts + n_nodes;
  return std::lower_bound(node_starts, e, seq_len - pos) - node_starts;
}
inline char* put_i64(char* p, int64_t v) {
  if (v < 0) { *p++ = '-'; v = -v; }
  char tmp[20];
  int n = 0;
  do { tmp[n++] = (char)('0' + v % 10); v /= 10; } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}
}  // namespace

int64_t vg_chains_gaf(
    int64_t n_chains,
    const int64_t* mem_off,  // [n_chains+1] flat anchor offsets
    const int64_t* aqb, const int64_t* atb, const int64_t* ate,
    const int8_t* aso, const int8_t* aeo,  // [total] orients or NULL=fwd
    const uint8_t* strand_rev,             // [n_chains] 1 = '-'
    const int32_t* mapq,                   // [n_chains] saturated 0..254
    const int64_t* qlen,                   // [n_chains]
    const char* names, const int64_t* name_off,  // [n_chains+1]
    int64_t k,
    const int64_t* node_starts, int64_t n_nodes, int64_t seq_len,
    char** out, int64_t* out_len) {
  // upper bound: per anchor "(>id:off,>id:off)," <= 2*(2+19+1+19) + 3;
  // fixed columns + notes <= ~120 + name
  int64_t cap = 0;
  for (int64_t c = 0; c < n_chains; ++c) {
    int64_t n = mem_off[c + 1] - mem_off[c];
    cap += 128 + (name_off[c + 1] - name_off[c]) + n * 88;
  }
  char* buf = (char*)std::malloc((size_t)cap + 64);
  if (!buf) return -1;
  char* p = buf;
  for (int64_t c = 0; c < n_chains; ++c) {
    int64_t a0 = mem_off[c], a1 = mem_off[c + 1];
    int64_t n = a1 - a0;
    const char* nm = names + name_off[c];
    int64_t nm_len = name_off[c + 1] - name_off[c];
    std::memcpy(p, nm, (size_t)nm_len);
    p += nm_len;
    *p++ = '\t';
    p = put_i64(p, qlen[c]);
    *p++ = '\t';
    if (n == 0) {  // placeholder row (align.rs:913-930)
      std::memcpy(p, "*\t*\t*\t*\t*\t*\t*\t*\t*\t0\t*\n", 22);
      p += 22;
      continue;
    }
    bool rev = strand_rev[c] != 0;
    int64_t qs = aqb[a0], qe = aqb[a1 - 1] + k;
    if (rev) {
      int64_t t = qs;
      qs = qlen[c] - qe;
      qe = qlen[c] - t;
    }
    p = put_i64(p, qs);
    *p++ = '\t';
    p = put_i64(p, qe);
    *p++ = '\t';
    *p++ = rev ? '-' : '+';
    *p++ = '\t';
    // anchor tuples; each anchor contributes (start, end-1) positions
    for (int64_t i = 0; i < n; ++i) {
      // rev: traverse back-to-front, each anchor end-first
      int64_t j = rev ? a1 - 1 - i : a0 + i;
      int64_t pos_a = rev ? ate[j] - 1 : atb[j];
      int64_t pos_b = rev ? atb[j] : ate[j] - 1;
      int8_t or_a = aso ? (rev ? aeo[j] : aso[j]) : 0;
      int8_t or_b = aso ? (rev ? aso[j] : aeo[j]) : 0;
      *p++ = '(';
      for (int half = 0; half < 2; ++half) {
        int64_t pos = half ? pos_b : pos_a;
        int8_t orient = half ? or_b : or_a;
        int64_t id = orient == 0
                         ? gaf_node_id_fwd(node_starts, n_nodes, pos)
                         : gaf_node_id_rev(node_starts, n_nodes, seq_len, pos);
        int64_t off = pos - node_starts[id > 0 ? id - 1 : 0];
        if (rev) {  // mirror onto the opposite orientation
          int64_t node_len = node_starts[id] - node_starts[id - 1];
          off = node_len - 1 - off;
          orient = orient == 0 ? 1 : 0;
        }
        *p++ = orient == 0 ? '>' : '<';
        p = put_i64(p, id);
        *p++ = ':';
        p = put_i64(p, off);
        if (half == 0) *p++ = ',';
      }
      *p++ = ')';
      *p++ = ',';
    }
    // path_length..alignment_block_length are zeros (align.rs:880-889)
    std::memcpy(p, "\t0\t0\t0\t0\t0\t", 11);
    p += 11;
    p = put_i64(p, mapq[c]);
    std::memcpy(p, "\tta:Z:chain,n_anchors: ", 23);
    p += 23;
    p = put_i64(p, n);
    *p++ = '\n';
  }
  *out = buf;
  *out_len = p - buf;
  return 0;
}

}  // extern "C"
