// Device pieces the two list decoders share: the SCL kernel
// (`scl_decode.cu`, its by-path and over-warps instantiations) and the PAC
// kernel (`pac_decode.cu`).  The f and g updates of the plain versions, op
// for op; the σ maps kept by path (a lane's path-origin rows, packed in a
// few registers) with the masks that reset them; the f/g and partial-sum
// passes that read a parent level through σ; the candidates' 64-bit keys
// and their sort within a warp (the by-path SCL fork); and, for a frame
// spread over the warps of a block (list sizes 33..1024, one thread a
// path), σ as a table in shared memory, the passes that read through it,
// its fork, the block-wide sort of the 2M candidates and the frame's
// shared-memory layout; and, for a frame over a thread-block cluster (list
// sizes 1025..8192), the same pieces across the cluster's blocks through
// distributed shared memory, and the cluster launch.
// Each source's note has the design; `_build.py` rebuilds a source when
// this file changes.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define MAX_LEVELS 16  // n at most: the phase words take N up to 65536

namespace {

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float f_minsum(float a, float b) {
  return sign_of(a) * sign_of(b) * fminf(fabsf(a), fabsf(b));
}

__device__ __forceinline__ float g_update(float a, float b, uint8_t c) {
  return b + (1.f - 2.f * (float)c) * a;
}

// The σ maps of the lane's path: field f of the packed words is the
// physical row that holds the path's data for σ level f (fields 0..n−2: LLR
// levels 1..n−1; fields n−1..2n−3: bit levels 2..n).  LM is the list size
// rounded up to a power of two; it sizes the fields: 32 / log2(LM) fields a
// word, 1-4 words, enough for n <= 13 (24 fields at LM 16 and 32).  WIDE
// adds a word, for the LM 16 and 32 instantiations that take n 14..16 (30
// fields: 32 at LM=16, 30 at LM=32); LM 2, 4 and 8 already hold 30
// (`ops/scl_cuda.py::SIGMA_FIELDS` counts them).
template <int LM, bool WIDE = false>
struct PathSigma {
  static constexpr int kBits = LM <= 2 ? 1 : LM == 4 ? 2 : LM == 8 ? 3 : LM == 16 ? 4 : 5;
  static constexpr int kFields = 32 / kBits;  // fields a word
  static constexpr int kWords = (LM <= 2 ? 1 : LM == 4 ? 2 : LM <= 16 ? 3 : 4) + WIDE;
  // whether the words hold a code of 2^n: 2n − 2 fields
  static __host__ __device__ constexpr bool holds(int n) { return 2 * n - 2 <= kWords * kFields; }
  unsigned w[kWords];

  // every field holding path m itself: the identity map
  static __device__ __forceinline__ unsigned identity(int m) {
    unsigned rep = 0;
#pragma unroll
    for (int j = 0; j < kFields; ++j) rep |= 1u << (kBits * j);
    return (unsigned)(m & (LM - 1)) * rep;
  }
  __device__ __forceinline__ void init(unsigned id) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] = id;
  }
  __device__ __forceinline__ int get(int f) const {
    const int k = f / kFields;
    unsigned x = w[0];
#pragma unroll
    for (int j = 1; j < kWords; ++j)
      if (k == j) x = w[j];
    return (int)((x >> (kBits * (f - k * kFields))) & (LM - 1));
  }
  // the fields set in mask[k] back to the identity `id`
  __device__ __forceinline__ void reset(const unsigned* mask, unsigned id) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] = (w[k] & ~mask[k]) | (id & mask[k]);
  }
  // σ ← σ[parent]: the lane takes its parent's maps
  __device__ __forceinline__ void fork(int parent) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] = __shfl_sync(FULL_MASK, w[k], parent);
  }
};

// The σ fields a level write resets, per word, built on the host for one
// (n, LM) and passed by value, so that a phase indexes them with its
// warp-uniform levels: llr[l] the fields of LLR levels l..n−1, bit[l] the
// field of bit level l.  W words: 4 for the instantiations that take n <=
// 13, 5 for the wide ones.
template <int W>
struct ResetMasksOf {
  unsigned llr[MAX_LEVELS + 1][W];
  unsigned bit[MAX_LEVELS + 1][W];
};
using ResetMasks = ResetMasksOf<4>;
using WideResetMasks = ResetMasksOf<5>;

template <int LM, bool WIDE = false>
ResetMasksOf<WIDE ? 5 : 4> reset_masks(int n) {
  using S = PathSigma<LM, WIDE>;
  ResetMasksOf<WIDE ? 5 : 4> r = {};
  auto set = [&](unsigned* words, int f) {
    words[f / S::kFields] |= ((1u << S::kBits) - 1u) << (S::kBits * (f % S::kFields));
  };
  for (int l = 1; l <= n; ++l) {
    for (int lv = l; lv < n; ++lv) set(r.llr[l], lv - 1);
    if (l >= 2) set(r.bit[l], n + l - 3);
  }
  return r;
}

// One f or g pass over a level of width half = 1 << lh, paths 0..M−1:
// dst[m][e] = f or g of the parent level's src[r][e] and src[r][e + half],
// r = σ(m) when `via` (`own` is then this lane's σ field of the parent
// level, and path m's comes from lane m) and m otherwise; a g takes dst's
// own partial sums as its left bits.  A pointer is a level's first entry
// and a path's row is `stride` entries long.  Each call site passes
// pointers that are all shared or all global, so that the inlined
// shared-memory accesses compile to LDS/STS.  Every lane runs every
// iteration (the shuffle needs the whole warp); lanes past the entries
// store nothing.
__device__ __forceinline__ void path_fg_pass(float* dst, const uint8_t* dbits, int dstride,
                                             const float* src, int sstride, bool via, int own,
                                             bool is_g, int lh, int M, int lane) {
  const int half = 1 << lh;
  const int total = M * half;
  for (int t0 = 0; t0 < total; t0 += 32) {
    const int t = t0 + lane;
    const int m = (t < total ? t : total - 1) >> lh;
    int r = m;
    if (via) r = __shfl_sync(FULL_MASK, own, m);
    if (t < total) {
      const int e = t & (half - 1);
      const float* row = src + r * sstride;
      const float a = row[e], b = row[e + half];
      const int o = m * dstride + e;
      dst[o] = is_g ? g_update(a, b, dbits[o]) : f_minsum(a, b);
    }
  }
}

// One step of the partial-sum chain, paths 0..M−1: the chain so far, sz =
// 1 << lsz bits at the start of the store level's row st[m], becomes
// [left[r] ^ cur, cur] in place, r as in path_fg_pass.
__device__ __forceinline__ void path_chain_pass(uint8_t* st, int ststride, const uint8_t* left,
                                                int lstride, bool via, int own, int lsz, int M,
                                                int lane) {
  const int sz = 1 << lsz;
  const int total = M * sz;
  for (int t0 = 0; t0 < total; t0 += 32) {
    const int t = t0 + lane;
    const int m = (t < total ? t : total - 1) >> lsz;
    int r = m;
    if (via) r = __shfl_sync(FULL_MASK, own, m);
    if (t < total) {
      const int e = t & (sz - 1);
      const uint8_t x = left[r * lstride + e];
      uint8_t* cur = st + m * ststride + e;
      const uint8_t c = cur[0];
      cur[sz] = c;
      cur[0] = x ^ c;
    }
  }
}

// ---------------------------------------------------------------------------
// A frame over the warps of a block: list sizes 33..1024.
//
// One block decodes one frame, thread m < M holds path m, and the block has
// M rounded up to a power of two threads (`deep_threads`); every exchange
// between paths goes through shared memory behind a block barrier.  σ is a
// table, a row of fields a path (field f as in PathSigma), each entry a T:
// uint8_t while the trace entries 2p+b < 2M fit a byte (M <= 128), else
// uint16_t.
// ---------------------------------------------------------------------------

#define DEEP_MIN_M 33    // list sizes below go one path a lane of a warp
#define DEEP_MAX_M 1024  // one thread a path, a block at most
#define DEEP_SIGMA_WORDS 12  // 32-bit words of a σ row at most: 2n−2 = 24 fields of 2 bytes
// the same at n 14..16 (30 fields of 2 bytes: 15 words), for the wide
// over-warps instantiations; their fork copies a row in halves of 8 words
#define DEEP_WIDE_SIGMA_WORDS 16
#define DEEP_FORK_WORDS 8

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// The keys a fork sorts: the 2M candidates padded to a power of two, at
// least 2M (`ops/scl_cuda.py::sort_keys`).
__host__ __device__ __forceinline__ int sort_keys(int M) {
  int P = 1;
  while (P < 2 * M) P <<= 1;
  return P;
}

// Byte offsets of a frame's regions in its block's dynamic shared memory,
// each region 16-byte aligned: the σ table [M][row] (a row of 2n−2 fields
// rounded to 4 bytes, so that paths m and m+1 fall in other banks), the
// sort keys u64 [sort_keys(M)] (at the end of the decode, the final
// metrics float [M]), the LLR rows float [M][(N>>G)−1], `words` 32-bit
// values a path (the published leaf, syndrome and, in PAC, shift
// register), the partial-sum rows u8 [M][(N>>G)−1] and the selected rank.
// The trace indices live in global scratch.  `ops/scl_cuda.py::
// deep_frame_bytes` is the same reckoning.
struct DeepLayout {
  int sig, keys, ls, words, bs, sel, total;
  int sig_row;  // bytes of a path's σ row: 4..60, a multiple of 4
};

__host__ __device__ __forceinline__ DeepLayout deep_layout(int N, int n, int M, int G,
                                                           int entry_bytes, int words) {
  DeepLayout d;
  const int ss = (N >> G) - 1;
  d.sig_row = round4((2 * n - 2) * entry_bytes);
  if (d.sig_row < 4) d.sig_row = 4;
  d.sig = 0;
  d.keys = d.sig + round16(M * d.sig_row);
  d.ls = d.keys + 8 * sort_keys(M);
  d.words = d.ls + round16(4 * M * ss);
  d.bs = d.words + words * round16(4 * M);
  d.sel = d.bs + round16(M * ss);
  d.total = d.sel + 16;
  return d;
}

// σ of every path, a row of `row` entries a path in shared memory; a row
// of WORDS 32-bit words at most.
template <typename T, int WORDS = DEEP_SIGMA_WORDS>
struct DeepSigma {
  T* tab;
  int row;  // entries a path's row
  int words;  // 32-bit words a path's row

  __device__ __forceinline__ int get(int m, int f) const { return tab[m * row + f]; }
  // the column of field f: entry m is path m's origin row
  __device__ __forceinline__ const T* field(int f) const { return tab + f; }
  // row i's fields 0..nf−1 to the identity of path id, the path the row
  // holds (i = id over warps; on a cluster a block's row i holds path
  // rank·1024 + i)
  __device__ __forceinline__ void init(int i, int id, int nf) {
    for (int f = 0; f < nf; ++f) tab[i * row + f] = (T)id;
  }
  // row i's fields lo..hi−1, and `extra` when it is >= 0, to the identity
  __device__ __forceinline__ void reset(int i, int id, int lo, int hi, int extra) {
    for (int f = lo; f < hi; ++f) tab[i * row + f] = (T)id;
    if (extra >= 0) tab[i * row + extra] = (T)id;
  }
  // σ ← σ[parent] for every path at once: each active thread copies its
  // parent's row through registers, between two block barriers (a wide row
  // in halves: words 0..7, then 8..15, whose reads follow only the first
  // half's writes).  Every thread of the block calls it.
  __device__ __forceinline__ void fork(int m, int parent, bool active) {
    if constexpr (WORDS <= DEEP_SIGMA_WORDS) {
      unsigned v[DEEP_SIGMA_WORDS];
      const unsigned* src = reinterpret_cast<const unsigned*>(tab + parent * row);
#pragma unroll
      for (int k = 0; k < DEEP_SIGMA_WORDS; ++k)
        if (active && k < words) v[k] = src[k];
      __syncthreads();
      unsigned* dst = reinterpret_cast<unsigned*>(tab + m * row);
#pragma unroll
      for (int k = 0; k < DEEP_SIGMA_WORDS; ++k)
        if (active && k < words) dst[k] = v[k];
      __syncthreads();
    } else {
      const unsigned* src = reinterpret_cast<const unsigned*>(tab + parent * row);
      unsigned* dst = reinterpret_cast<unsigned*>(tab + m * row);
#pragma unroll
      for (int h = 0; h < WORDS; h += DEEP_FORK_WORDS) {
        unsigned v[DEEP_FORK_WORDS];
#pragma unroll
        for (int k = 0; k < DEEP_FORK_WORDS; ++k)
          if (active && h + k < words) v[k] = src[h + k];
        __syncthreads();
#pragma unroll
        for (int k = 0; k < DEEP_FORK_WORDS; ++k)
          if (active && h + k < words) dst[h + k] = v[k];
        __syncthreads();
      }
    }
  }
};

// path_fg_pass over the threads of a block: r = via[m·vrow] when `via` (the
// σ column of the parent level), else m.
template <typename T>
__device__ __forceinline__ void block_fg_pass(float* dst, const uint8_t* dbits, int dstride,
                                              const float* src, int sstride, const T* via, int vrow,
                                              bool is_g, int lh, int M, int tid, int nt) {
  const int half = 1 << lh;
  const int total = M * half;
  for (int t = tid; t < total; t += nt) {
    const int m = t >> lh;
    const int e = t & (half - 1);
    const int r = via ? (int)via[m * vrow] : m;
    const float* row = src + r * sstride;
    const float a = row[e], b = row[e + half];
    const int o = m * dstride + e;
    dst[o] = is_g ? g_update(a, b, dbits[o]) : f_minsum(a, b);
  }
}

// path_chain_pass over the threads of a block, r as in block_fg_pass.
template <typename T>
__device__ __forceinline__ void block_chain_pass(uint8_t* st, int ststride, const uint8_t* left,
                                                 int lstride, const T* via, int vrow, int lsz,
                                                 int M, int tid, int nt) {
  const int sz = 1 << lsz;
  const int total = M * sz;
  for (int t = tid; t < total; t += nt) {
    const int m = t >> lsz;
    const int e = t & (sz - 1);
    const int r = via ? (int)via[m * vrow] : m;
    const uint8_t x = left[r * lstride + e];
    uint8_t* cur = st + m * ststride + e;
    const uint8_t c = cur[0];
    cur[sz] = c;
    cur[0] = x ^ c;
  }
}

// ---- the sort of a fork's 2M candidates ----
//
// A candidate is one 64-bit key: its metric in the high word, mapped to a
// 32-bit word whose unsigned order is the float order (the sign bit set on a
// non-negative float, every bit flipped on a negative one), and its layout
// index in the low word (2p + b in the SCL kernel, p and M + p in the PAC
// kernel's [good×M, bad×M]).  −0.0 is taken as +0.0 first: the floats
// compare equal and their words would not.  Metrics are never NaN, and 3e38
// and +inf map like any float, at most 0xFF800000, so the all-ones key
// that pads the 2M keys to P = sort_keys(M) sorts after every candidate.
// The keys are unique, so the ascending key order is exactly the plain
// version's stable (metric, index) sort, whatever the network: the key of
// rank r < M is survivor r.  No metric is −0.0 (each is +0.0 plus
// non-negative penalties, or 3e38), so the survivor takes its metric back
// from its key bit for bit.

__device__ __forceinline__ unsigned long long cand_key(float c, int index) {
  const unsigned u = c == 0.f ? 0u : __float_as_uint(c);
  const unsigned w = u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
  return (unsigned long long)w << 32 | (unsigned)index;
}

__device__ __forceinline__ float key_metric(unsigned long long key) {
  const unsigned w = (unsigned)(key >> 32);
  return __uint_as_float(w & 0x80000000u ? w ^ 0x80000000u : ~w);
}

__device__ __forceinline__ int key_index(unsigned long long key) { return (int)(unsigned)key; }

// One compare-exchange of a bitonic network, seen from one side: the
// smaller of the pair when keep_min, else the larger.
__device__ __forceinline__ unsigned long long keep_key(unsigned long long k, unsigned long long o,
                                                       bool keep_min) {
  return (o < k) == keep_min ? o : k;
}

// A bitonic network over one key a lane, ascending in each aligned group of
// P lanes (P a power of two, at most PMAX <= 32, warp-uniform): every stage
// is one __shfl_xor_sync of the key's two halves and a compare-select, with
// no shared memory and no barrier; log2(P)·(log2(P)+1)/2 stages.  Lane i of
// a group ends with its key of rank i.
template <int PMAX>
__device__ __forceinline__ unsigned long long warp_sort_keys(unsigned long long k, int lane, int P) {
#pragma unroll
  for (int size = 2; size <= PMAX; size <<= 1) {
    if (size > P) break;
#pragma unroll
    for (int j = size >> 1; j >= 1; j >>= 1)
      k = keep_key(k, __shfl_xor_sync(FULL_MASK, k, j), ((lane & j) == 0) == ((lane & size) == 0));
  }
  return k;
}

// The 32 smallest of 64 keys in order, two keys a lane: k0 at position
// `lane`, k1 at position lane + 32.  The first five merges sort k0 ascending and k1
// descending across the lanes (15 stages of shuffles), the last merge's
// first stage keeps the smaller of a lane's two in k0 (in registers), and
// its five further stages sort k0 alone: lane i ends with the key of rank i.
__device__ __forceinline__ unsigned long long warp_sort_keys64(unsigned long long k0,
                                                               unsigned long long k1, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j >= 1; j >>= 1) {
      const bool lower = (lane & j) == 0;
      const bool up = size == 32 || (lane & size) == 0;  // k0's run; k1's is the other way at 32
      const unsigned long long o0 = __shfl_xor_sync(FULL_MASK, k0, j);
      const unsigned long long o1 = __shfl_xor_sync(FULL_MASK, k1, j);
      k0 = keep_key(k0, o0, lower == up);
      k1 = keep_key(k1, o1, lower == (size == 32 ? false : up));
    }
  }
  k0 = k1 < k0 ? k1 : k0;
#pragma unroll
  for (int j = 16; j >= 1; j >>= 1)
    k0 = keep_key(k0, __shfl_xor_sync(FULL_MASK, k0, j), (lane & j) == 0);
  return k0;
}

// A bitonic network over the 2M keys of a fork, padded to P = sort_keys(M)
// with all-ones keys, ascending.  The block has P/2 threads (`deep_threads`)
// and thread t holds keys 2t and 2t+1 in registers: its two candidates, or
// two pads where t >= M.  A stage of distance j compare-exchanges keys i
// and i^j, the smaller to i when i's bit of the merge size is clear (else
// the larger): in registers when j = 1, by __shfl_xor_sync with lane t ^
// j/2, no barrier, when j < 64, and through keys[] behind block barriers
// above (15 of the 66 stages at P = 2048; 1 of 28 at P = 128).  Only ranks
// below M <= P/2 are read, so after the last merge's first stage, which
// leaves the P/2 smallest keys in the lower half, the upper half's threads
// stop, and only the lower half is stored to keys[].  Every thread of the
// block calls it; the caller reads keys[] behind a barrier.
__device__ __forceinline__ void block_sort_keys(unsigned long long* keys, unsigned long long k0,
                                                unsigned long long k1, int P, int tid) {
  const int base = 2 * tid;
  bool on = true;
  auto vec = [&](int at) { return reinterpret_cast<ulonglong2*>(keys + at); };
  // keep the smaller of a pair whose partner is across bit j >= 2: key i
  // below it in an ascending run (i's bit of the merge size clear), or
  // above it in a descending one; both keys of the thread alike
  auto exchange = [](unsigned long long& k, unsigned long long o, bool keep_min) {
    k = (o < k) == keep_min ? o : k;
  };
  for (int size = 2; size <= P; size <<= 1) {
    const bool up = (base & size) == 0;
    for (int j = size >> 1; j >= 64; j >>= 1) {  // across warps
      __syncthreads();  // the previous exchange's reads are done
      if (on) *vec(base) = make_ulonglong2(k0, k1);
      __syncthreads();
      if (on) {
        const bool keep_min = ((base & j) == 0) == up;
        const ulonglong2 o = *vec(base ^ j);
        exchange(k0, o.x, keep_min);
        exchange(k1, o.y, keep_min);
      }
      if (size == P) on = on && base < P / 2;
    }
    if (on) {
#pragma unroll
      for (int j = 32; j >= 2; j >>= 1) {  // within the warp
        if (j < size) {
          const bool keep_min = ((base & j) == 0) == up;
          exchange(k0, __shfl_xor_sync(FULL_MASK, k0, j / 2), keep_min);
          exchange(k1, __shfl_xor_sync(FULL_MASK, k1, j / 2), keep_min);
        }
      }
      const bool swap = (k0 > k1) == up;  // j = 1, in registers
      const unsigned long long lo = swap ? k1 : k0;
      k1 = swap ? k0 : k1;
      k0 = lo;
    }
  }
  __syncthreads();  // the last exchange's reads are done
  if (on) *vec(base) = make_ulonglong2(k0, k1);
}

// ---------------------------------------------------------------------------
// A frame over a thread-block cluster: list sizes 1025..8192.
//
// One frame a cluster of C = cluster_blocks(M) blocks (2 at M 1025..2048, 4
// up to 4096, 8 up to 8192: 8 is the portable cluster size) of 1024
// threads: thread tid of cluster rank r holds path r·1024 + tid and sort
// keys 2(r·1024 + tid) and +1, as over warps.  Tree levels G+1..n of the
// block's own 1024 paths live in its shared memory (rows of (N >> G) − 1
// entries, as over warps), and levels 1..G of every path in global scratch
// (rows of N − (N >> G) entries); G is the smallest whose block fits
// (`ops/scl_cuda.py::launch_plan`).  Path p lives in rank p >> 10 at row
// p & 1023: a read through σ of a shared level whose row is another
// block's goes through distributed shared memory (`cluster_row`), the
// block's own rows are plain shared loads, and a global row another block
// may have written is read with ld.global.cg, from L2.  Block r's shared
// memory also holds σ of its own paths (16-bit fields: 2p+b < 2M <= 16384)
// in two tables, one read and one a fork's target (`cluster_sigma_fork`),
// three sort-key buffers (`cluster_sort_keys`) and its paths' published
// words in two sets; σ's table and the word set an info phase uses go by
// the phase's parity (`cluster_layout`).
//
// The cluster barriers (barrier.cluster arrive.release / wait.acquire):
// one a cross-block sort stage and one for the sorted keys (so 2, 4 and 7
// an info phase at P = 4096, 8192 and 16384), and one a phase whose word
// flags a read through σ, split: the block arrives after the phase's last
// read of another block's rows and waits before its next phase's passes,
// the only writes another block may read that it had been reading (σ's
// tables, the key buffers and the word sets are each rewritten only
// behind a later sort's barriers).  A tree row another block reads through
// σ was written before the fork that σ records, and so before that fork's
// sort barriers.
//
// Offsets.  Every kernel takes a frame's base in 64 bits (frame · its size)
// and indexes within the frame with 32-bit products; the largest are here.
// At N = 65536 and M = 8192 a trace entry info_i·M + m and a list row's
// start m·N reach 2^29, and a global tree row's start r·(N − (N >> G)) is
// below 8191 · 65535 < 2^29: a quarter of 2^31.
// ---------------------------------------------------------------------------

#define CLUSTER_THREADS 1024  // threads a block of a cluster frame: one a path
#define CLUSTER_SHIFT 10      // log2(CLUSTER_THREADS)
#define CLUSTER_KEYS (2 * CLUSTER_THREADS)  // sort keys a block holds
#define CLUSTER_MAX_BLOCKS 8  // the portable cluster size
#define CLUSTER_MAX_M (CLUSTER_THREADS * CLUSTER_MAX_BLOCKS)
// Blocks of a cluster frame: M rounded up to a power of two, over 1024.
__host__ __device__ __forceinline__ int cluster_blocks(int M) {
  return sort_keys(M) / 2 / CLUSTER_THREADS;
}

// The key exchanges of one cluster sort of P keys: its cross-block stages
// (j >= 2048 in each merge of 4096 keys or more: 1, 3, 6 at P = 4096, 8192,
// 16384) and the sorted keys' store.  Sort i of a launch starts at count
// i·cluster_exchanges(P), which picks its buffers (`cluster_sort_keys`).
__host__ __device__ __forceinline__ int cluster_exchanges(int P) {
  int x = 1;
  for (int size = 2 * CLUSTER_KEYS; size <= P; size <<= 1)
    for (int j = size >> 1; j >= CLUSTER_KEYS; j >>= 1) ++x;
  return x;
}

// Byte offsets of one block's regions in its dynamic shared memory, each
// 16-byte aligned: two σ tables [1024][row] (2n−2 16-bit fields a path, a
// row rounded to 4 bytes), three buffers of 2048 sort keys u64, two sets of
// `words` 32-bit values a path (the published leaf, syndrome and, in PAC,
// shift register), the LLR rows float [1024][(N>>G)−1] and partial-sum rows
// u8 [1024][(N>>G)−1] of levels G+1..n, and the selected rank.
// `ops/scl_cuda.py::cluster_block_bytes` is the same reckoning.
struct ClusterLayout {
  int sig, sig2, keys, words, ls, bs, sel, total;
  int sig_row;  // bytes of a path's σ row: 4..60, a multiple of 4
  int word_set;  // bytes of one set of published words
};

__host__ __device__ __forceinline__ ClusterLayout cluster_layout(int N, int n, int G, int words) {
  ClusterLayout c;
  const int ss = (N >> G) - 1;
  c.sig_row = round4((2 * n - 2) * 2);
  if (c.sig_row < 4) c.sig_row = 4;
  c.sig = 0;
  c.sig2 = round16(CLUSTER_THREADS * c.sig_row);
  c.keys = 2 * c.sig2;
  c.words = c.keys + 3 * 8 * CLUSTER_KEYS;
  c.word_set = words * 4 * CLUSTER_THREADS;
  c.ls = c.words + 2 * c.word_set;
  c.bs = c.ls + round16(4 * CLUSTER_THREADS * ss);
  c.sel = c.bs + round16(CLUSTER_THREADS * ss);
  c.total = c.sel + 16;
  return c;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// Path p's entry of a per-path array of `stride` entries a path, whose
// block-local copy starts at `local`: rank p >> 10's, through DSMEM.
template <typename T>
__device__ __forceinline__ T* path_entry(T* local, int p, int stride = 1) {
  return cooperative_groups::this_cluster().map_shared_rank(
      local + (p & (CLUSTER_THREADS - 1)) * stride, p >> CLUSTER_SHIFT);
}

// Path r's row of a shared level whose block-local rows (`stride` entries
// apart) start at `local`: the block's own row, or another block's through
// DSMEM.
template <typename T>
__device__ __forceinline__ const T* cluster_row(const T* local, int r, int stride, int rank) {
  T* row = const_cast<T*>(local) + (r & (CLUSTER_THREADS - 1)) * stride;
  const int owner = r >> CLUSTER_SHIFT;
  return owner == rank ? row : cooperative_groups::this_cluster().map_shared_rank(row, owner);
}

// σ ← σ[parent] for every path of the cluster, from one table to the other:
// each active thread copies its parent's row from `sig`'s table (through
// DSMEM) into its own row of `next`, a few words at a time, behind a block
// barrier (only the block's own threads read their rows).  The tables
// alternate by the info phase's parity: `next` is read from the next
// phase on, and `sig`'s is the next fork's target, which writes it behind
// that fork's sort barriers, after every block's reads here.  Two tables,
// where one would hold the row in registers across a cluster barrier (12
// words at n = 13, 15 at n = 16, past the 64-register cap); the copy's
// loop takes a row of any n up to MAX_LEVELS.  Every thread of the block
// calls it.
__device__ __forceinline__ void cluster_sigma_fork(const DeepSigma<uint16_t>& sig, uint16_t* next,
                                                   int tid, int parent, bool active) {
  if (active) {
    const unsigned* src = path_entry(reinterpret_cast<unsigned*>(sig.tab), parent, sig.words);
    unsigned* dst = reinterpret_cast<unsigned*>(next + tid * sig.row);
#pragma unroll 4
    for (int k = 0; k < sig.words; ++k) dst[k] = src[k];
  }
  __syncthreads();
}

// One f or g pass over a level of width half = 1 << lh for the paths
// base..base+Mr−1 of one block: dst[lm][e] (the block's rows from dst,
// `dstride` entries apart, shared or global) is the f or g of the parent
// level's entries e and e + half of row r = via[lm·vrow] (the block's σ
// column of the parent level) when `via`, else of the path's own row.
// SHARED: the parent level is in shared memory (`src` the block's first
// row, rows `sstride` apart; another block's row through DSMEM); else in
// global scratch (`src` path 0's row, rows `sstride` apart, 0 for the
// channel), read from L2.  A g takes dst's own partial sums as its left
// bits.
template <bool SHARED>
__device__ __forceinline__ void cluster_fg_pass(float* dst, const uint8_t* dbits, int dstride,
                                                const float* src, int sstride, const uint16_t* via,
                                                int vrow, bool is_g, int lh, int base, int rank,
                                                int Mr, int tid) {
  const int half = 1 << lh;
  const int total = Mr * half;
  // one iteration at a time: unrolled, K3's list instantiation spills at
  // the 64-register cap (this loop and cluster_chain_pass's)
#pragma unroll 1
  for (int t = tid; t < total; t += CLUSTER_THREADS) {
    const int lm = t >> lh;
    const int e = t & (half - 1);
    float a, b;
    if (SHARED) {
      const float* row = via ? cluster_row(src, (int)via[lm * vrow], sstride, rank) : src + lm * sstride;
      a = row[e];
      b = row[e + half];
    } else {
      const float* row = src + (via ? (int)via[lm * vrow] : base + lm) * sstride;
      a = __ldcg(row + e);
      b = __ldcg(row + e + half);
    }
    const int o = lm * dstride + e;
    dst[o] = is_g ? g_update(a, b, dbits[o]) : f_minsum(a, b);
  }
}

// One step of the partial-sum chain for the paths base..base+Mr−1 of one
// block: the chain so far, sz = 1 << lsz bits at the start of the store
// level's row (the block's rows from `st`, `ststride` apart, shared or
// global), becomes [left[r] ^ cur, cur] in place, r as in cluster_fg_pass
// (SHARED: the left level in shared memory, else in global scratch).
template <bool SHARED>
__device__ __forceinline__ void cluster_chain_pass(uint8_t* st, int ststride, const uint8_t* left,
                                                   int lstride, const uint16_t* via, int vrow,
                                                   int lsz, int base, int rank, int Mr, int tid) {
  const int sz = 1 << lsz;
  const int total = Mr * sz;
#pragma unroll 1
  for (int t = tid; t < total; t += CLUSTER_THREADS) {
    const int lm = t >> lsz;
    const int e = t & (sz - 1);
    uint8_t x;
    if (SHARED)
      x = (via ? cluster_row(left, (int)via[lm * vrow], lstride, rank) : left + lm * lstride)[e];
    else
      x = __ldcg(left + (via ? (int)via[lm * vrow] : base + lm) * lstride + e);
    uint8_t* cur = st + lm * ststride + e;
    const uint8_t c = cur[0];
    cur[sz] = c;
    cur[0] = x ^ c;
  }
}

// block_sort_keys over a cluster: the P = sort_keys(M) keys (P >= 4096),
// thread tid of rank r holding keys 2(r·1024 + tid) and +1 in registers.
// A stage of distance j >= 2048 pairs keys of two blocks: each stores its
// keys in its exchange buffer X[xc & 1] (xc counts the cluster's exchanges
// over the launch), one cluster barrier, and each reads its partner's from
// rank r ^ (j / 2048) through DSMEM (1 / 3 / 6 of the 78 / 91 / 105 stages
// at P = 4096 / 8192 / 16384).  A stage of distance 64..1024 goes through
// the block's own buffers, Y and the exchange buffer the last cross-block
// stage did not use, in turns, one block barrier a stage: a buffer is
// rewritten only after the barrier of the stage that follows its reads,
// and the one another block may still read is not rewritten before the
// next cluster barrier.  Below, the warp and registers, as in
// block_sort_keys.  After the last merge's first stage the upper half's
// blocks stop, and the lower half is stored to the next exchange buffer
// behind a cluster barrier: the key of rank q is then rank q >> 11's entry
// q & 2047 of the buffer returned (`cluster_key`).  Every thread of the
// cluster calls it, with the same xc: the launch's exchanges before it.
__device__ __forceinline__ unsigned long long* cluster_sort_keys(unsigned long long* keys,
                                                                 unsigned long long k0,
                                                                 unsigned long long k1, int P,
                                                                 int rank, int tid, int xc) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int base = 2 * (rank * CLUSTER_THREADS + tid);
  const int lbase = 2 * tid;
  unsigned long long* const Y = keys + 2 * CLUSTER_KEYS;
  bool on = true;
  int ib = 0;  // in-block stages since the last cross-block one: Y at even counts
  auto X = [&](int c) { return keys + (c & 1) * CLUSTER_KEYS; };
  auto exchange = [](unsigned long long& k, unsigned long long o, bool keep_min) {
    k = (o < k) == keep_min ? o : k;
  };
  for (int size = 2; size <= P; size <<= 1) {
    const bool up = (base & size) == 0;
    int j = size >> 1;
    for (; j >= CLUSTER_KEYS; j >>= 1) {  // across blocks
      ulonglong2* buf = reinterpret_cast<ulonglong2*>(X(xc) + lbase);
      if (on) *buf = make_ulonglong2(k0, k1);
      cluster_barrier();
      if (on) {
        const bool keep_min = ((base & j) == 0) == up;
        const ulonglong2 o = *cluster.map_shared_rank(buf, rank ^ (j / CLUSTER_KEYS));
        exchange(k0, o.x, keep_min);
        exchange(k1, o.y, keep_min);
      }
      ++xc;
      ib = 0;
      if (size == P) on = on && base < P / 2;
    }
    for (; j >= 64; j >>= 1) {  // across warps of the block
      unsigned long long* buf = (ib++ & 1) ? X(xc) : Y;
      if (on) *reinterpret_cast<ulonglong2*>(buf + lbase) = make_ulonglong2(k0, k1);
      __syncthreads();
      if (on) {
        const bool keep_min = ((base & j) == 0) == up;
        const ulonglong2 o = *reinterpret_cast<const ulonglong2*>(buf + (lbase ^ j));
        exchange(k0, o.x, keep_min);
        exchange(k1, o.y, keep_min);
      }
      if (size == P) on = on && base < P / 2;
    }
    if (on) {
#pragma unroll
      for (int jj = 32; jj >= 2; jj >>= 1) {  // within the warp
        if (jj < size) {
          const bool keep_min = ((base & jj) == 0) == up;
          exchange(k0, __shfl_xor_sync(FULL_MASK, k0, jj / 2), keep_min);
          exchange(k1, __shfl_xor_sync(FULL_MASK, k1, jj / 2), keep_min);
        }
      }
      const bool swap = (k0 > k1) == up;  // j = 1, in registers
      const unsigned long long lo = swap ? k1 : k0;
      k1 = swap ? k0 : k1;
      k0 = lo;
    }
  }
  unsigned long long* sorted = X(xc);  // Y and this one's stage reads are behind a barrier
  if (on) *reinterpret_cast<ulonglong2*>(sorted + lbase) = make_ulonglong2(k0, k1);
  cluster_barrier();
  return sorted;
}

// The key of rank q after cluster_sort_keys: rank q >> 11's sorted[q & 2047].
__device__ __forceinline__ unsigned long long cluster_key(unsigned long long* sorted, int q) {
  return *cooperative_groups::this_cluster().map_shared_rank(
      sorted + (q & (CLUSTER_KEYS - 1)), q >> (CLUSTER_SHIFT + 1));
}

// ---- host side ----

// Whether the one-path-a-lane kernels of width LM take their wide twin at
// n: only LM 16 and 32 have one, and their narrow words hold n <= 13.
template <int LM>
bool path_wide(int n) {
  return LM >= 16 && !PathSigma<LM>::holds(n);
}

// Whether an over-warps σ row of T entries at n outgrows the fork's
// DEEP_SIGMA_WORDS registers: 16-bit entries past n = 13.
template <typename T>
bool deep_wide(int n) {
  return round4((2 * n - 2) * (int)sizeof(T)) > 4 * DEEP_SIGMA_WORDS;
}

// Let a kernel take more than 48 KB of dynamic shared memory.
template <typename Kern>
cudaError_t set_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Threads of an over-warps block: one a pair of sort keys, M rounded up to
// a power of two.  Where M is not one, the threads past M only sort pads
// (M = 65: 128 threads, where a warp a 32 paths would take 96): two keys
// a thread keep the sort within the 64 registers that the 1024-thread
// launch bound allows, where four a thread made the SCL kernel spill.
inline int deep_threads(int M) { return sort_keys(M) / 2; }

// One frame a block: the blocks an SM holds at once, by the occupancy
// calculator (shared memory, registers and the block's `deep_threads`).
template <typename Kern>
int plan_deep(Kern kernel, int M, int frame_bytes, int max_block_smem, int* frames_per_block,
              int* frames_per_sm) {
  *frames_per_block = 1;
  *frames_per_sm = 0;
  if (frame_bytes > max_block_smem) return 0;
  cudaError_t err = set_smem(kernel, frame_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(frames_per_sm, kernel, deep_threads(M),
                                                             frame_bytes);
}

// The launch of `frames` frames, a cluster of cluster_blocks(M) blocks of
// 1024 threads each with `block_bytes` of dynamic shared memory; `attr`,
// the cluster's dimension, must outlive the configuration.
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int frames, int M, int block_bytes,
                                         cudaStream_t stream) {
  const int C = cluster_blocks(M);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)frames * C);
  cfg.blockDim = dim3(CLUSTER_THREADS);
  cfg.dynamicSmemBytes = block_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One frame a cluster: the frames the card runs at once, by the occupancy
// calculator (cudaOccupancyMaxActiveClusters: shared memory, registers,
// and where the GPCs can place a cluster of cluster_blocks(M) blocks);
// 0 when it places none.
template <typename Kern>
int plan_cluster(Kern kernel, int M, int block_bytes, int max_block_smem, int* frames_at_once) {
  *frames_at_once = 0;
  if (block_bytes > max_block_smem) return 0;
  cudaError_t err = set_smem(kernel, block_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, 1, M, block_bytes, 0);
  return (int)cudaOccupancyMaxActiveClusters(frames_at_once, (const void*)kernel, &cfg);
}

// Launch a cluster kernel over B frames (`cluster_config`).
template <typename... Params, typename... Values>
int launch_cluster_kernel(void (*kernel)(Params...), int B, int M, int block_bytes,
                          cudaStream_t stream, Values... args) {
  cudaError_t err = set_smem(kernel, block_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, B, M, block_bytes, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The final stable (metric, slot) rank of path m among the M metrics
// metric[j], and the least rank of the paths with `ok` set (M when none has
// it), by a min-reduction in *sel.  Every thread of the block calls it;
// *sel must hold M, and metric[j] path j's metric, behind a barrier.
__device__ __forceinline__ int final_rank(const float* metric, int M, int m, float pm, bool ok,
                                          int* sel, int* least) {
  int rank = 0;
  if (m < M)
    for (int j = 0; j < M; ++j) {
      const float pj = metric[j];
      rank += (pj < pm) || (pj == pm && j < m);
    }
  if (ok) atomicMin(sel, rank);
  __syncthreads();
  *least = *sel;
  return rank;
}

}  // namespace
