// Device pieces the two list decoders share: the SCL kernel
// (`scl_decode.cu`, its by-path and over-warps instantiations) and the PAC
// kernel (`pac_decode.cu`).  The f and g updates of the plain versions, op
// for op; the σ maps kept by path (a lane's path-origin rows, packed in a
// few registers) with the masks that reset them; the f/g and partial-sum
// passes that read a parent level through σ; and, for a frame spread over
// the warps of a block (list sizes 33..1024, one thread a path), σ as a
// table in shared memory, the passes that read through it, its fork, the
// stable rank of the 2M candidates and the frame's shared-memory layout.
// Each source's note has the design; `_build.py` rebuilds a source when
// this file changes.

#pragma once

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
// word, 1-4 words (`ops/scl_cuda.py::SIGMA_FIELDS` counts them).
template <int LM>
struct PathSigma {
  static constexpr int kBits = LM <= 2 ? 1 : LM == 4 ? 2 : LM == 8 ? 3 : LM == 16 ? 4 : 5;
  static constexpr int kFields = 32 / kBits;  // fields a word
  static constexpr int kWords = LM <= 2 ? 1 : LM == 4 ? 2 : LM <= 16 ? 3 : 4;
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
// field of bit level l.
struct ResetMasks {
  unsigned llr[MAX_LEVELS + 1][4];
  unsigned bit[MAX_LEVELS + 1][4];
};

template <int LM>
ResetMasks reset_masks(int n) {
  using S = PathSigma<LM>;
  ResetMasks r = {};
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
// ceil(M/32) warps; every exchange between paths goes through shared memory
// behind a block barrier.  σ is a table, a row of fields a path (field f as
// in PathSigma), each entry a T: uint8_t while the trace entries 2p+b < 2M
// fit a byte (M <= 128), else uint16_t.
// ---------------------------------------------------------------------------

#define DEEP_MIN_M 33    // list sizes below go one path a lane of a warp
#define DEEP_MAX_M 1024  // one thread a path, a block at most
#define DEEP_SIGMA_VECS 3  // 16-byte words of a σ row at most: 2n−2 = 24 fields of 2 bytes

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// Byte offsets of a frame's regions in its block's dynamic shared memory,
// each region 16-byte aligned: the σ table [M][row], the candidates float2
// [M], the LLR rows float [M][(N>>G)−1], `words` 32-bit values a path (the
// published leaf, syndrome and, in PAC, shift register), the partial-sum
// rows u8 [M][(N>>G)−1], the trace indices T [K][M] when they stay in shared
// memory, and the selected rank.  `ops/scl_cuda.py::deep_frame_bytes` is the
// same reckoning.
struct DeepLayout {
  int sig, cand, ls, words, bs, ti, sel, total;
  int sig_row;  // bytes of a path's σ row: 16, 32 or 48
};

__host__ __device__ __forceinline__ DeepLayout deep_layout(int N, int n, int K, int M, int G,
                                                           int entry_bytes, int words,
                                                           bool trace_in_smem) {
  DeepLayout d;
  const int ss = (N >> G) - 1;
  d.sig_row = round16((2 * n - 2) * entry_bytes);
  if (d.sig_row < 16) d.sig_row = 16;
  d.sig = 0;
  d.cand = d.sig + M * d.sig_row;
  d.ls = d.cand + round16(8 * M);
  d.words = d.ls + round16(4 * M * ss);
  d.bs = d.words + words * round16(4 * M);
  d.ti = d.bs + round16(M * ss);
  d.sel = d.ti + (trace_in_smem ? round16(K * M * entry_bytes) : 0);
  d.total = d.sel + 16;
  return d;
}

// σ of every path, a row of `row` entries a path in shared memory.
template <typename T>
struct DeepSigma {
  T* tab;
  int row;  // entries a path's row
  int vecs;  // 16-byte words a path's row

  __device__ __forceinline__ int get(int m, int f) const { return tab[m * row + f]; }
  // the column of field f: entry m is path m's origin row
  __device__ __forceinline__ const T* field(int f) const { return tab + f; }
  // path m's fields 0..nf−1 to the identity
  __device__ __forceinline__ void init(int m, int nf) {
    for (int f = 0; f < nf; ++f) tab[m * row + f] = (T)m;
  }
  // path m's fields lo..hi−1, and `extra` when it is >= 0, to the identity
  __device__ __forceinline__ void reset(int m, int lo, int hi, int extra) {
    for (int f = lo; f < hi; ++f) tab[m * row + f] = (T)m;
    if (extra >= 0) tab[m * row + extra] = (T)m;
  }
  // σ ← σ[parent] for every path at once: each active thread copies its
  // parent's row through registers, between two block barriers.  Every
  // thread of the block calls it.
  __device__ __forceinline__ void fork(int m, int parent, bool active) {
    uint4 v[DEEP_SIGMA_VECS];
    const uint4* src = reinterpret_cast<const uint4*>(tab + parent * row);
#pragma unroll
    for (int k = 0; k < DEEP_SIGMA_VECS; ++k)
      if (active && k < vecs) v[k] = src[k];
    __syncthreads();
    uint4* dst = reinterpret_cast<uint4*>(tab + m * row);
#pragma unroll
    for (int k = 0; k < DEEP_SIGMA_VECS; ++k)
      if (active && k < vecs) dst[k] = v[k];
    __syncthreads();
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

// The stable rank of two candidates among the 2M of a fork, cand[j] =
// (x_j, y_j): a candidate of metric c ranks after every x_j < c and every
// y_j < c, and after x_j == c when j < ax and y_j == c when j < ay (the
// candidates of lower index: the caller's layout sets the thresholds).  So
// ranks are a permutation of 0..2M−1 in (metric, index) order, the plain
// version's stable sort.  Reads of cand[j] are broadcasts.
__device__ __forceinline__ void rank_pair(const float2* cand, int M, float c0, int a0x, int a0y,
                                          float c1, int a1x, int a1y, int* r0, int* r1) {
  int k0 = 0, k1 = 0;
  for (int j = 0; j < M; ++j) {
    const float2 q = cand[j];
    k0 += (q.x < c0) || (q.x == c0 && j < a0x);
    k0 += (q.y < c0) || (q.y == c0 && j < a0y);
    k1 += (q.x < c1) || (q.x == c1 && j < a1x);
    k1 += (q.y < c1) || (q.y == c1 && j < a1y);
  }
  *r0 = k0;
  *r1 = k1;
}

// ---- host side ----

// Let a kernel take more than 48 KB of dynamic shared memory.
template <typename Kern>
cudaError_t set_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// threads of an over-warps block: a whole warp a 32 paths
inline int deep_threads(int M) { return 32 * ((M + 31) / 32); }

// One frame a block: the blocks an SM holds at once, by the occupancy
// calculator (shared memory, registers and the block's ceil(M/32) warps).
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

// The final stable (metric, slot) rank of path m among the M metrics
// cand[j].x, and the least rank of the paths with `ok` set (M when none has
// it), by a min-reduction in *sel.  Every thread of the block calls it;
// *sel must hold M, and cand[j].x path j's metric, behind a barrier.
__device__ __forceinline__ int final_rank(const float2* cand, int M, int m, float pm, bool ok,
                                          int* sel, int* least) {
  int rank = 0;
  if (m < M)
    for (int j = 0; j < M; ++j) {
      const float pj = cand[j].x;
      rank += (pj < pm) || (pj == pm && j < m);
    }
  if (ok) atomicMin(sel, rank);
  __syncthreads();
  *least = *sel;
  return rank;
}

}  // namespace
