// Device pieces the two list decoders share: the SCL kernel
// (`scl_decode.cu`, its by-path instantiation) and the PAC kernel
// (`pac_decode.cu`).  The f and g updates of the plain versions, op for op;
// the σ maps kept by path (a lane's path-origin rows, packed in a few
// registers) with the masks that reset them; and the f/g and partial-sum
// passes that read a parent level through σ.  Each source's note has the
// design; `_build.py` rebuilds a source when this file changes.

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

}  // namespace
