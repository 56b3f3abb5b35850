// Fused CRC-aided SCL list decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `polar_code_tpu/ops/scl_pallas.py:293`
// `_kernel_body` (built by `_build_kernel_for`, called by
// `decode_scl_pallas`).  It computes what
// `polar_code_tpu_torch/ops/scl.py` `decode_scl_batch` computes and returns
// its fast-path subset: the CRC-selected path's bits and info-phase LLRs,
// and the CRC pass flag.
//
// What bounds it on this card.  Not bytes (an input row of N floats and an
// output row of K bytes + K floats per frame) and not the arithmetic peak
// (the bound is operations, some 200x below the measured time at
// P(128,64)), but the serial phase chain: N phases, each a few dependent
// passes over shared memory separated by warp barriers.  So the time is a
// frame's latency, hidden by keeping many frames (warps) on each SM, and the
// instructions each phase issues.
//
// What held the first design back.  It cloned the survivors in place at
// every info phase, column by column, on every level the static schedule
// still read.  At M=8 that clone moved 66,672 entries a frame at P(128,64)
// against 7,168 f/g entries (about 80% of the kernel's shared-memory
// instructions) and 16.7 M entries at N=2048 K=1024 against 180,224 (about
// 97%), on the dependent chain of every info phase.  And it kept the trace
// LLRs in shared memory, so a frame took 122,848 B at N=2048 M=8: one warp
// an SM.
//
// The lazy clone (the TPU kernel's default, `scl_pallas.py:30-37`).  Path m
// always writes its own physical row m.  Each tree level has a path-origin
// map σ: σ_l[m] is the row that holds path m's data for level l.  A level
// write resets its σ to identity; at a fork survivor m takes its parent's
// maps, σ ← σ[parent].  Only two reads can cross a fork, and only they read
// through σ, where the static schedule says a fork did happen since the
// level's last write (`scl_schedule.schedule_tables`):
//   * the g update's parent-LLR read at level gl−1 (`gpar_need[p]`);
//   * the partial-sum chain's left-bit reads at levels n..s+1
//     (`comb_need[p]`).
// Every other read is of the path's own row: an f reads the level the same
// phase just wrote, and the g's left-bit read was stored by the previous
// phase's chain with no fork between.  No write lands on a row that a σ
// still points at: every path writes the same levels in the same phase, so
// when level l is written, all M rows of level l are rewritten together, its
// σ becomes identity for every path, and the reads of that step are of other
// levels (the g's level gl−1, the chain's levels above s).  No row is copied
// at a fork.
//
// σ lives in registers.  Lane r < 2n−1 holds the map of one level as a word
// of M bytes, byte m = σ[m]: rows 0..n−2 for LLR levels 1..n−1 (level n is
// read only at its own leaf), rows n−1..2n−2 for bit levels 1..n.  A fork is
// two byte permutes (`__byte_perm`, prmt) in every lane, their selectors the
// survivors' parents gathered by two warp reductions; a read through σ is
// one shuffle from the level's lane, once per level and phase.
//
// Layout.  One warp decodes one frame; a block holds a few frames.  Levels
// G+1..n of each path live in dynamic shared memory, with the trace indices;
// levels 1..G (the widest: levels 1 and 2 alone hold three quarters of the
// rows, and are read at a handful of phases) live in a global scratch the
// wrapper allocates, with the trace LLRs, which are written once an info
// phase and read once at the end.  The wrapper picks the smallest G at
// which the occupancy calculator puts 16 frames on an SM (G=4 at N=2048
// M=8: 13,280 B a frame).  Per frame in shared memory:
//   Ls  float [M][(N>>G)-1]  LLR rows, one active node per level G+1..n−1
//                            (and an unused entry for level n)
//   Bs  u8    [M][(N>>G)-1]  partial-sum rows, levels G+1..n
//   TI  u8    [K][M]         creation index 2p+b of each survivor per info phase
// and in global memory, per frame:
//   Lg  float [M][N-(N>>G)]  LLR rows, levels 1..G
//   Bg  u8    [M][N-(N>>G)]  partial-sum rows, levels 1..G
//   TL  float [K][M]         leaf LLR of each survivor's parent per info phase
// A phase's schedule is one word, loaded a phase ahead.  Lanes split each
// level's M·(N>>l) f/g entries down to level n−1; lane m computes path m's
// leaf from its level-n−1 row and keeps it in a register (no phase but its
// own reads it), and takes the partial-sum chain's first step the same way.
// At an info phase lane i < 2M holds candidate i = 2p+b; its rank in
// (metric, index) order is counted with shuffles, which is the stable sort
// of the plain version, and ranks < M survive.  Each path carries its CRC syndrome (the XOR of the 32-bit
// check columns of its set bits), so selection needs no walk; the selected
// path's trace is walked back by one lane, which records each info phase's
// slot, and all lanes then write the outputs.
//
// The arithmetic is the plain version's, op for op, so results are equal bit
// for bit: f = sign(a)·sign(b)·min(|a|,|b|), g = b + (1−2c)·a, penalty
// max(x,0) + log1p(exp(−|x|)) with the accurate expf/log1pf (build without
// fast math and with -fmad=false).  Unreachable candidates carry 3e38.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCL_BIG 3.0e38f
#define FULL_MASK 0xffffffffu
#define MAX_FRAMES_PER_BLOCK 4  // warps a block at most; `plan` picks how many

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

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// σ word of one level: byte m is the physical row of path m
template <int M>
struct Sigma {
  using T = unsigned;
  static constexpr T kIdentity = 0x03020100u;
  static __device__ __forceinline__ T fork(T w, unsigned sel_lo, unsigned) {
    return __byte_perm(w, 0u, sel_lo);
  }
};

template <>
struct Sigma<8> {
  using T = unsigned long long;
  static constexpr T kIdentity = 0x0706050403020100ull;
  static __device__ __forceinline__ T fork(T w, unsigned sel_lo, unsigned sel_hi) {
    const unsigned lo = (unsigned)w, hi = (unsigned)(w >> 32);
    return (T)__byte_perm(lo, hi, sel_lo) | ((T)__byte_perm(lo, hi, sel_hi) << 32);
  }
};

template <typename T>
__device__ __forceinline__ int sigma_row(T w, int m) {
  return (int)((w >> (8 * m)) & 0xff);
}

// One f or g pass over a level of width half = 1 << lh, every path:
// dst[m][e] = f or g of the parent level's src[σ(m)][e] and
// src[σ(m)][e + half] (a g takes dst's own partial sums as its left bits).
// A pointer is a level's first entry and a path's row is `stride` entries
// long.  Each call site passes pointers that are all shared or all global,
// so that the inlined shared-memory accesses compile to LDS/STS.  When a
// level has fewer than 32 entries (most passes), lanes past them repeat an
// entry (total is a power of two) and store the same value: no branch.
template <int M, typename SigT>
__device__ __forceinline__ void fg_pass(float* dst, const uint8_t* dbits, int dstride,
                                        const float* src, int sstride, SigT psig, bool is_g,
                                        int lh, int lane) {
  const int half = 1 << lh;
  const int total = M * half;
  for (int t = total < 32 ? lane & (total - 1) : lane; t < total; t += 32) {
    const int m = t >> lh;
    const int e = t & (half - 1);
    const float* row = src + sigma_row(psig, m) * sstride;
    const float a = row[e], b = row[e + half];
    const int o = m * dstride + e;
    dst[o] = is_g ? g_update(a, b, dbits[o]) : f_minsum(a, b);
    if (total < 32) break;
  }
}

// One step of the partial-sum chain, every path: the chain so far, sz =
// 1 << lsz bits at the start of the store level's row st[m], becomes
// [left[σ(m)] ^ cur, cur] in place.  Pointers as for fg_pass; a lane past
// the entries reads a repeated one and stores nothing.
template <int M, typename SigT>
__device__ __forceinline__ void chain_pass(uint8_t* st, int ststride, const uint8_t* left,
                                           int lstride, SigT bsig, int lsz, int lane) {
  const int sz = 1 << lsz;
  const int total = M * sz;
  for (int t = total < 32 ? lane & (total - 1) : lane; t < total; t += 32) {
    const int m = t >> lsz;
    const int e = t & (sz - 1);
    const uint8_t x = left[sigma_row(bsig, m) * lstride + e];
    uint8_t* cur = st + m * ststride + e;
    const uint8_t c = cur[0];
    if (lane < total) {
      cur[sz] = c;
      cur[0] = x ^ c;
    }
    if (total < 32) break;
  }
}

template <int M>
__global__ void __launch_bounds__(32 * MAX_FRAMES_PER_BLOCK, 8) scl_decode_kernel(
    const float* __restrict__ llr,        // [B, N]
    const int8_t* __restrict__ forced,    // [B, K] or null
    const uint32_t* __restrict__ hcols,   // [K] CRC check-matrix columns
    const int* __restrict__ sched,        // [N] phase words (scl_schedule.phase_words)
    float* glob_llr,                      // [B, M, N-(N>>G)], null when G == 0
    uint8_t* glob_bits,                   // [B, M, N-(N>>G)], null when G == 0
    float* trace_llr,                     // [B, K, M]
    int8_t* __restrict__ out_bits,        // [B, K]
    float* __restrict__ out_llrs,         // [B, K]
    uint8_t* __restrict__ out_pass,       // [B]
    int B, int N, int n, int K, int G, int use_crc, int frame_bytes,
    int frames_per_block) {
  using SigT = typename Sigma<M>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long frame = (long long)blockIdx.x * frames_per_block + warp;
  if (frame >= B) return;  // whole warp leaves; the kernel has no block barrier

  const int SS = (N >> G) - 1;  // entries of a path's row in shared memory
  const int SG = N - (N >> G);  // entries of a path's row in global memory
  unsigned char* base = smem + (size_t)warp * frame_bytes;
  float* Ls = reinterpret_cast<float*>(base);
  uint8_t* Bs = reinterpret_cast<uint8_t*>(Ls + M * SS);
  uint8_t* TI = Bs + M * SS;
  float* Lg = glob_llr + frame * M * SG;  // unused when G == 0
  uint8_t* Bg = glob_bits + frame * M * SG;
  float* TL = trace_llr + frame * K * M;
  const float* ch = llr + frame * N;
  const int8_t* plan = forced ? forced + frame * K : nullptr;
  // offset of level l (1..n) in a path's row: levels G+1..n in shared
  // memory, levels 1..G in global memory
  auto so = [&](int l) { return (N >> G) - (N >> (l - 1)); };
  auto go = [&](int l) { return N - (N >> (l - 1)); };

  SigT sig = Sigma<M>::kIdentity;   // lane r < 2n−1: σ of row r
  float pm = (lane == 0) ? 0.f : SCL_BIG;  // lane m < M: metric of path m
  uint32_t syn = 0;                 // lane m < M: CRC syndrome of path m
  int info_i = 0;
  int word = sched[0];
  for (int p = 0; p < N; ++p) {
    // the phase's schedule word, and what its decision reads from global
    // memory, are loaded a phase (a descent) ahead of their use
    const int next_word = p + 1 < N ? sched[p + 1] : 0;
    const int gl = word & 31;
    const int is_frozen = word >> 10 & 1;
    int fb = -1;
    uint32_t hc = 0;
    if (!is_frozen) {
      if (plan) fb = plan[info_i];
      if (use_crc) hc = hcols[info_i];
    }

    // ---- f/g updates down to level n−1 ----
    const int l0 = p == 0 ? 1 : gl;
    for (int l = l0; l < n; ++l) {
      const bool is_g = (p != 0) && (l == gl);
      SigT psig = Sigma<M>::kIdentity;
      if (M > 1 && is_g && l > 1 && (word >> 11 & 1)) psig = __shfl_sync(FULL_MASK, sig, l - 2);
      if (l > G + 1) {
        fg_pass<M>(Ls + so(l), Bs + so(l), SS, Ls + so(l - 1), SS, psig, is_g, n - l, lane);
      } else {  // the few passes that touch global memory: generic pointers
        const bool sh = l > G;
        fg_pass<M>(sh ? Ls + so(l) : Lg + go(l), sh ? Bs + so(l) : Bg + go(l), sh ? SS : SG,
                   l > 1 ? Lg + go(l - 1) : ch, l > 1 ? SG : 0, psig, is_g, n - l, lane);
      }
      __syncwarp();
    }
    if (M > 1 && lane >= l0 - 1 && lane <= n - 2) sig = Sigma<M>::kIdentity;
    // the leaf (level n): lane m computes it from its parent row, level
    // n−1, and keeps it in a register; only its own phase reads it
    const bool g_leaf = gl == n;  // a g at the leaf (odd phases)
    SigT lsig = Sigma<M>::kIdentity;
    if (M > 1 && g_leaf && n > 1 && (word >> 11 & 1)) lsig = __shfl_sync(FULL_MASK, sig, n - 2);
    float leaf = 0.f;
    if (lane < M) {
      const int r = sigma_row(lsig, lane);
      const float* row = n == 1 ? ch : n - 1 > G ? Ls + so(n - 1) + r * SS : Lg + go(n - 1) + r * SG;
      leaf = g_leaf ? g_update(row[0], row[1], Bs[lane * SS + so(n)]) : f_minsum(row[0], row[1]);
    }

    // ---- leaf decision: extend every path, or fork and keep the best M ----
    int bit = 0;  // lane m < M: the new bit of path m
    if (is_frozen) {
      if (lane < M) pm = pm + softplus(-leaf);
    } else {
      const int cb = lane & 1;
      const int cp = (lane >> 1) & (M - 1);
      const float lp = __shfl_sync(FULL_MASK, leaf, cp);
      const float pp = __shfl_sync(FULL_MASK, pm, cp);
      float c = pp + softplus(cb ? lp : -lp);
      if (fb != -1 && fb != cb) c = SCL_BIG;
      int rank = 0;
#pragma unroll
      for (int j = 0; j < 2 * M; ++j) {
        const float cj = __shfl_sync(FULL_MASK, c, j);
        rank += (cj < c) || (cj == c && j < lane);
      }
      // the candidate ranked m goes to trace slot m: the survivors' creation
      // indices 2p+b, in order
      uint8_t* row = TI + info_i * M;
      if (lane < 2 * M && rank < M) row[rank] = (uint8_t)lane;
      __syncwarp();
      const int w = lane < M ? row[lane] : 0;
      const float new_pm = __shfl_sync(FULL_MASK, c, w);
      const int parent = w >> 1;
      const float leaf_par = __shfl_sync(FULL_MASK, leaf, parent);
      const uint32_t syn_par = __shfl_sync(FULL_MASK, syn, parent);
      if (lane < M) {
        pm = new_pm;
        bit = w & 1;
        TL[info_i * M + lane] = leaf_par;
        syn = bit ? syn_par ^ hc : syn_par;
      }
      if (M > 1) {  // σ ← σ[parent] on every level
        const int lo_lanes = M < 4 ? M : 4;
        const unsigned sel_lo = __reduce_or_sync(
            FULL_MASK, lane < lo_lanes ? (unsigned)parent << (4 * lane) : 0u);
        const unsigned sel_hi = M > 4 ? __reduce_or_sync(
            FULL_MASK, (lane >= 4 && lane < M) ? (unsigned)parent << (4 * (lane - 4)) : 0u) : 0u;
        sig = Sigma<M>::fork(sig, sel_lo, sel_hi);
      }
      ++info_i;
    }

    // ---- partial-sum chain: cur = [left ^ cur, cur] up to the store level,
    // built in place inside the store level's row ----
    const int s = word >> 5 & 31;
    if (s > 0) {
      // lane m takes the first step: at an even phase (s = n) the chain is
      // the bit; at an odd one [left ^ bit, bit], left the level-n bit
      const int cmask = word >> 11;  // bit l: level l's left bits through σ
      SigT nsig = Sigma<M>::kIdentity;
      if (M > 1 && s < n && (cmask >> n & 1)) nsig = __shfl_sync(FULL_MASK, sig, 2 * n - 2);
      if (lane < M) {
        uint8_t* cur = s > G ? Bs + lane * SS + so(s) : Bg + lane * SG + go(s);
        if (s == n) {
          cur[0] = (uint8_t)bit;
        } else {
          const uint8_t left = Bs[sigma_row(nsig, lane) * SS + so(n)];
          cur[1] = (uint8_t)bit;
          cur[0] = (uint8_t)(left ^ bit);
        }
      }
      __syncwarp();
      for (int lv = n - 1; lv > s; --lv) {
        SigT bsig = Sigma<M>::kIdentity;
        if (M > 1 && (cmask >> lv & 1)) bsig = __shfl_sync(FULL_MASK, sig, n + lv - 2);
        if (s > G)
          chain_pass<M>(Bs + so(s), SS, Bs + so(lv), SS, bsig, n - lv, lane);
        else
          chain_pass<M>(Bg + go(s), SG, lv > G ? Bs + so(lv) : Bg + go(lv), lv > G ? SS : SG,
                        bsig, n - lv, lane);
        __syncwarp();
      }
      if (M > 1 && lane == n + s - 2) sig = Sigma<M>::kIdentity;
    }
    word = next_word;
  }

  // ---- final stable sort of the list, CRC selection, backtrack ----
  int frank = 0;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float pj = __shfl_sync(FULL_MASK, pm, j);
    frank += (pj < pm) || (pj == pm && j < lane);
  }
  const bool ok = use_crc && lane < M && syn == 0u && pm < SCL_BIG;
  const unsigned ok_ranks = __reduce_or_sync(FULL_MASK, ok ? (1u << frank) : 0u);
  const int sel_rank = ok_ranks ? __ffs(ok_ranks) - 1 : 0;
  const unsigned who = __ballot_sync(FULL_MASK, lane < M && frank == sel_rank);
  if (lane == 0) {
    // record (slot << 1 | bit) of the selected path in slot 0 of each trace
    // row; row i is read before it is overwritten, and later steps read
    // rows below i only
    int slot = __ffs(who) - 1;
    for (int i = K - 1; i >= 0; --i) {
      const int w = TI[i * M + slot];
      TI[i * M] = (uint8_t)((slot << 1) | (w & 1));
      slot = w >> 1;
    }
    out_pass[frame] = ok_ranks ? 1 : 0;
  }
  __syncwarp();
  for (int i = lane; i < K; i += 32) {
    const int r = TI[i * M];
    out_bits[frame * K + i] = (int8_t)(r & 1);
    out_llrs[frame * K + i] = TL[i * M + (r >> 1)];
  }
}

template <int M>
cudaError_t set_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(scl_decode_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int M>
int launch(const float* llr, const int8_t* forced, const uint32_t* hcols, const int* sched,
           float* glob_llr, uint8_t* glob_bits, float* trace_llr, int8_t* out_bits,
           float* out_llrs, uint8_t* out_pass, int B, int N, int n, int K, int G, int use_crc,
           int frame_bytes, int frames_per_block, cudaStream_t stream) {
  const size_t smem = (size_t)frame_bytes * frames_per_block;
  cudaError_t err = set_smem<M>(smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + frames_per_block - 1) / frames_per_block;
  scl_decode_kernel<M><<<blocks, 32 * frames_per_block, smem, stream>>>(
      llr, forced, hcols, sched, glob_llr, glob_bits, trace_llr, out_bits, out_llrs, out_pass,
      B, N, n, K, G, use_crc, frame_bytes, frames_per_block);
  return (int)cudaGetLastError();
}

// The frames a block (1..MAX_FRAMES_PER_BLOCK) that let an SM hold the most
// frames at once, by the occupancy calculator (shared memory, registers and
// warps all counted); ties go to more frames a block.
template <int M>
int plan(int frame_bytes, int max_block_smem, int* frames_per_block, int* frames_per_sm) {
  *frames_per_block = 1;
  *frames_per_sm = 0;
  for (int fpb = 1; fpb <= MAX_FRAMES_PER_BLOCK; ++fpb) {
    const size_t smem = (size_t)frame_bytes * fpb;
    if (smem > (size_t)max_block_smem) break;
    cudaError_t err = set_smem<M>(smem);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, scl_decode_kernel<M>, 32 * fpb,
                                                        smem);
    if (err != cudaSuccess) return (int)err;
    if (blocks * fpb >= *frames_per_sm) {
      *frames_per_block = fpb;
      *frames_per_sm = blocks * fpb;
    }
  }
  return 0;
}

}  // namespace

extern "C" int scl_decode_launch(const void* llr, const void* forced, const void* hcols,
                                 const void* sched, void* glob_llr, void* glob_bits,
                                 void* trace_llr, void* out_bits, void* out_llrs, void* out_pass,
                                 int B, int N, int n, int K, int M, int G, int use_crc,
                                 int frame_bytes, int frames_per_block, void* stream) {
  auto* l = static_cast<const float*>(llr);
  auto* f = static_cast<const int8_t*>(forced);
  auto* h = static_cast<const uint32_t*>(hcols);
  auto* s = static_cast<const int*>(sched);
  auto* gl = static_cast<float*>(glob_llr);
  auto* gb = static_cast<uint8_t*>(glob_bits);
  auto* tl = static_cast<float*>(trace_llr);
  auto* ob = static_cast<int8_t*>(out_bits);
  auto* ol = static_cast<float*>(out_llrs);
  auto* op = static_cast<uint8_t*>(out_pass);
  auto st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: return launch<1>(l, f, h, s, gl, gb, tl, ob, ol, op, B, N, n, K, G, use_crc, frame_bytes, frames_per_block, st);
    case 2: return launch<2>(l, f, h, s, gl, gb, tl, ob, ol, op, B, N, n, K, G, use_crc, frame_bytes, frames_per_block, st);
    case 4: return launch<4>(l, f, h, s, gl, gb, tl, ob, ol, op, B, N, n, K, G, use_crc, frame_bytes, frames_per_block, st);
    case 8: return launch<8>(l, f, h, s, gl, gb, tl, ob, ol, op, B, N, n, K, G, use_crc, frame_bytes, frames_per_block, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int scl_launch_plan(int M, int frame_bytes, int max_block_smem,
                               int* frames_per_block, int* frames_per_sm) {
  switch (M) {
    case 1: return plan<1>(frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
    case 2: return plan<2>(frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
    case 4: return plan<4>(frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
    case 8: return plan<8>(frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* scl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
