// Fused CRC-aided SCL list decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `polar_code_tpu/ops/scl_pallas.py` `_kernel_body`
// (built by `_build_kernel_for`, called by `decode_scl_pallas`).  It computes
// what `polar_code_tpu_torch/ops/scl.py` `decode_scl_batch` computes and
// returns its fast-path subset: the CRC-selected path's bits and info-phase
// LLRs, and the CRC pass flag.
//
// Design: one warp decodes one frame; a block holds a few frames.  Per-frame
// state lives in dynamic shared memory:
//   L   float [M][N-1]  LLR rows, one active node per tree level
//   TL  float [K][M]    leaf LLR of each survivor's parent at each info phase
//   Bt  u8    [M][N-1]  partial-sum rows
//   TI  u8    [K][M]    creation index 2p+b of each survivor at each info phase
// Lanes split each level's M·(N>>l) f/g entries.  At an info phase lane i <
// 2M holds candidate i = 2p+b; its rank in (metric, index) order is counted
// with shuffles, which is the stable sort of the plain version, and ranks
// < M survive.  Survivors are cloned in place, one column at a time, only on
// the levels the static schedule says are still live.  Path histories are
// not cloned: the (creation index, leaf LLR) trace is walked back at the end.
// CRC check columns are 32-bit words, so a candidate's syndrome is the XOR of
// the words of its set bits.
//
// What bounds it on this card: neither bytes (an input row of N floats and
// an output row of K bytes + K floats per frame) nor arithmetic peak, but
// the serial phase chain — N phases, each a few dependent shared-memory
// passes separated by warp barriers — so latency per frame, hidden by
// running many frames (warps) per SM.
//
// The arithmetic is the plain version's, op for op, so results are equal bit
// for bit: f = sign(a)·sign(b)·min(|a|,|b|), g = b + (1−2c)·a, penalty
// max(x,0) + log1p(exp(−|x|)) with the accurate expf/log1pf (build without
// fast math and with -fmad=false).  Unreachable candidates carry 3e38.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCL_BIG 3.0e38f
#define FULL_MASK 0xffffffffu

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

// offset of level l (1..n) inside a path's compact row: N - (N >> (l-1))
__device__ __forceinline__ int level_off(int N, int l) { return N - (N >> (l - 1)); }

template <int M>
__global__ void scl_decode_kernel(
    const float* __restrict__ llr,        // [B, N]
    const int8_t* __restrict__ forced,    // [B, K] or null
    const uint32_t* __restrict__ hcols,   // [K] CRC check-matrix columns
    const int* __restrict__ sched,        // [5, N] (see scl_schedule.kernel_tables)
    int8_t* __restrict__ out_bits,        // [B, K]
    float* __restrict__ out_llrs,         // [B, K]
    uint8_t* __restrict__ out_pass,       // [B]
    int B, int N, int n, int K, int use_crc, int frame_bytes, int frames_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long frame = (long long)blockIdx.x * frames_per_block + warp;
  if (frame >= B) return;  // whole warp leaves; the kernel has no block barrier

  const int S = N - 1;
  unsigned char* base = smem + (size_t)warp * frame_bytes;
  float* L = reinterpret_cast<float*>(base);
  float* TL = L + M * S;
  uint8_t* Bt = reinterpret_cast<uint8_t*>(TL + K * M);
  uint8_t* TI = Bt + M * S;

  const int* glevel = sched;
  const int* store_level = sched + N;
  const int* frozen = sched + 2 * N;
  const int* llr_live = sched + 3 * N;
  const int* bit_live = sched + 4 * N;
  const float* ch = llr + frame * N;
  const int8_t* plan = forced ? forced + frame * K : nullptr;

  for (int t = lane; t < M * S; t += 32) {
    L[t] = 0.f;
    Bt[t] = 0;
  }
  __syncwarp();

  float pm = (lane == 0) ? 0.f : SCL_BIG;  // lane m < M: metric of slot m
  int info_i = 0;
  for (int p = 0; p < N; ++p) {
    // ---- f/g updates down to the leaf ----
    const int gl = glevel[p];
    for (int l = (p == 0 ? 1 : gl); l <= n; ++l) {
      const int lh = n - l;  // log2 of the level's width
      const int half = 1 << lh;
      const bool is_g = (p != 0) && (l == gl);
      const int o = level_off(N, l);
      const int po = l > 1 ? level_off(N, l - 1) : 0;
      for (int t = lane; t < M * half; t += 32) {
        const int m = t >> lh;
        const int e = t & (half - 1);
        float a, b;
        if (l == 1) {
          a = ch[e];
          b = ch[e + half];
        } else {
          a = L[m * S + po + e];
          b = L[m * S + po + e + half];
        }
        L[m * S + o + e] = is_g ? g_update(a, b, Bt[m * S + o + e]) : f_minsum(a, b);
      }
      __syncwarp();
    }
    const float leaf = (lane < M) ? L[lane * S + N - 2] : 0.f;

    // ---- leaf decision: extend every path, or fork and keep the best M ----
    int bit = 0;  // lane m < M: the new bit of slot m
    if (frozen[p]) {
      if (lane < M) pm = pm + softplus(-leaf);
    } else {
      const int cb = lane & 1;
      const int cp = (lane >> 1) & (M - 1);
      const float lp = __shfl_sync(FULL_MASK, leaf, cp);
      const float pp = __shfl_sync(FULL_MASK, pm, cp);
      float c = pp + softplus(cb ? lp : -lp);
      if (plan) {
        const int fb = plan[info_i];
        if (fb != -1 && fb != cb) c = SCL_BIG;
      }
      int rank = 0;
#pragma unroll
      for (int j = 0; j < 2 * M; ++j) {
        const float cj = __shfl_sync(FULL_MASK, c, j);
        rank += (cj < c) || (cj == c && j < lane);
      }
      int w = 0;  // lane m < M: the candidate ranked m
#pragma unroll
      for (int j = 0; j < 2 * M; ++j) {
        if (__shfl_sync(FULL_MASK, rank, j) == lane) w = j;
      }
      const float new_pm = __shfl_sync(FULL_MASK, c, w);
      const int parent = w >> 1;
      const float leaf_par = __shfl_sync(FULL_MASK, leaf, parent & (M - 1));
      if (lane < M) {
        pm = new_pm;
        bit = w & 1;
        TI[info_i * M + lane] = (uint8_t)w;
        TL[info_i * M + lane] = leaf_par;
      }
      int par[M];
#pragma unroll
      for (int m = 0; m < M; ++m) par[m] = __shfl_sync(FULL_MASK, parent, m);

      // clone survivors in place on the live levels: each lane owns whole
      // columns, reading all M sources before writing any slot
      if (M > 1) {
        const int lmask = llr_live[p];
        const int bmask = bit_live[p];
        for (int l = 1; l <= n; ++l) {
          const int half = N >> l;
          const int o = level_off(N, l);
          if (lmask & (1 << l)) {
            for (int e = lane; e < half; e += 32) {
              float v[M];
#pragma unroll
              for (int m = 0; m < M; ++m) v[m] = L[par[m] * S + o + e];
#pragma unroll
              for (int m = 0; m < M; ++m) L[m * S + o + e] = v[m];
            }
          }
          if (bmask & (1 << l)) {
            for (int e = lane; e < half; e += 32) {
              uint8_t v[M];
#pragma unroll
              for (int m = 0; m < M; ++m) v[m] = Bt[par[m] * S + o + e];
#pragma unroll
              for (int m = 0; m < M; ++m) Bt[m * S + o + e] = v[m];
            }
          }
        }
      }
      ++info_i;
      __syncwarp();
    }

    // ---- partial-sum chain: cur = [left ^ cur, cur] up to the store level,
    // built in place inside the store level's row ----
    const int s = store_level[p];
    if (s > 0) {
      const int ot = level_off(N, s);
      if (lane < M) Bt[lane * S + ot] = (uint8_t)bit;
      __syncwarp();
      int sz = 1;
      for (int lv = n; lv > s; --lv) {
        const int ol = level_off(N, lv);
        const int lsz = __ffs(sz) - 1;
        for (int t = lane; t < M * sz; t += 32) {
          const int m = t >> lsz;
          const int e = t & (sz - 1);
          const uint8_t c = Bt[m * S + ot + e];
          Bt[m * S + ot + e + sz] = c;
          Bt[m * S + ot + e] = Bt[m * S + ol + e] ^ c;
        }
        __syncwarp();
        sz <<= 1;
      }
    }
  }

  // ---- final stable sort of the list, CRC selection, backtrack ----
  int frank = 0;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float pj = __shfl_sync(FULL_MASK, pm, j);
    frank += (pj < pm) || (pj == pm && j < lane);
  }
  bool ok = false;
  if (use_crc && lane < M) {
    uint32_t syn = 0;
    int slot = lane;
    for (int i = K - 1; i >= 0; --i) {
      const int w = TI[i * M + slot];
      if (w & 1) syn ^= hcols[i];
      slot = w >> 1;
    }
    ok = (syn == 0u) && (pm < SCL_BIG);
  }
  const unsigned ok_ranks = __reduce_or_sync(FULL_MASK, ok ? (1u << frank) : 0u);
  const int sel_rank = ok_ranks ? __ffs(ok_ranks) - 1 : 0;
  const unsigned who = __ballot_sync(FULL_MASK, lane < M && frank == sel_rank);
  if (lane == 0) {
    int slot = __ffs(who) - 1;
    for (int i = K - 1; i >= 0; --i) {
      const int w = TI[i * M + slot];
      out_bits[frame * K + i] = (int8_t)(w & 1);
      out_llrs[frame * K + i] = TL[i * M + slot];
      slot = w >> 1;
    }
    out_pass[frame] = ok_ranks ? 1 : 0;
  }
}

template <int M>
int launch(const float* llr, const int8_t* forced, const uint32_t* hcols, const int* sched,
           int8_t* out_bits, float* out_llrs, uint8_t* out_pass, int B, int N, int n, int K,
           int use_crc, int frame_bytes, int frames_per_block, cudaStream_t stream) {
  const size_t smem = (size_t)frame_bytes * frames_per_block;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scl_decode_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + frames_per_block - 1) / frames_per_block;
  scl_decode_kernel<M><<<blocks, 32 * frames_per_block, smem, stream>>>(
      llr, forced, hcols, sched, out_bits, out_llrs, out_pass, B, N, n, K, use_crc,
      frame_bytes, frames_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int scl_decode_launch(const void* llr, const void* forced, const void* hcols,
                                 const void* sched, void* out_bits, void* out_llrs,
                                 void* out_pass, int B, int N, int n, int K, int M,
                                 int use_crc, int frame_bytes, int frames_per_block,
                                 void* stream) {
  auto* l = static_cast<const float*>(llr);
  auto* f = static_cast<const int8_t*>(forced);
  auto* h = static_cast<const uint32_t*>(hcols);
  auto* s = static_cast<const int*>(sched);
  auto* ob = static_cast<int8_t*>(out_bits);
  auto* ol = static_cast<float*>(out_llrs);
  auto* op = static_cast<uint8_t*>(out_pass);
  auto st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: return launch<1>(l, f, h, s, ob, ol, op, B, N, n, K, use_crc, frame_bytes, frames_per_block, st);
    case 2: return launch<2>(l, f, h, s, ob, ol, op, B, N, n, K, use_crc, frame_bytes, frames_per_block, st);
    case 4: return launch<4>(l, f, h, s, ob, ol, op, B, N, n, K, use_crc, frame_bytes, frames_per_block, st);
    case 8: return launch<8>(l, f, h, s, ob, ol, op, B, N, n, K, use_crc, frame_bytes, frames_per_block, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* scl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
