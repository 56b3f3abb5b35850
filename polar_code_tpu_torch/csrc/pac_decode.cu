// Fused PAC list decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `polar_code_tpu/legacy/pac_pallas.py` `_kernel_body`
// (built by `_build`, called by `pac_list_decode_pallas`).  It computes what
// `polar_code_tpu_torch/legacy/pac.py` `pac_list_decode_batch` computes and
// returns its fast-path subset: the selected path's bits in ascending-u order
// and the CRC pass flag.
//
// The code: leaves are visited in bit-reversed u-order, which is the halves
// butterfly on the bit-reversal-permuted channel LLRs (level 1 reads
// llr[brev(j)] straight from device memory).  Each path keeps the shift
// register of the convolutional precoder, which supplies the edge bit; the
// partial sums carry edge bits.  The path metric is a hard-decision one: a
// path adds |LLR| when its edge bit disagrees with the leaf's hard decision.
//
// Design: one warp decodes one frame, lane m holds path slot m (L <= 32); a
// block holds a few frames.  Per-frame state lives in dynamic shared memory:
//   Lr  float [L][N-1]  LLR rows, one active node per tree level
//   Bt  u8    [L][N-1]  edge-bit partial-sum rows
//   TI  u8    [Kp][L]   2·parent + v of each survivor at each info phase
// and each path's shift register is a 32-bit mask in its lane's register
// (bit t = state[t], mem = len(gen) - 1 <= 31).  Lanes split each level's
// L·(N>>l) f/g entries.  At an info phase the 2L candidates are laid out as
// [good×L, bad×L]: lane p holds good candidate p (metric pm) and bad candidate
// L + p (pm + |leaf|).  Each candidate's rank in (metric, layout index) order
// is counted with shuffles — the stable sort of the plain version — and ranks
// < L survive.  Survivors are cloned in place, one column at a time, only on
// the levels the static schedule says are still live.  Path histories are
// not cloned: the trace is walked back at the end.  CRC check columns are
// 32-bit words in phase order, so a candidate's syndrome is the XOR of the
// words of its set bits.
//
// What bounds it on this card: neither bytes (N floats in, Kp + 1 bytes out
// per frame) nor arithmetic peak, but the serial phase chain — N phases, each
// a few dependent shared-memory passes separated by warp barriers — so
// latency per frame, hidden by running many frames (warps) per SM.
//
// The arithmetic is the plain version's, op for op, and none of it is
// transcendental, so results are equal bit for bit: f = sign(a)·sign(b)·
// min(|a|,|b|) with sign(0) = 0, g = b + (1−2c)·a, hard = (leaf < 0), and
// single float32 adds to the metric (built with -fmad=false).  Dead paths
// carry 3e38 and stay there, so, as the plain version's inf, they tie with
// each other and are ordered by layout index.

#include <cuda_runtime.h>
#include <stdint.h>

#define PAC_BIG 3.0e38f
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

// offset of level l (1..n) inside a path's compact row: N - (N >> (l-1))
__device__ __forceinline__ int level_off(int N, int l) { return N - (N >> (l - 1)); }

// LM: the list size rounded up to a power of two; it sizes the register
// arrays of the in-place clone, and L <= LM is the list size itself.
template <int LM>
__global__ void pac_decode_kernel(
    const float* __restrict__ llr,        // [B, N] channel LLRs, natural order
    const uint32_t* __restrict__ hcols,   // [Kp] CRC check-matrix columns, phase order
    const int* __restrict__ sched,        // [5, N] (see scl_schedule.kernel_tables)
    const int* __restrict__ out_pos,      // [Kp] ascending-u position of each info phase
    int8_t* __restrict__ out_bits,        // [B, Kp]
    uint8_t* __restrict__ out_pass,       // [B]
    int B, int N, int n, int Kp, int L, unsigned mem_mask, unsigned tap_mask,
    int use_crc, int frame_bytes, int frames_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long frame = (long long)blockIdx.x * frames_per_block + warp;
  if (frame >= B) return;  // whole warp leaves; the kernel has no block barrier

  const int S = N - 1;
  unsigned char* base = smem + (size_t)warp * frame_bytes;
  float* Lr = reinterpret_cast<float*>(base);
  uint8_t* Bt = reinterpret_cast<uint8_t*>(Lr + L * S);
  uint8_t* TI = Bt + L * S;

  const int* glevel = sched;
  const int* store_level = sched + N;
  const int* frozen = sched + 2 * N;
  const int* llr_live = sched + 3 * N;
  const int* bit_live = sched + 4 * N;
  const float* ch = llr + frame * N;
  const int rev_shift = 32 - n;  // __brev(j) >> rev_shift reverses j's n bits

  for (int t = lane; t < L * S; t += 32) {
    Lr[t] = 0.f;
    Bt[t] = 0;
  }
  __syncwarp();

  float pm = (lane == 0) ? 0.f : PAC_BIG;  // lane m < L: metric of slot m
  unsigned reg = 0;                         // lane m < L: shift register of slot m
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
      for (int t = lane; t < L * half; t += 32) {
        const int m = t >> lh;
        const int e = t & (half - 1);
        float a, b;
        if (l == 1) {
          a = ch[__brev(e) >> rev_shift];
          b = ch[__brev(e + half) >> rev_shift];
        } else {
          a = Lr[m * S + po + e];
          b = Lr[m * S + po + e + half];
        }
        Lr[m * S + o + e] = is_g ? g_update(a, b, Bt[m * S + o + e]) : f_minsum(a, b);
      }
      __syncwarp();
    }
    const float leaf = (lane < L) ? Lr[lane * S + N - 2] : 0.f;
    const int hard = leaf < 0.f;
    const int base_bit = __popc(reg & tap_mask) & 1;  // edge bit for v = 0

    // ---- leaf decision: extend every path, or fork and keep the best L ----
    int edge = 0;  // lane m < L: the edge bit the partial sums of slot m take
    if (frozen[p]) {
      if (lane < L) {
        if (pm < PAC_BIG && base_bit != hard) pm = pm + fabsf(leaf);
        reg = (reg << 1) & mem_mask;
        edge = base_bit;
      }
    } else {
      const float cg = pm;                                            // index lane
      const float cb = (pm < PAC_BIG) ? pm + fabsf(leaf) : PAC_BIG;   // index L + lane
      int rank_g = 0, rank_b = 0;
      for (int j = 0; j < L; ++j) {
        const float gj = __shfl_sync(FULL_MASK, cg, j);
        const float bj = __shfl_sync(FULL_MASK, cb, j);
        rank_g += (gj < cg) || (gj == cg && j < lane);
        rank_g += bj < cg;   // index L + j follows every good index
        rank_b += gj <= cb;  // index j precedes every bad index
        rank_b += (bj < cb) || (bj == cb && j < lane);
      }
      int w = 0;  // lane m < L: the layout index of the candidate ranked m
      for (int j = 0; j < L; ++j) {
        if (__shfl_sync(FULL_MASK, rank_g, j) == lane) w = j;
        if (__shfl_sync(FULL_MASK, rank_b, j) == lane) w = L + j;
      }
      const int is_bad = w >= L;
      const int parent = is_bad ? w - L : w;
      const float pg = __shfl_sync(FULL_MASK, cg, parent);
      const float pb = __shfl_sync(FULL_MASK, cb, parent);
      const int hp = __shfl_sync(FULL_MASK, hard, parent);
      const int bp = __shfl_sync(FULL_MASK, base_bit, parent);
      const unsigned rp = __shfl_sync(FULL_MASK, reg, parent);
      if (lane < L) {
        const int v = bp ^ hp ^ is_bad;  // good: edge == hard; bad: the other bit
        pm = is_bad ? pb : pg;
        edge = hp ^ is_bad;
        reg = ((rp << 1) | (unsigned)v) & mem_mask;
        TI[info_i * L + lane] = (uint8_t)((parent << 1) | v);
      }

      // clone survivors in place on the live levels: each lane owns whole
      // columns, reading all L sources before writing any slot
      if (L > 1) {
        int par[LM];
#pragma unroll
        for (int m = 0; m < LM; ++m) par[m] = __shfl_sync(FULL_MASK, parent, m);
        const int lmask = llr_live[p];
        const int bmask = bit_live[p];
        for (int l = 1; l <= n; ++l) {
          const int half = N >> l;
          const int o = level_off(N, l);
          if (lmask & (1 << l)) {
            for (int e = lane; e < half; e += 32) {
              float v[LM];
#pragma unroll
              for (int m = 0; m < LM; ++m)
                if (m < L) v[m] = Lr[par[m] * S + o + e];
#pragma unroll
              for (int m = 0; m < LM; ++m)
                if (m < L) Lr[m * S + o + e] = v[m];
            }
          }
          if (bmask & (1 << l)) {
            for (int e = lane; e < half; e += 32) {
              uint8_t v[LM];
#pragma unroll
              for (int m = 0; m < LM; ++m)
                if (m < L) v[m] = Bt[par[m] * S + o + e];
#pragma unroll
              for (int m = 0; m < LM; ++m)
                if (m < L) Bt[m * S + o + e] = v[m];
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
      if (lane < L) Bt[lane * S + ot] = (uint8_t)edge;
      __syncwarp();
      int sz = 1;
      for (int lv = n; lv > s; --lv) {
        const int ol = level_off(N, lv);
        const int lsz = __ffs(sz) - 1;
        for (int t = lane; t < L * sz; t += 32) {
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
  for (int j = 0; j < L; ++j) {
    const float pj = __shfl_sync(FULL_MASK, pm, j);
    frank += (pj < pm) || (pj == pm && j < lane);
  }
  bool ok = false;
  if (use_crc && lane < L) {
    uint32_t syn = 0;
    int slot = lane;
    for (int i = Kp - 1; i >= 0; --i) {
      const int w = TI[i * L + slot];
      if (w & 1) syn ^= hcols[i];
      slot = w >> 1;
    }
    ok = (syn == 0u) && (pm < PAC_BIG);
  }
  const unsigned ok_ranks = __reduce_or_sync(FULL_MASK, ok ? (1u << frank) : 0u);
  const int sel_rank = ok_ranks ? __ffs(ok_ranks) - 1 : 0;
  const unsigned who = __ballot_sync(FULL_MASK, lane < L && frank == sel_rank);
  if (lane == 0) {
    int slot = __ffs(who) - 1;
    for (int i = Kp - 1; i >= 0; --i) {
      const int w = TI[i * L + slot];
      out_bits[frame * Kp + out_pos[i]] = (int8_t)(w & 1);
      slot = w >> 1;
    }
    out_pass[frame] = ok_ranks ? 1 : 0;
  }
}

template <int LM>
int launch(const float* llr, const uint32_t* hcols, const int* sched, const int* out_pos,
           int8_t* out_bits, uint8_t* out_pass, int B, int N, int n, int Kp, int L,
           unsigned mem_mask, unsigned tap_mask, int use_crc, int frame_bytes,
           int frames_per_block, cudaStream_t stream) {
  const size_t smem = (size_t)frame_bytes * frames_per_block;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pac_decode_kernel<LM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + frames_per_block - 1) / frames_per_block;
  pac_decode_kernel<LM><<<blocks, 32 * frames_per_block, smem, stream>>>(
      llr, hcols, sched, out_pos, out_bits, out_pass, B, N, n, Kp, L, mem_mask, tap_mask,
      use_crc, frame_bytes, frames_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pac_decode_launch(const void* llr, const void* hcols, const void* sched,
                                 const void* out_pos, void* out_bits, void* out_pass, int B,
                                 int N, int n, int Kp, int L, unsigned mem_mask,
                                 unsigned tap_mask, int use_crc, int frame_bytes,
                                 int frames_per_block, void* stream) {
  auto* l = static_cast<const float*>(llr);
  auto* h = static_cast<const uint32_t*>(hcols);
  auto* s = static_cast<const int*>(sched);
  auto* op = static_cast<const int*>(out_pos);
  auto* ob = static_cast<int8_t*>(out_bits);
  auto* pass = static_cast<uint8_t*>(out_pass);
  auto st = static_cast<cudaStream_t>(stream);
#define PAC_LAUNCH(LM)                                                                   \
  return launch<LM>(l, h, s, op, ob, pass, B, N, n, Kp, L, mem_mask, tap_mask, use_crc, \
                    frame_bytes, frames_per_block, st)
  if (L < 1 || L > 32) return (int)cudaErrorInvalidValue;
  if (L == 1) PAC_LAUNCH(1);
  if (L <= 2) PAC_LAUNCH(2);
  if (L <= 4) PAC_LAUNCH(4);
  if (L <= 8) PAC_LAUNCH(8);
  if (L <= 16) PAC_LAUNCH(16);
  PAC_LAUNCH(32);
#undef PAC_LAUNCH
}

extern "C" const char* pac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
