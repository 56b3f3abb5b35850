// Fused PAC list decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `polar_code_tpu/legacy/pac_pallas.py:59`
// `_kernel_body` (built by `_build`, called by `pac_list_decode_pallas`).
// It computes what `polar_code_tpu_torch/legacy/pac.py`
// `pac_list_decode_batch` computes and returns its fast-path subset: the
// selected path's bits in ascending-u order and the CRC pass flag.
//
// The code: leaves are visited in bit-reversed u-order, which is the halves
// butterfly on the bit-reversal-permuted channel LLRs (level 1 reads
// llr[brev(j)] straight from device memory).  Each path keeps the shift
// register of the convolutional precoder, which supplies the edge bit; the
// partial sums carry edge bits.  The path metric is a hard-decision one: a
// path adds |LLR| when its edge bit disagrees with the leaf's hard decision.
//
// What bounds it on this card.  Not bytes (N floats in, Kp + 1 bytes out a
// frame) and not the arithmetic peak, but the serial phase chain: N phases,
// each a few dependent passes over shared memory separated by warp
// barriers, and at info phases the rank of 2L candidates.  So the time is a
// frame's latency, hidden by keeping many frames (warps) on each SM.
//
// What held the first design back.  It cloned the survivors in place at
// every info phase, column by column, on every level the static schedule
// still read: at PAC(128,64)+CRC-16 L=8 that clone moved 86,480 entries a
// frame against 7,168 f/g entries, and 18.1 M against 327,680 at N=1024
// L=32.  Each lane walked its path's whole trace for its CRC syndrome, and
// lane 0 walked the trace again and wrote the Kp output bytes alone.  And a
// frame's state, 5·L·(N−1) + Kp·L bytes, held an SM to one frame at N=1024
// L=32.
//
// The lazy clone (the TPU kernel's default, `pac_pallas.py:23-28`; the SCL
// kernel's, `scl_decode.cu`).  Path m always writes its own physical row m.
// Each tree level has a path-origin map σ: σ_l[m] is the row that holds
// path m's data for level l.  A level write resets its σ to identity; at a
// fork survivor m takes its parent's maps, σ ← σ[parent].  Only two reads
// can cross a fork, and only they read through σ, where the static schedule
// says a fork did happen since the level's last write
// (`scl_schedule.schedule_tables`):
//   * the g update's parent-LLR read at level gl−1 (`gpar_need[p]`);
//   * the partial-sum chain's left-bit reads at levels n..s+1
//     (`comb_need[p]`).
// Every other read is of the path's own row: an f reads the level the same
// phase just wrote, and the g's left-bit read was stored by the previous
// phase's chain with no fork between.  No write lands on a row that a σ
// still points at: every path writes the same levels in the same phase, so
// when level l is written, all L rows of level l are rewritten together, its
// σ becomes identity for every path, and the reads of that step are of other
// levels (the g's level gl−1, the chain's levels above s).  No row is copied
// at a fork.
//
// σ lives in registers, by path: lane m holds path m's origin row at every
// level, one field of b = log2(LM) bits a level (LM the list size rounded
// up to a power of two), 32/b fields a word: fields 0..n−2 for LLR levels
// 1..n−1 (level n is read only at its own leaf), fields n−1..2n−3 for bit
// levels 2..n (level 1's bits are read only by the g of phase N/2, its own
// row).  A fork is one shuffle a word from lane parent[m] (up to four words
// at L=32); a read through σ is one field extract in lane m and one shuffle
// from lane m to the lanes that handle path m's entries.  The SCL kernel
// keeps this layout too, for its list sizes outside {1, 2, 4, 8}; its
// byte-word layout by level, one word of M bytes a level, serves M ≤ 8 only:
// at L=32 a level's map is 160 bits, and a fork would permute 32 fields in
// every word, where here it moves whole words.  `legacy/pac_cuda.py::SIGMA_FIELDS` bounds n by the
// fields the words hold: past n = 13 (N 16384..65536) LM 16 and 32 run the
// wide twins pac_decode_wide_kernel<LM>, one more word a lane.  A phase's resets — the LLR levels its descent
// writes and the bit level the previous phase's chain stored — are applied
// together at the phase's start, one bitwise select a word with masks the
// host builds for (n, LM): no read through σ falls between those writes and
// that point.  At L=1 there is no σ, and the rank needs no count: the good
// candidate always ranks first.
//
// Over warps, the instantiations pac_deep_kernel<T> (L 33..1024, a runtime
// argument; the SCL kernel's scl_deep_kernel, with the machinery shared in
// `list_decode.cuh`): one frame a block of L rounded up to a power of two
// threads, thread m slot m.  σ is a table in shared memory, a row of 2n−2
// fields a slot; a fork copies the parent's row between two block barriers.
// At an info phase each slot publishes its leaf, syndrome and shift
// register, and the block sorts the 2L candidates as 64-bit keys (the
// metric's order-preserving word above the layout index, p for good p and
// L + p for bad p) with the SCL kernel's bitonic network
// (`block_sort_keys`); slot m takes the key of rank m: its metric, and its
// parent's values (the edge bits from the parent's leaf and register), and
// writes 2·parent + v into its trace slot.  The selected rank is a
// min-reduction.  T, the width of a trace entry and a σ field, is a byte up
// to L = 128 and 16 bits above; the trace lives in global scratch, and
// shared memory holds tree levels.  Past n = 13 a 16-bit σ row outgrows the
// fork's 12 registers, and pac_deep_wide_kernel copies it in two halves.
//
// On a cluster, the instantiations pac_cluster_kernel<LIST> (L 1025..8192):
// the SCL kernel's cluster layout (`scl_decode.cu`, `list_decode.cuh`), a
// frame over a thread-block cluster of 2, 4 or 8 blocks of 1024 threads,
// levels G+1..n of a block's slots in its shared memory and levels 1..G in
// global scratch, with three published words a slot.
//
// Each path carries its CRC syndrome (the XOR of the 32-bit check columns,
// in phase order, of its set bits) and its shift register in registers,
// both gathered with the metric at a fork, so the selection needs no walk.
// The selected path's trace is walked back once by one lane into a slot of
// each trace row, and all lanes then write the output bytes in ascending-u
// order.
//
// The full list (`pac_list_decode_cuda(..., full=True)`, which the
// systematic scalar decoder reads): the instantiation with LIST set also
// writes every path of the final list, in the plain version's final stable
// (metric, slot) order — its message bits by u index (`v_full`, zero at
// frozen positions), its info bits in ascending-u order, its metric (+inf
// for a dead path) — and the selected rank.  Lane m < L walks its own
// path's trace back, reading TI only, before lane 0 rewrites slot 0 of the
// trace rows for the selected path.  The legacy drivers launch the
// instantiation without LIST, whose code is unchanged.
//
// Layout.  One warp decodes one frame, lane m holds path slot m (L <= 32);
// a block holds a few frames (over warps, one block a frame).  Levels G+1..n of each path live in dynamic
// shared memory; levels 1..G (the widest, read at a handful of phases) and
// the trace live in a global scratch the wrapper allocates.  The wrapper
// picks G with the occupancy calculator (`ops/scl_cuda.py::
// smallest_global_levels`).  Per frame in shared memory:
//   Ls float [L][(N>>G)-1]  LLR rows, one active node per level G+1..n−1
//                           (and an unused entry for level n)
//   Bs u8    [L][(N>>G)-1]  edge-bit partial-sum rows, levels G+1..n
//   ring u8  [16][16|32]    the last (up to) 16 trace rows, from a 16-byte
//                           boundary past Bs (L > 1)
// and in global memory, per frame:
//   Lg float [L][N-(N>>G)]  LLR rows, levels 1..G
//   Bg u8    [L][N-(N>>G)]  partial-sum rows, levels 1..G
//   TI u8    [Kp][16|32]    2·parent + v of each survivor at each info
//                           phase, rows of L bytes padded to round16(L)
// At L=1 the decisions are the path: lane 0 writes them to the outputs as it
// takes them, with no trace, ring or walk back.  Above, the trace is
// written once an info phase, one byte a lane, into the ring
// in shared memory; each 16th info phase (and the last) the warp copies the
// ring's rows to TI as 16-byte words.  A byte store a lane to global memory
// at each info phase cost more (7% at PAC(64,32) L=8 B=65536).  TI is read
// only at the end: there the frame's shared memory, free of tree levels,
// takes a chunk of rows at a time as 16-byte words, and the walks back run
// in it, as in the SCL kernel's by-path instantiation.  In shared memory the
// whole trace was Kp·L bytes, and at N=8192 L=32 it refused Kp > 7259.
// A phase's schedule is one word (`scl_schedule.phase_words`), loaded a
// phase ahead.  Lanes split each level's L·(N>>l) f/g entries down to level
// n−1; lane m computes path m's leaf from its level-n−1 row and keeps it in
// a register, and takes the partial-sum chain's first step the same way.
// At an info phase the 2L candidates are laid out as [good×L, bad×L]: lane p
// holds good candidate p (metric pm) and bad candidate L + p (pm + |leaf|).
// Each candidate's rank in (metric, layout index) order is counted with
// shuffles — the stable sort of the plain version — and ranks < L survive
// (over warps, a sort of the candidates' keys in that order).
//
// The arithmetic is the plain version's, op for op, and none of it is
// transcendental, so results are equal bit for bit: f = sign(a)·sign(b)·
// min(|a|,|b|) with sign(0) = 0, g = b + (1−2c)·a, hard = (leaf < 0), and
// single float32 adds to the metric (built with -fmad=false, no fast math).
// Dead paths carry 3e38 and stay there, so, as the plain version's inf, they
// tie with each other and are ordered by layout index.

#include <cuda_runtime.h>
#include <stdint.h>

#include "list_decode.cuh"

#define PAC_BIG 3.0e38f
#define MAX_FRAMES_PER_BLOCK 4  // warps a block at most; `plan` picks how many
#define TRACE_RING 16           // trace rows a one-lane frame stages in shared memory (a power of two)

namespace {

// Level 1 from the channel: the halves butterfly on the bit-reversal-
// permuted LLRs, read as ch[brev(j)] (`rev_shift` = 32 − n), over `nt`
// threads (a warp, or a block over warps).
__device__ __forceinline__ void channel_pass(float* dst, const uint8_t* dbits, int dstride,
                                             const float* ch, int rev_shift, bool is_g, int lh,
                                             int L, int lane, int nt = 32) {
  const int half = 1 << lh;
  const int total = L * half;
  for (int t = lane; t < total; t += nt) {
    const int m = t >> lh;
    const int e = t & (half - 1);
    const float a = ch[__brev(e) >> rev_shift], b = ch[__brev(e + half) >> rev_shift];
    const int o = m * dstride + e;
    dst[o] = is_g ? g_update(a, b, dbits[o]) : f_minsum(a, b);
  }
}

// LM: the list size rounded up to a power of two; it sizes σ, and L <= LM
// is the list size itself.  LM=2 alone asks for 7 blocks an SM: left to
// itself ptxas gives it 126 registers (16 frames an SM) and it ran 13%
// slower at B=65536 than with 70; a bound of 0 is none, and any explicit
// bound on LM >= 4 (even 1) made those slower (PERF.md, §6).  This is the
// body of pac_decode_kernel (σ in PathSigma<LM>'s words: n <= 13 at LM 16
// and 32) and of pac_decode_wide_kernel (WIDE: one more word, n 14..16);
// the kernels' pointer arguments carry the __restrict__ qualifiers.
template <int LM, bool LIST, bool WIDE, typename Masks>
__device__ __forceinline__ void pac_path_decode(
    const float* llr,          // [B, N] channel LLRs, natural order
    const uint32_t* hcols,     // [Kp] CRC check-matrix columns, phase order
    const int* sched,          // [N] phase words (scl_schedule.phase_words)
    float* glob_llr,           // [B, L, N-(N>>G)], null when G == 0
    uint8_t* glob_bits,        // [B, L, N-(N>>G)], null when G == 0
    uint8_t* trace_idx,        // [B, Kp, round16(L)]: the trace, in global scratch
    int8_t* out_bits,          // [B, Kp]
    uint8_t* out_pass,         // [B]
    const int* out_pos,        // [Kp] ascending-u output index of each info phase
    const int* u_pos,          // [Kp] u index of each info phase, LIST only
    int8_t* list_v,            // [B, L, N], LIST only
    int8_t* list_bits,         // [B, L, Kp], LIST only
    float* list_metrics,       // [B, L], LIST only
    int* list_best,            // [B], LIST only
    int B, int N, int n, int Kp, int L, int G, unsigned mem_mask, unsigned tap_mask,
    int use_crc, int frame_bytes, int frames_per_block, const Masks& masks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long frame = (long long)blockIdx.x * frames_per_block + warp;
  if (frame >= B) return;  // whole warp leaves; the kernel has no block barrier

  const int SS = (N >> G) - 1;  // entries of a path's row in shared memory
  const int SG = N - (N >> G);  // entries of a path's row in global memory
  const int TW = round16(L);    // bytes of a trace row
  unsigned char* base = smem + (size_t)warp * frame_bytes;
  float* Ls = reinterpret_cast<float*>(base);
  uint8_t* Bs = reinterpret_cast<uint8_t*>(Ls + L * SS);
  uint8_t* TI = trace_idx + frame * Kp * TW;
  uint8_t* ring = base + round16(5 * L * SS);  // trace row i at (i mod TRACE_RING) · TW
  float* Lg = glob_llr + frame * L * SG;  // unused when G == 0
  uint8_t* Bg = glob_bits + frame * L * SG;
  const float* ch = llr + frame * N;
  const int rev_shift = 32 - n;  // __brev(j) >> rev_shift reverses j's n bits
  // offset of level l (1..n) in a path's row: levels G+1..n in shared
  // memory, levels 1..G in global memory
  auto so = [&](int l) { return (N >> G) - (N >> (l - 1)); };
  auto go = [&](int l) { return N - (N >> (l - 1)); };

  const unsigned sig_id = PathSigma<LM, WIDE>::identity(lane);
  PathSigma<LM, WIDE> sig;  // lane m < L: σ of path m; field l−1: LLR level l, n+l−3: bit level l
  sig.init(sig_id);
  float pm = (lane == 0) ? 0.f : PAC_BIG;  // lane m < L: metric of slot m
  unsigned reg = 0;                         // lane m < L: shift register of slot m
  uint32_t syn = 0;                         // lane m < L: CRC syndrome of slot m
  int info_i = 0;
  if (LIST && LM == 1) {
    // one path: its decisions go straight to row 0 of the list, zeroed first
    for (int t = lane; t < N; t += 32) list_v[frame * N + t] = 0;
    __syncwarp();
  }
  // the ring's first `rows` rows to trace rows info_i − rows .. info_i − 1
  auto flush = [&](int rows) {
    __syncwarp();  // the rows' bytes are in
    const uint4* src = reinterpret_cast<const uint4*>(ring);
    uint4* dst = reinterpret_cast<uint4*>(TI + (info_i - rows) * TW);
    for (int x = lane; x < rows * TW / 16; x += 32) dst[x] = src[x];
    __syncwarp();  // read before the next info phase rewrites row 0
  };
  int word = sched[0];
  int s_prev = 0;  // the previous phase's store level
  for (int p = 0; p < N; ++p) {
    // the phase's schedule word, and the check column its fork reads, are
    // loaded a phase (a descent) ahead of their use
    const int next_word = p + 1 < N ? sched[p + 1] : 0;
    const int gl = word & 31;
    const int is_frozen = word >> 10 & 1;
    const uint32_t hc = (!is_frozen && use_crc) ? hcols[info_i] : 0u;
    const int l0 = p == 0 ? 1 : gl;
    if (LM > 1) {
      // σ back to identity on the levels rewritten since the last fork: the
      // bit level the previous phase's chain stored, and the LLR levels
      // l0..n−1 this phase's descent writes.  Nothing reads their σ between
      // the write and this reset: the descent reads level l0−1 through σ,
      // the leaf level n−1 only at a g leaf (l0 = n), and the chain's reads
      // come after this phase's fork.
      unsigned r[PathSigma<LM, WIDE>::kWords];
#pragma unroll
      for (int k = 0; k < PathSigma<LM, WIDE>::kWords; ++k) r[k] = masks.llr[l0][k] | masks.bit[s_prev][k];
      sig.reset(r, sig_id);
    }

    // ---- f/g updates down to level n−1 ----
    for (int l = l0; l < n; ++l) {
      const bool is_g = (p != 0) && (l == gl);
      const bool via = LM > 1 && is_g && l > 1 && (word >> 11 & 1);
      const int own = via ? sig.get(l - 2) : 0;
      if (l == 1) {
        if (G == 0)
          channel_pass(Ls + so(1), Bs + so(1), SS, ch, rev_shift, is_g, n - 1, L, lane);
        else
          channel_pass(Lg + go(1), Bg + go(1), SG, ch, rev_shift, is_g, n - 1, L, lane);
      } else if (l > G + 1) {
        path_fg_pass(Ls + so(l), Bs + so(l), SS, Ls + so(l - 1), SS, via, own, is_g, n - l, L, lane);
      } else {  // the few passes that touch global memory: generic pointers
        const bool sh = l > G;
        path_fg_pass(sh ? Ls + so(l) : Lg + go(l), sh ? Bs + so(l) : Bg + go(l), sh ? SS : SG,
                Lg + go(l - 1), SG, via, own, is_g, n - l, L, lane);
      }
      __syncwarp();
    }
    // the leaf (level n): lane m computes it from its parent row, level
    // n−1, and keeps it in a register; only its own phase reads it
    const bool g_leaf = gl == n;  // a g at the leaf (odd phases)
    float leaf = 0.f;
    if (lane < L) {
      float a, b;
      if (n == 1) {
        a = ch[0];
        b = ch[1];
      } else {
        const int r = (LM > 1 && g_leaf && (word >> 11 & 1)) ? sig.get(n - 2) : lane;
        const float* row = n - 1 > G ? Ls + so(n - 1) + r * SS : Lg + go(n - 1) + r * SG;
        a = row[0];
        b = row[1];
      }
      leaf = g_leaf ? g_update(a, b, Bs[lane * SS + so(n)]) : f_minsum(a, b);
    }
    const int hard = leaf < 0.f;
    const int base_bit = __popc(reg & tap_mask) & 1;  // edge bit for v = 0

    // ---- leaf decision: extend every path, or fork and keep the best L ----
    int edge = 0;  // lane m < L: the edge bit the partial sums of slot m take
    if (is_frozen) {
      if (lane < L) {
        if (pm < PAC_BIG && base_bit != hard) pm = pm + fabsf(leaf);
        reg = (reg << 1) & mem_mask;
        edge = base_bit;
      }
    } else if (LM == 1) {
      // one path: its good candidate (index 0, metric pm) ranks before its
      // bad one (pm + |leaf|), so the rank needs no count, and its
      // decisions are the path: no trace, no walk back
      if (lane == 0) {
        const int v = base_bit ^ hard;
        edge = hard;
        reg = ((reg << 1) | (unsigned)v) & mem_mask;
        syn = v ? syn ^ hc : syn;
        const int o = out_pos[info_i];
        out_bits[frame * Kp + o] = (int8_t)v;
        if (LIST) {
          list_v[frame * N + u_pos[info_i]] = (int8_t)v;
          list_bits[frame * Kp + o] = (int8_t)v;
        }
      }
      ++info_i;
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
      const uint32_t sp = __shfl_sync(FULL_MASK, syn, parent);
      if (lane < L) {
        const int v = bp ^ hp ^ is_bad;  // good: edge == hard; bad: the other bit
        pm = is_bad ? pb : pg;
        edge = hp ^ is_bad;
        reg = ((rp << 1) | (unsigned)v) & mem_mask;
        syn = v ? sp ^ hc : sp;
        ring[(info_i & (TRACE_RING - 1)) * TW + lane] = (uint8_t)((parent << 1) | v);
      }
      if (LM > 1) sig.fork(parent);  // σ ← σ[parent] on every level
      if (((++info_i) & (TRACE_RING - 1)) == 0) flush(TRACE_RING);
    }

    // ---- partial-sum chain: cur = [left ^ cur, cur] up to the store level,
    // built in place inside the store level's row ----
    const int s = word >> 5 & 31;
    if (s > 0) {
      // lane m takes the first step: at an even phase (s = n) the chain is
      // the edge bit; at an odd one [left ^ edge, edge], left the level-n bit
      const int cmask = word >> 11;  // bit l: level l's left bits through σ
      if (lane < L) {
        uint8_t* cur = s > G ? Bs + lane * SS + so(s) : Bg + lane * SG + go(s);
        if (s == n) {
          cur[0] = (uint8_t)edge;
        } else {
          const int r = (LM > 1 && (cmask >> n & 1)) ? sig.get(2 * n - 3) : lane;
          const uint8_t left = Bs[r * SS + so(n)];
          cur[1] = (uint8_t)edge;
          cur[0] = (uint8_t)(left ^ edge);
        }
      }
      __syncwarp();
      for (int lv = n - 1; lv > s; --lv) {
        const bool via = LM > 1 && (cmask >> lv & 1);
        const int own = via ? sig.get(n + lv - 3) : 0;
        if (s > G)
          path_chain_pass(Bs + so(s), SS, Bs + so(lv), SS, via, own, n - lv, L, lane);
        else
          path_chain_pass(Bg + go(s), SG, lv > G ? Bs + so(lv) : Bg + go(lv), lv > G ? SS : SG, via,
                     own, n - lv, L, lane);
        __syncwarp();
      }
    }
    s_prev = s;
    word = next_word;
  }
  if (LM > 1 && (info_i & (TRACE_RING - 1))) flush(info_i & (TRACE_RING - 1));

  // ---- final stable sort of the list, CRC selection, backtrack ----
  int frank = 0;
  for (int j = 0; j < L; ++j) {
    const float pj = __shfl_sync(FULL_MASK, pm, j);
    frank += (pj < pm) || (pj == pm && j < lane);
  }
  const bool ok = use_crc && lane < L && syn == 0u && pm < PAC_BIG;
  const unsigned ok_ranks = __reduce_or_sync(FULL_MASK, ok ? (1u << frank) : 0u);
  const int sel_rank = ok_ranks ? __ffs(ok_ranks) - 1 : 0;
  const unsigned who = __ballot_sync(FULL_MASK, lane < L && frank == sel_rank);
  int best = __ffs(who) - 1;  // lane 0's walk: the selected slot
  int slot = lane;            // lane m's walk (LIST): slot m's path, into row frank
  int8_t* v = list_v + frame * L * N;
  if (LIST) {
    if (LM > 1)
      for (int t = lane; t < L * N; t += 32) v[t] = 0;
    if (lane < L) list_metrics[frame * L + frank] = pm < PAC_BIG ? pm : __int_as_float(0x7f800000);
    if (lane == 0) list_best[frame] = sel_rank;
  }
  if (lane == 0) out_pass[frame] = ok_ranks ? 1 : 0;
  if (LM == 1) return;
  // the walks back, over chunks of trace rows copied into the frame's shared
  // memory (rows of TW bytes, R >= TRACE_RING rows)
  uint8_t* TIs = base;
  const int R = frame_bytes / TW;
  for (int hi = Kp - 1; hi >= 0; hi -= R) {
    const int lo = hi - R + 1 > 0 ? hi - R + 1 : 0;
    __syncwarp();  // the tree's (or the previous chunk's) last reads, and the zeroed rows, are done
    const uint4* src = reinterpret_cast<const uint4*>(TI + lo * TW);
    uint4* dst = reinterpret_cast<uint4*>(TIs);
    for (int x = lane; x < (hi - lo + 1) * TW / 16; x += 32) dst[x] = src[x];
    __syncwarp();
    if (LIST) {
      // every path into row frank of the list, before lane 0 rewrites slot 0
      if (lane < L) {
        int8_t* vrow = v + frank * N;
        int8_t* brow = list_bits + (frame * L + frank) * Kp;
        for (int i = hi; i >= lo; --i) {
          const int w = TIs[(i - lo) * TW + slot];
          vrow[u_pos[i]] = (int8_t)(w & 1);
          brow[out_pos[i]] = (int8_t)(w & 1);
          slot = w >> 1;
        }
      }
      __syncwarp();
    }
    if (lane == 0) {
      // the selected path's bit v into slot 0 of each row; row i is read
      // before it is overwritten, and later steps read rows below i
      for (int i = hi; i >= lo; --i) {
        uint8_t* row = TIs + (i - lo) * TW;
        const int w = row[best];
        row[0] = (uint8_t)(w & 1);
        best = w >> 1;
      }
    }
    __syncwarp();
    for (int i = lo + lane; i <= hi; i += 32) out_bits[frame * Kp + out_pos[i]] = (int8_t)TIs[(i - lo) * TW];
  }
}

#define PAC_PATH_PARAMS                                                                          \
  const float* __restrict__ llr, const uint32_t* __restrict__ hcols,                             \
      const int* __restrict__ sched, float* glob_llr, uint8_t* glob_bits, uint8_t* trace_idx,    \
      int8_t* __restrict__ out_bits, uint8_t* __restrict__ out_pass,                             \
      const int* __restrict__ out_pos, const int* __restrict__ u_pos,                            \
      int8_t* __restrict__ list_v, int8_t* __restrict__ list_bits,                               \
      float* __restrict__ list_metrics, int* __restrict__ list_best, int B, int N, int n, int Kp, \
      int L, int G, unsigned mem_mask, unsigned tap_mask, int use_crc, int frame_bytes,          \
      int frames_per_block
#define PAC_PATH_ARGS                                                                           \
  llr, hcols, sched, glob_llr, glob_bits, trace_idx, out_bits, out_pass, out_pos, u_pos, list_v, \
      list_bits, list_metrics, list_best, B, N, n, Kp, L, G, mem_mask, tap_mask, use_crc,       \
      frame_bytes, frames_per_block, masks

template <int LM, bool LIST>
__global__ void __launch_bounds__(32 * MAX_FRAMES_PER_BLOCK, LM == 2 ? 7 : 0)
    pac_decode_kernel(PAC_PATH_PARAMS, const ResetMasks masks) {
  pac_path_decode<LM, LIST, false>(PAC_PATH_ARGS);
}

// LM 16 and 32 at N 16384..65536: σ in one more word
template <int LM, bool LIST>
__global__ void __launch_bounds__(32 * MAX_FRAMES_PER_BLOCK, 0)
    pac_decode_wide_kernel(PAC_PATH_PARAMS, const WideResetMasks masks) {
  pac_path_decode<LM, LIST, true>(PAC_PATH_ARGS);
}

// ---------------------------------------------------------------------------
// Over warps: list sizes 33..1024, one frame a block, one thread a path.
// ---------------------------------------------------------------------------

// The PAC decode with a frame spread over the warps of a block:
// thread m < L holds slot m's metric, shift register and syndrome and its
// two candidates, good m and bad L + m; σ is a table in shared memory
// (`DeepSigma`), and a fork reads the parent's candidates, leaf, syndrome
// and shift register from shared memory behind a block barrier.  T is the
// width of a trace entry and a σ field.  It computes what
// pac_decode_kernel computes.  The body of pac_deep_kernel (σ rows of
// DEEP_SIGMA_WORDS words at most: n <= 13 at 16-bit fields) and of
// pac_deep_wide_kernel (WORDS = DEEP_WIDE_SIGMA_WORDS: n 14..16).
template <typename T, bool LIST, int WORDS>
__device__ __forceinline__ void pac_deep_decode(
    const float* llr, const uint32_t* hcols, const int* sched, const int* phase_of,
    float* glob_llr, uint8_t* glob_bits,
    T* trace_idx,  // [B, Kp, L]: the trace, in global scratch
    int8_t* out_bits, uint8_t* out_pass, const int* out_pos, const int* u_pos, int8_t* list_v,
    int8_t* list_bits, float* list_metrics, int* list_best, int N, int n, int Kp, int L, int G,
    unsigned mem_mask, unsigned tap_mask, int use_crc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long frame = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool act = tid < L;  // thread m < L: slot m

  const DeepLayout lay = deep_layout(N, n, L, G, sizeof(T), 3);
  const int SS = (N >> G) - 1;
  const int SG = N - (N >> G);
  DeepSigma<T, WORDS> sig{reinterpret_cast<T*>(smem + lay.sig), lay.sig_row / (int)sizeof(T),
                          lay.sig_row / 4};
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + lay.keys);
  float* Ls = reinterpret_cast<float*>(smem + lay.ls);
  float* leafS = reinterpret_cast<float*>(smem + lay.words);
  uint32_t* synS = reinterpret_cast<uint32_t*>(smem + lay.words + round16(4 * L));
  unsigned* regS = reinterpret_cast<unsigned*>(smem + lay.words + 2 * round16(4 * L));
  uint8_t* Bs = smem + lay.bs;
  T* TI = trace_idx + frame * Kp * L;
  int* selS = reinterpret_cast<int*>(smem + lay.sel);
  float* Lg = glob_llr + frame * L * SG;  // unused when G == 0
  uint8_t* Bg = glob_bits + frame * L * SG;
  const float* ch = llr + frame * N;
  const int rev_shift = 32 - n;
  auto so = [&](int l) { return (N >> G) - (N >> (l - 1)); };
  auto go = [&](int l) { return N - (N >> (l - 1)); };

  if (act) sig.init(tid, tid, 2 * n - 2);
  __syncthreads();
  float pm = (tid == 0) ? 0.f : PAC_BIG;  // thread m < L: metric of slot m
  unsigned reg = 0;                        // thread m < L: shift register of slot m
  uint32_t syn = 0;                        // thread m < L: CRC syndrome of slot m
  int info_i = 0;
  int word = sched[0];
  int s_prev = 0;  // the previous phase's store level
  for (int p = 0; p < N; ++p) {
    const int next_word = p + 1 < N ? sched[p + 1] : 0;
    const int gl = word & 31;
    const int is_frozen = word >> 10 & 1;
    const uint32_t hc = (!is_frozen && use_crc) ? hcols[info_i] : 0u;
    const int l0 = p == 0 ? 1 : gl;
    // σ back to identity on the levels rewritten since the last fork, in
    // the thread's own row (as pac_decode_kernel's reset)
    if (act) sig.reset(tid, tid, l0 - 1, n - 1, s_prev >= 2 ? n + s_prev - 3 : -1);

    // ---- f/g updates down to level n−1 ----
    for (int l = l0; l < n; ++l) {
      const bool is_g = (p != 0) && (l == gl);
      const T* via = (is_g && l > 1 && (word >> 11 & 1)) ? sig.field(l - 2) : nullptr;
      if (l == 1) {
        if (G == 0)
          channel_pass(Ls + so(1), Bs + so(1), SS, ch, rev_shift, is_g, n - 1, L, tid, nt);
        else
          channel_pass(Lg + go(1), Bg + go(1), SG, ch, rev_shift, is_g, n - 1, L, tid, nt);
      } else if (l > G + 1) {
        block_fg_pass(Ls + so(l), Bs + so(l), SS, Ls + so(l - 1), SS, via, sig.row, is_g, n - l, L,
                      tid, nt);
      } else {  // the few passes that touch global memory: generic pointers
        const bool sh = l > G;
        block_fg_pass(sh ? Ls + so(l) : Lg + go(l), sh ? Bs + so(l) : Bg + go(l), sh ? SS : SG,
                      Lg + go(l - 1), SG, via, sig.row, is_g, n - l, L, tid, nt);
      }
      __syncthreads();
    }
    // the leaf (level n): thread m computes it from its parent row
    const bool g_leaf = gl == n;
    float leaf = 0.f;
    if (act) {
      float a, b;
      if (n == 1) {
        a = ch[0];
        b = ch[1];
      } else {
        const int r = (g_leaf && (word >> 11 & 1)) ? sig.get(tid, n - 2) : tid;
        const float* row = n - 1 > G ? Ls + so(n - 1) + r * SS : Lg + go(n - 1) + r * SG;
        a = row[0];
        b = row[1];
      }
      leaf = g_leaf ? g_update(a, b, Bs[tid * SS + so(n)]) : f_minsum(a, b);
    }
    const int hard = leaf < 0.f;
    const int base_bit = __popc(reg & tap_mask) & 1;  // edge bit for v = 0

    // ---- leaf decision: extend every path, or fork and keep the best L ----
    int edge = 0;  // thread m < L: the edge bit the partial sums of slot m take
    if (is_frozen) {
      if (act) {
        if (pm < PAC_BIG && base_bit != hard) pm = pm + fabsf(leaf);
        reg = (reg << 1) & mem_mask;
        edge = base_bit;
      }
    } else {
      const float cg = pm;                                           // index m
      const float cb = (pm < PAC_BIG) ? pm + fabsf(leaf) : PAC_BIG;  // index L + m
      if (act) {
        leafS[tid] = leaf;
        synS[tid] = syn;
        regS[tid] = reg;
      }
      // thread m's keys: good m and bad m (pads from L on), whose indices m
      // and L + m keep the plain version's layout [good×L, bad×L]
      block_sort_keys(keys, act ? cand_key(cg, tid) : ~0ull, act ? cand_key(cb, L + tid) : ~0ull,
                      sort_keys(L), tid);
      __syncthreads();
      // slot m: the candidate of rank m
      int parent = 0;
      if (act) {
        const unsigned long long key = keys[tid];
        const int w = key_index(key);
        const int is_bad = w >= L;
        parent = is_bad ? w - L : w;
        const int hp = leafS[parent] < 0.f;
        const unsigned rp = regS[parent];
        const int bp = __popc(rp & tap_mask) & 1;
        const uint32_t sp = synS[parent];
        const int v = bp ^ hp ^ is_bad;  // good: edge == hard; bad: the other bit
        pm = key_metric(key);
        edge = hp ^ is_bad;
        reg = ((rp << 1) | (unsigned)v) & mem_mask;
        syn = v ? sp ^ hc : sp;
        TI[info_i * L + tid] = (T)((parent << 1) | v);
      }
      sig.fork(tid, parent, act);  // σ ← σ[parent] on every level
      ++info_i;
    }

    // ---- partial-sum chain ----
    const int s = word >> 5 & 31;
    if (s > 0) {
      const int cmask = word >> 11;  // bit l: level l's left bits through σ
      if (act) {
        uint8_t* cur = s > G ? Bs + tid * SS + so(s) : Bg + tid * SG + go(s);
        if (s == n) {
          cur[0] = (uint8_t)edge;
        } else {
          const int r = (cmask >> n & 1) ? sig.get(tid, 2 * n - 3) : tid;
          const uint8_t left = Bs[r * SS + so(n)];
          cur[1] = (uint8_t)edge;
          cur[0] = (uint8_t)(left ^ edge);
        }
      }
      __syncthreads();
      for (int lv = n - 1; lv > s; --lv) {
        const T* via = (cmask >> lv & 1) ? sig.field(n + lv - 3) : nullptr;
        if (s > G)
          block_chain_pass(Bs + so(s), SS, Bs + so(lv), SS, via, sig.row, n - lv, L, tid, nt);
        else
          block_chain_pass(Bg + go(s), SG, lv > G ? Bs + so(lv) : Bg + go(lv), lv > G ? SS : SG,
                           via, sig.row, n - lv, L, tid, nt);
        __syncthreads();
      }
    }
    s_prev = s;
    word = next_word;
  }

  // ---- final stable sort of the list, CRC selection, backtrack ----
  float* metric = reinterpret_cast<float*>(keys);
  if (act) metric[tid] = pm;
  if (tid == 0) *selS = L;
  __syncthreads();
  int least;
  const bool ok = use_crc && act && syn == 0u && pm < PAC_BIG;
  const int frank = final_rank(metric, L, tid, pm, ok, selS, &least);
  const int sel_rank = least < L ? least : 0;
  if (LIST) {
    int8_t* v = list_v + frame * L * N;
    for (int t = tid; t < L * N; t += nt) v[t] = 0;
    __syncthreads();
    if (act) {
      int8_t* vrow = v + frank * N;
      int8_t* brow = list_bits + (frame * L + frank) * Kp;
      int slot = tid;
      for (int i = Kp - 1; i >= 0; --i) {
        const int w = TI[i * L + slot];
        vrow[u_pos[i]] = (int8_t)(w & 1);
        brow[out_pos[i]] = (int8_t)(w & 1);
        slot = w >> 1;
      }
      list_metrics[frame * L + frank] = pm < PAC_BIG ? pm : __int_as_float(0x7f800000);
    }
    if (tid == 0) list_best[frame] = sel_rank;
    __syncthreads();
  }
  if (act && frank == sel_rank) {
    // the selected path's bit v into slot 0 of each trace row
    int slot = tid;
    for (int i = Kp - 1; i >= 0; --i) {
      const int w = TI[i * L + slot];
      TI[i * L] = (T)(w & 1);
      slot = w >> 1;
    }
    out_pass[frame] = least < L ? 1 : 0;
  }
  __syncthreads();
  for (int j = tid; j < Kp; j += nt) out_bits[frame * Kp + j] = (int8_t)TI[phase_of[j] * L];
}

#define PAC_DEEP_PARAMS(T)                                                                       \
  const float* __restrict__ llr, const uint32_t* __restrict__ hcols,                             \
      const int* __restrict__ sched, const int* __restrict__ phase_of, float* glob_llr,          \
      uint8_t* glob_bits, T* trace_idx, int8_t* __restrict__ out_bits,                           \
      uint8_t* __restrict__ out_pass, const int* __restrict__ out_pos,                           \
      const int* __restrict__ u_pos, int8_t* __restrict__ list_v, int8_t* __restrict__ list_bits, \
      float* __restrict__ list_metrics, int* __restrict__ list_best, int N, int n, int Kp, int L, \
      int G, unsigned mem_mask, unsigned tap_mask, int use_crc
#define PAC_DEEP_ARGS                                                                            \
  llr, hcols, sched, phase_of, glob_llr, glob_bits, trace_idx, out_bits, out_pass, out_pos,      \
      u_pos, list_v, list_bits, list_metrics, list_best, N, n, Kp, L, G, mem_mask, tap_mask,     \
      use_crc

template <typename T, bool LIST>
__global__ void __launch_bounds__(DEEP_MAX_M) pac_deep_kernel(PAC_DEEP_PARAMS(T)) {
  pac_deep_decode<T, LIST, DEEP_SIGMA_WORDS>(PAC_DEEP_ARGS);
}

// 16-bit entries (L 129..1024) at N 16384..65536: σ rows of up to 15 words
template <bool LIST>
__global__ void __launch_bounds__(DEEP_MAX_M) pac_deep_wide_kernel(PAC_DEEP_PARAMS(uint16_t)) {
  pac_deep_decode<uint16_t, LIST, DEEP_WIDE_SIGMA_WORDS>(PAC_DEEP_ARGS);
}

// ---------------------------------------------------------------------------
// Over a cluster: list sizes 1025..8192, one frame a cluster of blocks.
// ---------------------------------------------------------------------------

// The PAC decode with a frame spread over a cluster of C =
// cluster_blocks(L) blocks of 1024 threads, on the SCL kernel's cluster
// layout (`scl_decode.cu`'s scl_cluster_kernel has the design): thread tid
// of rank r holds slot m = r·1024 + tid's metric, shift register and
// syndrome and its candidates good m and bad L + m; tree levels G+1..n of
// the block's slots in its shared memory, levels 1..G in global scratch;
// σ, the sort keys and the published leaf, syndrome and shift register of
// the block's 1024 slots in its shared memory, and the fork's parent
// values through DSMEM.  It computes what pac_decode_kernel computes.
template <bool LIST>
__global__ void __launch_bounds__(CLUSTER_THREADS) pac_cluster_kernel(
    const float* __restrict__ llr, const uint32_t* __restrict__ hcols,
    const int* __restrict__ sched, const int* __restrict__ phase_of,
    float* glob_llr,     // [B, L, N-(N>>G)]: LLR levels 1..G, null when G == 0
    uint8_t* glob_bits,  // [B, L, N-(N>>G)]: edge-bit levels 1..G
    uint16_t* trace_idx,  // [B, Kp, L]: the trace, in global scratch
    int8_t* __restrict__ out_bits, uint8_t* __restrict__ out_pass, const int* __restrict__ out_pos,
    const int* __restrict__ u_pos, int8_t* __restrict__ list_v, int8_t* __restrict__ list_bits,
    float* __restrict__ list_metrics, int* __restrict__ list_best, int N, int n, int Kp, int L,
    int G, unsigned mem_mask, unsigned tap_mask, int use_crc) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long frame = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int base = rank * CLUSTER_THREADS;  // the block's first slot
  const int m = base + tid;                 // this thread's slot
  const int Lr = L - base < 0 ? 0 : L - base < CLUSTER_THREADS ? L - base : CLUSTER_THREADS;
  const bool act = m < L;
  const int P = sort_keys(L);

  const ClusterLayout lay = cluster_layout(N, n, G, 3);
  const int SS = (N >> G) - 1;  // entries of a slot's shared row: levels G+1..n
  const int SG = N - (N >> G);  // entries of a slot's global row: levels 1..G
  // σ after i forks: table i & 1 (the other is the next fork's target)
  auto sigma = [&](int i) {
    return DeepSigma<uint16_t>{reinterpret_cast<uint16_t*>(smem + (i & 1) * lay.sig2), lay.sig_row / 2,
                               lay.sig_row / 4};
  };
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + lay.keys);
  float* Ls = reinterpret_cast<float*>(smem + lay.ls);
  uint8_t* Bs = smem + lay.bs;
  int* selS = reinterpret_cast<int*>(smem + lay.sel);
  float* Lg = glob_llr + frame * L * SG;  // unused when G == 0
  uint8_t* Bg = glob_bits + frame * L * SG;
  uint16_t* TI = trace_idx + frame * Kp * L;
  const float* ch = llr + frame * N;
  auto so = [&](int l) { return (N >> G) - (N >> (l - 1)); };
  auto go = [&](int l) { return N - (N >> (l - 1)); };
  // word k (leaf, syndrome, shift register) of published set i (an info phase's parity)
  auto wordS = [&](int i, int k) {
    return reinterpret_cast<unsigned*>(smem + lay.words + i * lay.word_set + k * 4 * CLUSTER_THREADS);
  };

  if (act) sigma(0).init(tid, m, 2 * n - 2);
  if (m == 0) *selS = L;
  __syncthreads();
  float pm = (m == 0) ? 0.f : PAC_BIG;  // metric of slot m
  unsigned reg = 0;                      // shift register of slot m
  uint32_t syn = 0;                      // CRC syndrome of slot m
  int info_i = 0;
  int word = sched[0];
  for (int p = 0; p < N; ++p) {
    // the phase's word, read at the previous phase's end: no register holds
    // the next one across the fork (the 64-register cap); nor the previous
    // one's, read again here for its store level and its barrier
    const int prev = p > 0 ? sched[p - 1] : 0;
    const int s_prev = prev >> 5 & 31;
    const int gl = word & 31;
    const int is_frozen = word >> 10 & 1;
    const int l0 = p == 0 ? 1 : gl;
    DeepSigma<uint16_t> sig = sigma(info_i);
    if (act) sig.reset(tid, m, l0 - 1, n - 1, s_prev >= 2 ? n + s_prev - 3 : -1);
    // another block may still read the rows this phase rewrites
    if (prev >> 11) cluster_wait();

    // ---- f/g updates down to level n−1, this block's slots ----
    for (int l = l0; l < n; ++l) {
      const bool is_g = (p != 0) && (l == gl);
      float* dst = l > G ? Ls + so(l) : Lg + base * SG + go(l);
      const uint8_t* dbits = l > G ? Bs + so(l) : Bg + base * SG + go(l);
      const int ds = l > G ? SS : SG;
      if (l == 1) {
        channel_pass(dst, dbits, ds, ch, 32 - n, is_g, n - 1, Lr, tid, CLUSTER_THREADS);
      } else {
        const uint16_t* via = (is_g && (word >> 11 & 1)) ? sig.field(l - 2) : nullptr;
        if (l - 1 > G)
          cluster_fg_pass<true>(dst, dbits, ds, Ls + so(l - 1), SS, via, sig.row, is_g, n - l, base, rank,
                                Lr, tid);
        else
          cluster_fg_pass<false>(dst, dbits, ds, Lg + go(l - 1), SG, via, sig.row, is_g, n - l, base,
                                 rank, Lr, tid);
      }
      __syncthreads();
    }
    // the leaf (level n) from the parent row
    const bool g_leaf = gl == n;
    float leaf = 0.f;
    if (act) {
      float a, b;
      if (n == 1) {
        a = ch[0];
        b = ch[1];
      } else {
        const int r = (g_leaf && (word >> 11 & 1)) ? sig.get(tid, n - 2) : m;
        if (n - 1 > G) {
          const float* row = cluster_row(Ls + so(n - 1), r, SS, rank);
          a = row[0];
          b = row[1];
        } else {
          const float* row = Lg + go(n - 1) + r * SG;
          a = __ldcg(row);
          b = __ldcg(row + 1);
        }
      }
      leaf = g_leaf ? g_update(a, b, Bs[tid * SS + so(n)]) : f_minsum(a, b);
    }
    const int hard = leaf < 0.f;
    const int base_bit = __popc(reg & tap_mask) & 1;  // edge bit for v = 0

    // ---- leaf decision: extend every slot, or fork and keep the best L ----
    int edge = 0;
    if (is_frozen) {
      if (act) {
        if (pm < PAC_BIG && base_bit != hard) pm = pm + fabsf(leaf);
        reg = (reg << 1) & mem_mask;
        edge = base_bit;
      }
    } else {
      const float cg_ = pm;                                           // index m
      const float cb = (pm < PAC_BIG) ? pm + fabsf(leaf) : PAC_BIG;   // index L + m
      const int set = info_i & 1;
      if (act) {
        wordS(set, 0)[tid] = __float_as_uint(leaf);
        wordS(set, 1)[tid] = syn;
        wordS(set, 2)[tid] = reg;
      }
      unsigned long long* sorted = cluster_sort_keys(keys, act ? cand_key(cg_, m) : ~0ull,
                                                     act ? cand_key(cb, L + m) : ~0ull, P, rank, tid,
                                                     info_i * cluster_exchanges(P));
      // slot m: the candidate of rank m.  Every thread takes new values
      // (a thread past L those of slot 0's parent, never read), so that no
      // slot state is live across the sort: the 64 registers hold it
      const unsigned long long key = cluster_key(sorted, act ? m : 0);
      const int w = act ? key_index(key) : 0;
      const int is_bad = w >= L;
      const int parent = is_bad ? w - L : w;
      const int hp = __uint_as_float(*path_entry(wordS(set, 0), parent)) < 0.f;
      const unsigned rp = *path_entry(wordS(set, 2), parent);
      const int bp = __popc(rp & tap_mask) & 1;
      const uint32_t sp = *path_entry(wordS(set, 1), parent);
      const uint32_t hc = use_crc ? hcols[info_i] : 0u;
      const int v = bp ^ hp ^ is_bad;  // good: edge == hard; bad: the other bit
      pm = key_metric(key);
      edge = hp ^ is_bad;
      reg = ((rp << 1) | (unsigned)v) & mem_mask;
      syn = v ? sp ^ hc : sp;
      if (act) TI[info_i * L + m] = (uint16_t)((parent << 1) | v);
      cluster_sigma_fork(sig, sigma(info_i + 1).tab, tid, parent, act);  // σ ← σ[parent] on every level
      sig = sigma(++info_i);
    }

    // ---- partial-sum chain, this block's slots ----
    const int s = word >> 5 & 31;
    if (s > 0) {
      const int cmask = word >> 11;  // bit l: level l's left bits through σ
      if (act) {
        uint8_t* cur = s > G ? Bs + tid * SS + so(s) : Bg + m * SG + go(s);
        if (s == n) {
          cur[0] = (uint8_t)edge;
        } else {
          const int r = (cmask >> n & 1) ? sig.get(tid, 2 * n - 3) : m;
          const uint8_t left = *cluster_row(Bs + so(n), r, SS, rank);
          cur[1] = (uint8_t)edge;
          cur[0] = (uint8_t)(left ^ edge);
        }
      }
      __syncthreads();
      uint8_t* st = s > G ? Bs + so(s) : Bg + base * SG + go(s);
      const int sts = s > G ? SS : SG;
      for (int lv = n - 1; lv > s; --lv) {
        const uint16_t* via = (cmask >> lv & 1) ? sig.field(n + lv - 3) : nullptr;
        if (lv > G)
          cluster_chain_pass<true>(st, sts, Bs + so(lv), SS, via, sig.row, n - lv, base, rank, Lr, tid);
        else
          cluster_chain_pass<false>(st, sts, Bg + go(lv), SG, via, sig.row, n - lv, base, rank, Lr, tid);
        __syncthreads();
      }
    }
    // a row read through σ may be another block's: this block arrives, and
    // waits before it next writes a row (split)
    if (word >> 11) cluster_arrive();
    word = p + 1 < N ? sched[p + 1] : 0;
  }
  if (sched[N - 1] >> 11) cluster_wait();

  // ---- final stable sort of the list, CRC selection, backtrack ----
  unsigned* passS = wordS(info_i & 1, 1);
  if (act) passS[tid] = use_crc && syn == 0u && pm < PAC_BIG;  // slot m passes
  unsigned long long* sorted = cluster_sort_keys(keys, act ? cand_key(pm, m) : ~0ull, ~0ull, P, rank,
                                                 tid, info_i * cluster_exchanges(P));
  // thread r = m < L: the key (metric, slot) of final rank r
  const unsigned long long fkey = act ? cluster_key(sorted, m) : ~0ull;
  const int slot_r = act ? key_index(fkey) : 0;
  if (act && *path_entry(passS, slot_r)) atomicMin(cluster.map_shared_rank(selS, 0), m);
  cluster.sync();
  const int least = *cluster.map_shared_rank(selS, 0);
  const int sel_rank = least < L ? least : 0;
  if (LIST) {
    // the block's rows of the list (ranks base..base+Lr−1) zeroed, then the
    // slot of rank m into row m, before the trace is rewritten
    int8_t* v = list_v + frame * L * N;
    for (int t = tid; t < Lr * N; t += CLUSTER_THREADS) v[base * N + t] = 0;
    __syncthreads();
    if (act) {
      const float mr = key_metric(fkey);
      list_metrics[frame * L + m] = mr < PAC_BIG ? mr : __int_as_float(0x7f800000);
      int8_t* vrow = v + m * N;
      int8_t* brow = list_bits + (frame * L + m) * Kp;
      int slot = slot_r;
      for (int i = Kp - 1; i >= 0; --i) {
        const int w = __ldcg(TI + i * L + slot);
        vrow[u_pos[i]] = (int8_t)(w & 1);
        brow[out_pos[i]] = (int8_t)(w & 1);
        slot = w >> 1;
      }
    }
    if (m == 0) list_best[frame] = sel_rank;
  }
  cluster.sync();  // every walk has read the trace, and rank 0's word is read
  if (act && m == sel_rank) {
    // the selected slot's bit v into slot 0 of each trace row
    int slot = slot_r;
    for (int i = Kp - 1; i >= 0; --i) {
      const int w = __ldcg(TI + i * L + slot);
      TI[i * L] = (uint16_t)(w & 1);
      slot = w >> 1;
    }
    out_pass[frame] = least < L ? 1 : 0;
  }
  cluster.sync();
  for (int j = m; j < Kp; j += C * CLUSTER_THREADS)
    out_bits[frame * Kp + j] = (int8_t)__ldcg(TI + phase_of[j] * L);
}

// every kernel argument but the σ masks, and the stream
struct Args {
  const float* llr;
  const uint32_t* hcols;
  const int* sched;
  const int* phase_of;
  float* glob_llr;
  uint8_t* glob_bits;
  int8_t* out_bits;
  uint8_t* out_pass;
  const int* out_pos;
  const int* u_pos;
  int8_t* list_v;
  int8_t* list_bits;
  float* list_metrics;
  int* list_best;
  int B, N, n, Kp, L, G;
  unsigned mem_mask, tap_mask;
  int use_crc, frame_bytes, frames_per_block;
};

// the one-path-a-lane kernel of width LM: pac_decode_kernel, or WIDE (LM 16
// and 32 past n = 13) pac_decode_wide_kernel
template <int LM, bool LIST, bool WIDE>
auto path_kernel() {
  if constexpr (WIDE)
    return pac_decode_wide_kernel<LM, LIST>;
  else
    return pac_decode_kernel<LM, LIST>;
}

template <int LM, bool LIST, bool WIDE>
int launch_as(const Args& a, uint8_t* trace_idx, cudaStream_t stream) {
  const auto kernel = path_kernel<LM, LIST, WIDE>();
  const size_t smem = (size_t)a.frame_bytes * a.frames_per_block;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.B + a.frames_per_block - 1) / a.frames_per_block;
  kernel<<<blocks, 32 * a.frames_per_block, smem, stream>>>(
      a.llr, a.hcols, a.sched, a.glob_llr, a.glob_bits, trace_idx, a.out_bits, a.out_pass,
      a.out_pos, a.u_pos, a.list_v, a.list_bits, a.list_metrics, a.list_best, a.B, a.N, a.n,
      a.Kp, a.L, a.G, a.mem_mask, a.tap_mask, a.use_crc, a.frame_bytes, a.frames_per_block,
      reset_masks<LM, WIDE>(a.n));
  return (int)cudaGetLastError();
}

// the list instantiation when the list outputs are given, else the drivers' one
template <int LM>
int launch(const Args& a, void* trace_idx, cudaStream_t stream) {
  // the frame's shared memory: a whole number of 16-byte words, the tree
  // rows and the trace ring, through which the walks back also take the
  // trace a chunk of rows at a time
  // (one path: no trace, no ring)
  if ((LM > 1 && !trace_idx) || !a.out_pos || a.n > MAX_LEVELS ||
      (LM > 1 && !PathSigma<LM, (LM >= 16)>::holds(a.n)) || a.frame_bytes % 16 ||
      a.frame_bytes < round16(5 * a.L * ((a.N >> a.G) - 1)) + (LM > 1 ? TRACE_RING * round16(a.L) : 0))
    return (int)cudaErrorInvalidValue;
  uint8_t* ti = static_cast<uint8_t*>(trace_idx);
  if constexpr (LM >= 16)
    if (path_wide<LM>(a.n))
      return a.list_v ? launch_as<LM, true, true>(a, ti, stream) : launch_as<LM, false, true>(a, ti, stream);
  return a.list_v ? launch_as<LM, true, false>(a, ti, stream) : launch_as<LM, false, false>(a, ti, stream);
}

// the over-warps kernel: pac_deep_kernel<T>, or WIDE (16-bit entries past
// n = 13) pac_deep_wide_kernel
template <typename T, bool LIST, bool WIDE>
auto deep_kernel() {
  if constexpr (WIDE)
    return pac_deep_wide_kernel<LIST>;
  else
    return pac_deep_kernel<T, LIST>;
}

template <typename T, bool LIST, bool WIDE>
int launch_deep_as(const Args& a, T* trace_idx, cudaStream_t stream) {
  const DeepLayout lay = deep_layout(a.N, a.n, a.L, a.G, sizeof(T), 3);
  if (!trace_idx || a.n > MAX_LEVELS ||
      lay.sig_row > 4 * (WIDE ? DEEP_WIDE_SIGMA_WORDS : DEEP_SIGMA_WORDS) || lay.total != a.frame_bytes ||
      a.frames_per_block != 1)
    return (int)cudaErrorInvalidValue;
  const auto kernel = deep_kernel<T, LIST, WIDE>();
  cudaError_t err = set_smem(kernel, lay.total);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B, deep_threads(a.L), lay.total, stream>>>(
      a.llr, a.hcols, a.sched, a.phase_of, a.glob_llr, a.glob_bits, trace_idx, a.out_bits,
      a.out_pass, a.out_pos, a.u_pos, a.list_v, a.list_bits, a.list_metrics, a.list_best, a.N, a.n,
      a.Kp, a.L, a.G, a.mem_mask, a.tap_mask, a.use_crc);
  return (int)cudaGetLastError();
}

// byte trace entries while 2L <= 256, else 16-bit ones (wide past n = 13)
int launch_deep(const Args& a, void* trace_idx, cudaStream_t stream) {
  if (a.L <= 128)
    return a.list_v ? launch_deep_as<uint8_t, true, false>(a, static_cast<uint8_t*>(trace_idx), stream)
                    : launch_deep_as<uint8_t, false, false>(a, static_cast<uint8_t*>(trace_idx), stream);
  uint16_t* ti = static_cast<uint16_t*>(trace_idx);
  if (deep_wide<uint16_t>(a.n))
    return a.list_v ? launch_deep_as<uint16_t, true, true>(a, ti, stream)
                    : launch_deep_as<uint16_t, false, true>(a, ti, stream);
  return a.list_v ? launch_deep_as<uint16_t, true, false>(a, ti, stream)
                  : launch_deep_as<uint16_t, false, false>(a, ti, stream);
}

template <bool LIST>
int launch_cluster_as(const Args& a, uint16_t* trace_idx, cudaStream_t stream) {
  const ClusterLayout lay = cluster_layout(a.N, a.n, a.G, 3);
  // levels 1..G in global scratch, G+1..n in each block's shared memory,
  // one frame a cluster
  if (!trace_idx || (a.G > 0 && (!a.glob_llr || !a.glob_bits)) || a.n > MAX_LEVELS || a.G < 0 ||
      a.G >= a.n || lay.total != a.frame_bytes || a.frames_per_block != 1)
    return (int)cudaErrorInvalidValue;
  return launch_cluster_kernel(pac_cluster_kernel<LIST>, a.B, a.L, lay.total, stream, a.llr, a.hcols,
                               a.sched, a.phase_of, a.glob_llr, a.glob_bits, trace_idx, a.out_bits,
                               a.out_pass, a.out_pos, a.u_pos, a.list_v, a.list_bits,
                               a.list_metrics, a.list_best, a.N, a.n, a.Kp, a.L, a.G, a.mem_mask,
                               a.tap_mask, a.use_crc);
}

int launch_cluster(const Args& a, void* trace_idx, cudaStream_t stream) {
  uint16_t* ti = static_cast<uint16_t*>(trace_idx);
  return a.list_v ? launch_cluster_as<true>(a, ti, stream) : launch_cluster_as<false>(a, ti, stream);
}

// The frames a block (1..MAX_FRAMES_PER_BLOCK) that let an SM hold the most
// frames at once, by the occupancy calculator (shared memory, registers and
// warps all counted); ties go to more frames a block.  The list
// instantiation runs on the same plan: it has the same launch bounds.
template <typename Kern>
int plan(Kern kernel, int frame_bytes, int max_block_smem, int* frames_per_block, int* frames_per_sm) {
  *frames_per_block = 1;
  *frames_per_sm = 0;
  for (int fpb = 1; fpb <= MAX_FRAMES_PER_BLOCK; ++fpb) {
    const size_t smem = (size_t)frame_bytes * fpb;
    if (smem > (size_t)max_block_smem) break;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * fpb, smem);
    if (err != cudaSuccess) return (int)err;
    if (blocks * fpb >= *frames_per_sm) {
      *frames_per_block = fpb;
      *frames_per_sm = blocks * fpb;
    }
  }
  return 0;
}

template <int LM>
int plan_path(int n, int frame_bytes, int max_block_smem, int* frames_per_block, int* frames_per_sm) {
  if constexpr (LM >= 16)
    if (path_wide<LM>(n))
      return plan(pac_decode_wide_kernel<LM, false>, frame_bytes, max_block_smem, frames_per_block,
                  frames_per_sm);
  return plan(pac_decode_kernel<LM, false>, frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
}

}  // namespace

extern "C" int pac_decode_launch(const void* llr, const void* hcols, const void* sched,
                                 const void* phase_of, void* glob_llr, void* glob_bits,
                                 void* trace_idx, void* out_bits, void* out_pass, const void* out_pos,
                                 const void* u_pos, void* list_v, void* list_bits,
                                 void* list_metrics, void* list_best, int B, int N, int n, int Kp,
                                 int L, int G, unsigned mem_mask, unsigned tap_mask, int use_crc,
                                 int frame_bytes, int frames_per_block, void* stream) {
  const Args a{static_cast<const float*>(llr), static_cast<const uint32_t*>(hcols),
               static_cast<const int*>(sched), static_cast<const int*>(phase_of),
               static_cast<float*>(glob_llr), static_cast<uint8_t*>(glob_bits),
               static_cast<int8_t*>(out_bits), static_cast<uint8_t*>(out_pass),
               static_cast<const int*>(out_pos), static_cast<const int*>(u_pos),
               static_cast<int8_t*>(list_v), static_cast<int8_t*>(list_bits),
               static_cast<float*>(list_metrics), static_cast<int*>(list_best),
               B, N, n, Kp, L, G, mem_mask, tap_mask, use_crc, frame_bytes, frames_per_block};
  auto st = static_cast<cudaStream_t>(stream);
  if (L < 1 || L > CLUSTER_MAX_M) return (int)cudaErrorInvalidValue;
  if (L > DEEP_MAX_M) return launch_cluster(a, trace_idx, st);
  if (L >= DEEP_MIN_M) return launch_deep(a, trace_idx, st);
  if (L == 1) return launch<1>(a, trace_idx, st);
  if (L <= 2) return launch<2>(a, trace_idx, st);
  if (L <= 4) return launch<4>(a, trace_idx, st);
  if (L <= 8) return launch<8>(a, trace_idx, st);
  if (L <= 16) return launch<16>(a, trace_idx, st);
  return launch<32>(a, trace_idx, st);
}

extern "C" int pac_launch_plan(int L, int n, int frame_bytes, int max_block_smem, int* frames_per_block,
                               int* frames_per_sm) {
  if (L < 1 || L > CLUSTER_MAX_M) return (int)cudaErrorInvalidValue;
  if (L > DEEP_MAX_M) {  // frames_per_sm: the frames (clusters) the card runs at once
    *frames_per_block = 1;
    return plan_cluster(pac_cluster_kernel<false>, L, frame_bytes, max_block_smem, frames_per_sm);
  }
  if (L > 128)
    return deep_wide<uint16_t>(n)
               ? plan_deep(pac_deep_wide_kernel<false>, L, frame_bytes, max_block_smem, frames_per_block,
                           frames_per_sm)
               : plan_deep(pac_deep_kernel<uint16_t, false>, L, frame_bytes, max_block_smem,
                           frames_per_block, frames_per_sm);
  if (L >= DEEP_MIN_M)
    return plan_deep(pac_deep_kernel<uint8_t, false>, L, frame_bytes, max_block_smem,
                     frames_per_block, frames_per_sm);
  if (L == 1) return plan_path<1>(n, frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
  if (L <= 2) return plan_path<2>(n, frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
  if (L <= 4) return plan_path<4>(n, frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
  if (L <= 8) return plan_path<8>(n, frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
  if (L <= 16) return plan_path<16>(n, frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
  return plan_path<32>(n, frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
}

extern "C" const char* pac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
