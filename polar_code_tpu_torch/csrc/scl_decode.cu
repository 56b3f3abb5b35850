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
// σ lives in registers, in one of two layouts, up to M = 32; above, in a
// table in shared memory.
//   * By level, the byte-word instantiations scl_decode_kernel<M> at M ∈ {1,
//     2, 4, 8}, which the sweeps launch.  Lane r < 2n−1 holds the map of one
//     level as a word of M bytes, byte m = σ[m]: rows 0..n−2 for LLR levels
//     1..n−1 (level n is read only at its own leaf), rows n−1..2n−2 for bit
//     levels 1..n.  A fork is two byte permutes (`__byte_perm`, prmt) in
//     every lane, their selectors the survivors' parents gathered by two
//     warp reductions; a read through σ is one shuffle from the level's
//     lane, once per level and phase.  A byte permute takes 8 bytes at
//     most, so this layout serves M <= 8.
//   * By path, the instantiations scl_path_kernel<LM> (LM ∈ {8, 16, 32},
//     the list size rounded up to a power of two, M itself a runtime
//     argument), which serve every other M in 1..32: the PAC kernel's
//     layout, shared with it in `list_decode.cuh`.  Lane m holds path m's
//     origin row at every level, one field of log2(LM) bits a level,
//     32/log2(LM) fields a word, 1-4 words: fields 0..n−2 for LLR levels
//     1..n−1, fields n−1..2n−3 for bit levels 2..n (level 1's bits are read
//     only by the g of phase N/2, from the path's own row, with no fork
//     since the chain stored them).  2n−2 = 24 fields at n = 13, which four words of six
//     5-bit fields hold at LM = 32 (`ops/scl_cuda.py::SIGMA_FIELDS`); past
//     it (N 16384..65536, 30 fields at n = 16) LM 16 and 32 run the wide
//     twins scl_path_wide_kernel<LM>, one more word under the same launch
//     bound, and M ∈ {2, 4, 8} leave the byte words for LM = 8, whose three
//     words of ten 3-bit fields already hold 30 (`BYTE_WORD_MAX_LEVELS`).  A
//     fork is one shuffle a word from lane parent[m]; a read through σ is a
//     field extract in lane m and a shuffle to the lanes that handle path
//     m's entries.  A phase's resets (the LLR levels its descent writes, the
//     bit level the previous chain stored) are applied together at the
//     phase's start, one select a word with masks the host builds for
//     (n, LM).  Lane p holds candidates 2p and 2p + 1.  A fork sorts the 2M
//     candidates as unique 64-bit keys (`cand_key`, below) with a bitonic
//     network inside the warp (`path_select`): shuffles of the keys' two
//     halves, no shared memory, no barrier, unrolled to LM with the stages
//     past sort_keys(M) skipped; survivor m takes the key of rank m from
//     its own register, its metric back from the key.  Counting each
//     candidate's rank over all 2M by shuffles, O(M) a lane, took 34% / 46%
//     of the time at M 16 / 32 on an H100 (`PERF.md`).
//   * Over warps, the instantiations scl_deep_kernel<T> (M 33..1024, a
//     runtime argument): one frame a block of M rounded up to a power of
//     two threads (`deep_threads`: one a pair of sort keys), thread m path
//     m.  One path a lane is what caps the layouts above at 32: their
//     exchanges between paths (σ reads, the fork, the rank, the parent's
//     metric, leaf and syndrome, the final rank and the CRC selection) are
//     warp shuffles and 32-bit ballots.  Here each is a shared-memory write,
//     a block barrier and a read (`list_decode.cuh`).  σ is a table, a row
//     of 2n−2 fields a path (4-48 bytes, `DeepSigma`): a read through σ is
//     one load of the path's field, a reset writes the thread's own row, and
//     a fork copies the parent's row through registers between two
//     barriers.  At an info phase each path publishes its leaf and syndrome,
//     and the block sorts the 2M candidates as 64-bit keys (the metric's
//     order-preserving word above the index 2p + b), padded to a power of two,
//     with a bitonic network (`block_sort_keys`: a thread's two keys in
//     registers, shuffles within a warp, shared memory behind barriers only
//     across warps; O(log² M) steps a thread, where counting each candidate's
//     rank over all 2M takes O(M)).  The keys are unique, so the order is the
//     plain version's stable sort exactly, and survivor m takes the key of rank
//     m, its metric back from the key and its parent's leaf and syndrome after
//     the barrier.  The selected rank is a min-reduction (`final_rank`, an
//     atomicMin in shared memory) where the 32-bit mask of the warp layouts
//     would overflow.  T, the width of a trace entry 2p+b < 2M and of a σ
//     field, is a byte up to M = 128 and 16 bits above.  A 16-bit row past n
//     = 13 (52-60 bytes) is longer than the fork's 12 registers: the twin
//     scl_deep_wide_kernel copies it in two halves of 8 words, four block
//     barriers a fork where the others take two.
//   * On a cluster, the instantiations scl_cluster_kernel<LIST, F> (M
//     1025..16384, a runtime argument, as is the cluster's size C; F the
//     float type, below).  One
//     thread a path caps a block at M = 1024 (its threads), and 64
//     registers a thread at two sort keys; so a frame goes to a
//     thread-block cluster of cluster_blocks(M) = 2, 4, 8 or 16 blocks of
//     1024 threads (16 past M = 8192, a non-portable size the host allows
//     on the kernel, `allow_cluster`), thread tid of rank r path r·1024 +
//     tid (`list_decode.cuh`).  Levels G+1..n of a block's 1024 paths are in
//     its shared memory and levels 1..G of every path in global scratch, G
//     the smallest whose block fits (G = n − 4 at N 16..2048); each block
//     runs the passes of its own paths, reading a parent row through σ
//     wherever it lies: another block's shared row through distributed
//     shared memory, a global row from L2.  When every level was in global
//     scratch, those round trips were half the time at P(128,64) M=2048
//     (`PERF.md` §6).  The fork is the over-warps sort extended to the
//     cluster (`cluster_sort_keys`: the stages whose partner is 2048 keys
//     or more away cross blocks, one cluster barrier each, the keys in two
//     exchange buffers in turns), the final rank the same sort over the M
//     (metric, path) keys, as by path, and the selected rank an atomicMin
//     on rank 0's word.  16-bit trace entries and σ fields; σ's copy at a
//     fork loops over a row's words, so this instantiation takes every n up
//     to 16 as it is (K3 at N = 65536 at G = n − 2, where the rest of a
//     block leaves too little room for n − 3).
//   * Past M = 16384, scl_cluster_pair_kernel<LIST> (M 16385..32768): 16
//     blocks is the largest cluster an H100 places (7 at once, `PERF.md`
//     §6), and a block at most 1024 threads, so each thread holds two paths
//     (r·2048 + tid and r·2048 + 1024 + tid) and four sort keys
//     (`cluster_sort_keysn<4>`: distances 1 and 2 in registers, the stages
//     across blocks at 4096 keys and more).  The same body,
//     scl_cluster_decode<LIST, 2>, with the paths a thread a compile-time
//     parameter, so that the one-path kernels are what they were.  A block's
//     2048 paths take three key buffers of 96 KB and two word sets of
//     32 KB, and two σ tables of 2048 rows (96 KB at n = 7, 240 KB at
//     n = 16) would not fit beside them: σ's two tables go to global
//     scratch ([B][2][M][row], `sigma_g`), the block's own rows read through
//     L1, a parent's row at a fork from L2.  The 16-bit fields are full at
//     M = 32768 (2p + b up to 65535, unsigned), and the within-frame
//     offsets, which reach 2^31 there, are 64-bit (`ClusterOff`).
//   * Past M = 32768, scl_cluster_quad_kernel<LIST> (M 32769..65536): the
//     same body at four paths a thread, eight sort keys
//     (`cluster_sort_keysn<8>`: distances 1..4 in registers, 8..128 by
//     shuffles, 256..4096 through the buffers, 8192 and above across
//     blocks).  Its three key buffers take 192 KB of a block's 227, so the
//     published leaf and syndrome go to global scratch beside σ
//     ([B][2][2][M], `words_g`, read after the sort's barriers from L2),
//     and only level n stays in shared memory (G = n − 1, 217,104 B a block
//     at every N).  Two key buffers (128 KB) would let G = n − 2, at one
//     more block barrier a sort stage; the sort is the larger share of a
//     fork, so the three stay.  2p + b reaches 131071: the trace entries
//     and σ fields are 32-bit (`ClusterEntry<4>`), and every kernel at
//     M <= 32768 keeps its 8- or 16-bit ones.
//
// Layout.  One warp decodes one frame and a block holds a few frames (over
// warps: one block a frame; on a cluster, one cluster a frame, each block
// with its own paths' rows).  Levels
// G+1..n of each path live in dynamic shared memory (in the byte-word
// layout with the trace indices); levels 1..G (the widest: levels 1 and 2
// alone hold three quarters of the rows, and are read at a handful of
// phases) live in a global scratch the wrapper allocates, with the trace
// LLRs, which are written once an info phase and read once at the end.
// Per frame in shared memory:
//   Ls  F     [M][(N>>G)-1]  LLR rows (float or double), one active node per level G+1..n−1
//                            (and an unused entry for level n)
//   Bs  u8    [M][(N>>G)-1]  partial-sum rows, levels G+1..n
//   TI  u8    [K][M]         byte words only: creation index 2p+b of each
//                            survivor per info phase
// and in global memory, per frame:
//   Lg  F     [M][N-(N>>G)]  LLR rows, levels 1..G
//   Bg  u8    [M][N-(N>>G)]  partial-sum rows, levels 1..G
//   TL  F     [K][M]         leaf LLR of each survivor's parent per info phase
//   TI  u8    [K][16|32]     by path: the trace indices, rows of M bytes
//                            padded to 16 (`round16(M)`)
// By path the trace indices are written from registers once an info phase,
// one byte a lane, and read only at the end: there the frame's shared
// memory, free of tree levels, takes a chunk of rows at a time as 16-byte
// words, and the walks back run in it.  In shared memory they were K·M
// bytes, 17% of the frame at P(128,64) M=32 and 128 KB of 172 KB at
// N=8192 M=32 (1 frame an SM, and K > 7259 refused).  Over warps a frame
// also holds its σ table, sort keys, leaf and syndrome (`deep_layout`), and
// the trace indices (K·M entries of T: 128 KB at P(128,64) M=1024) go to
// global scratch beside TL: with them there, the sort keys pushed K3's
// L=256 frame to G = 6, 17.4 ms at B=4096 on an H100, against 7.0 ms at the
// G = 2 the occupancy policy picks with them in global scratch
// (`tools/time_deep_lists.py`, `PERF.md`).  The wrapper picks the smallest
// G at which the occupancy calculator puts 16 frames on an SM (G=4 at
// N=2048 M=8: 13,280 B a frame); by path ceil(B / SMs) frames, at most what
// the registers allow (`__launch_bounds__` asks for 32 frames an SM: a
// B=4096 launch in one wave), and at a retry batch the lowest G.
// `ops/scl_cuda.py::check_shape` refuses a shape whose frame overfills a
// block even at G = n−1.
// A phase's schedule is one word, loaded a phase ahead.  Lanes split each
// level's M·(N>>l) f/g entries down to level n−1; lane m computes path m's
// leaf from its level-n−1 row and keeps it in a register (no phase but its
// own reads it), and takes the partial-sum chain's first step the same way.
// At an info phase (byte words) lane i < 2M holds candidate i = 2p+b; its
// rank in (metric, index) order is counted with shuffles, which is the
// stable sort of the plain version, and ranks < M survive (by path the
// in-warp sort above, over warps the block's).  Each path
// carries its CRC syndrome (the XOR of the 32-bit check columns of its set
// bits), so selection needs no walk; the selected path's trace is walked
// back by one lane, which records each info phase's slot, and all lanes
// then write the outputs.
//
// The full list (the scalar API's output, `decode_scl_cuda(..., full=True)`):
// the instantiation with LIST set also writes every path of the final list,
// in the plain version's final stable (metric, slot) order — its bits, info
// LLRs and metric (+inf for a path never reached) — and the selected rank.
// Lane m < M walks its own path's trace back, reading TI/TL only, before
// lane 0 rewrites slot 0 of the trace rows for the best path (by path, lane
// r walks the path of final rank r, chunk by chunk).  The sweeps
// launch the instantiation without LIST, whose code is unchanged.  Every σ
// layout has a LIST instantiation.
//
// The arithmetic is the plain version's, op for op, so results are equal bit
// for bit: f = sign(a)·sign(b)·min(|a|,|b|), g = b + (1−2c)·a, penalty
// max(x,0) + log1p(exp(−|x|)) with the accurate expf/log1pf (build without
// fast math and with -fmad=false).  Unreachable candidates carry 3e38.
//
// Float64 (JAX decodes float64 through its XLA decoder; the scalar entry
// points ask for it).  The byte-word and by-path bodies are templated on the
// LLRs' float type F: scl_decode_kernel<M, LIST, double> and
// scl_path_kernel<LM, LIST, double> (M 1..32 at N <= 8192) keep the LLR
// rows (Ls, Lg), the trace LLRs (TL), the metrics and the candidates in
// double, with the double penalty (accurate exp and log1p) and +inf for an
// unreachable candidate (`big<F>`: 3e38 would absorb only metrics below
// about 1.9e22 in double).  By path a fork's candidate is no longer one
// 64-bit word: a double metric fills 64 bits, so the key is the pair
// (metric, index), `DKey` in `list_decode.cuh`, compared as a pair and
// shuffled as three words by the same bitonic networks
// (`warp_sort_keys<PMAX, Key>`, `warp_sort_keys64<Key>`); ±0 compare
// equal, and the pads (+inf, all ones) sort after every candidate.  The
// float32 instantiations compile to the SASS they had
// (`tools/compare_sass.py`).  A double takes two registers: the float64
// instantiations' launch bounds ask for F64_MIN_BLOCKS = 4 blocks an SM
// (128 registers), and a frame's LLR rows twice the bytes, for which the
// host plans G (`launch_plan(..., 8)`).  Over warps the body is templated
// the same way: scl_deep_kernel<T, LIST, double> (M 33..1024 at N <= 8192)
// sorts the 2M pair keys with the block-wide network (`block_sort_keys<DKey>`,
// its cross-warp exchange through the metrics double[P] and the indices
// uint32[P] side by side), publishes a double leaf, and ranks the final
// double metrics; its frame (`deep_layout(..., 8)`) holds 12-byte keys and
// 8-byte rows and leaf.  On a cluster at one path a thread,
// scl_cluster_kernel<LIST, double> (M 1025..16384 at N <= 8192) is the
// cluster body with F double: the cluster sort on the pair keys
// (`cluster_sort_keys<DKey>`, three buffers of the metrics double[2048]
// beside the indices uint32[2048], 72 KB a block where float32's take 48,
// a partner's keys read through DSMEM as two loads), an 8-byte leaf
// published before the syndrome, and 8-byte rows (`cluster_layout(...,
// 8)`: 205,840 B a block at N = 8192, G = n − 1).  Its launch bound is the
// float32 one's, 1024 threads at 64 registers, so the doubles of the pair
// keys and metrics may spill (`PERF.md` §6 has its `-Xptxas -v` lines).
// Past M = 16384 (two and four paths a thread) and past N = 8192 the kernel
// is float32 only (the wrapper raises).

#include <cuda_runtime.h>
#include <stdint.h>

#include "list_decode.cuh"

#define SCL_BIG 3.0e38f
#define MAX_FRAMES_PER_BLOCK 4  // warps a block at most; `plan` picks how many
// blocks of MAX_FRAMES_PER_BLOCK warps an SM that the by-path launch bound
// asks registers for: 32 frames an SM at 64 registers a thread, which holds
// a B=4096 launch in one wave on 132 SMs
// (and to the wide twins' one more σ word: 62 registers best-only, 64 with
// LIST, no spill, as the others; `PERF.md`)
#define PATH_MIN_BLOCKS 8
// blocks an SM that the float64 instantiations' launch bounds ask registers
// for (byte words and by path): 4, so up to 128 registers a thread, where a
// double takes two (none spills: 65-106 registers, `PERF.md` §6)
#define F64_MIN_BLOCKS 4

// Which instantiation decodes a list size.  The default build sends M ∈ {1,
// 2, 4, 8} to the byte-word instantiations and every other M to the by-path
// one of width max(M rounded up to a power of two, SCL_LEAST_PATH_WIDTH = 8).
// On an H100 the byte words are faster at M 1, 2 and 4 (12-36% at P(128,64)
// B=4096); at M=8 the by-path layout with its in-warp sort is now the
// faster (0.3540 against 0.3630 ms at P(128,64), 6.76 against 7.83 ms at
// P(2048,1024)), and a by-path width of 4 saves M=3 about 3%
// (`tools/time_scl_layouts.py`, which builds with -DSCL_BY_PATH_ONLY=1 and
// -DSCL_LEAST_PATH_WIDTH=4 to time the layouts and widths against each
// other; `PERF.md`).  `ops/scl_cuda.py::path_width` and `BYTE_WORD_M`
// assume the default.
#ifndef SCL_BY_PATH_ONLY
#define SCL_BY_PATH_ONLY 0
#endif
#ifndef SCL_LEAST_PATH_WIDTH
#define SCL_LEAST_PATH_WIDTH 8
#endif
// Past n = 13 (N 16384..65536) M ∈ {2, 4, 8} go by path too, at LM = 8,
// whose σ words hold the 2n − 2 <= 30 fields: a byte-word frame keeps its
// trace (K·M bytes) in shared memory, 256 KB at P(65536,32768) M=8, past a
// block.  M=1 keeps the byte words: its trace of K bytes fits at every K.
// `tools/time_scl_layouts.py` builds with -DBYTE_WORD_MAX_LEVELS=16 to time
// the byte words at N=16384 against by path.
#ifndef BYTE_WORD_MAX_LEVELS
#define BYTE_WORD_MAX_LEVELS 13
#endif

namespace {

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// the float64 penalty: the same formula with the accurate double exp and log1p
__device__ __forceinline__ double softplus(double x) {
  return fmax(x, 0.0) + log1p(exp(-fabs(x)));
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
template <int M, typename SigT, typename F>
__device__ __forceinline__ void fg_pass(F* dst, const uint8_t* dbits, int dstride,
                                        const F* src, int sstride, SigT psig, bool is_g,
                                        int lh, int lane) {
  const int half = 1 << lh;
  const int total = M * half;
  for (int t = total < 32 ? lane & (total - 1) : lane; t < total; t += 32) {
    const int m = t >> lh;
    const int e = t & (half - 1);
    const F* row = src + sigma_row(psig, m) * sstride;
    const F a = row[e], b = row[e + half];
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

// F: float, or double (the float64 instantiations, N <= 8192)
template <int M, bool LIST, typename F>
__global__ void __launch_bounds__(32 * MAX_FRAMES_PER_BLOCK, sizeof(F) == 8 ? F64_MIN_BLOCKS : 8)
    scl_decode_kernel(
    const F* __restrict__ llr,            // [B, N]
    const int8_t* __restrict__ forced,    // [B, K] or null
    const uint32_t* __restrict__ hcols,   // [K] CRC check-matrix columns
    const int* __restrict__ sched,        // [N] phase words (scl_schedule.phase_words)
    F* glob_llr,                          // [B, M, N-(N>>G)], null when G == 0
    uint8_t* glob_bits,                   // [B, M, N-(N>>G)], null when G == 0
    F* trace_llr,                         // [B, K, M]
    int8_t* __restrict__ out_bits,        // [B, K]
    F* __restrict__ out_llrs,             // [B, K]
    uint8_t* __restrict__ out_pass,       // [B]
    int8_t* __restrict__ list_bits,       // [B, M, K], LIST only
    F* __restrict__ list_llrs,            // [B, M, K], LIST only
    F* __restrict__ list_metrics,         // [B, M], LIST only
    int* __restrict__ list_best,          // [B], LIST only
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
  F* Ls = reinterpret_cast<F*>(base);
  uint8_t* Bs = reinterpret_cast<uint8_t*>(Ls + M * SS);
  uint8_t* TI = Bs + M * SS;
  F* Lg = glob_llr + frame * M * SG;  // unused when G == 0
  uint8_t* Bg = glob_bits + frame * M * SG;
  F* TL = trace_llr + frame * K * M;
  const F* ch = llr + frame * N;
  const int8_t* plan = forced ? forced + frame * K : nullptr;
  // offset of level l (1..n) in a path's row: levels G+1..n in shared
  // memory, levels 1..G in global memory
  auto so = [&](int l) { return (N >> G) - (N >> (l - 1)); };
  auto go = [&](int l) { return N - (N >> (l - 1)); };

  SigT sig = Sigma<M>::kIdentity;   // lane r < 2n−1: σ of row r
  F pm = (lane == 0) ? F(0) : big<F>();  // lane m < M: metric of path m
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
    F leaf = 0;
    if (lane < M) {
      const int r = sigma_row(lsig, lane);
      const F* row = n == 1 ? ch : n - 1 > G ? Ls + so(n - 1) + r * SS : Lg + go(n - 1) + r * SG;
      leaf = g_leaf ? g_update(row[0], row[1], Bs[lane * SS + so(n)]) : f_minsum(row[0], row[1]);
    }

    // ---- leaf decision: extend every path, or fork and keep the best M ----
    int bit = 0;  // lane m < M: the new bit of path m
    if (is_frozen) {
      if (lane < M) pm = pm + softplus(-leaf);
    } else {
      const int cb = lane & 1;
      const int cp = (lane >> 1) & (M - 1);
      const F lp = __shfl_sync(FULL_MASK, leaf, cp);
      const F pp = __shfl_sync(FULL_MASK, pm, cp);
      F c = pp + softplus(cb ? lp : -lp);
      if (fb != -1 && fb != cb) c = big<F>();
      int rank = 0;
#pragma unroll
      for (int j = 0; j < 2 * M; ++j) {
        const F cj = __shfl_sync(FULL_MASK, c, j);
        rank += (cj < c) || (cj == c && j < lane);
      }
      // the candidate ranked m goes to trace slot m: the survivors' creation
      // indices 2p+b, in order
      uint8_t* row = TI + info_i * M;
      if (lane < 2 * M && rank < M) row[rank] = (uint8_t)lane;
      __syncwarp();
      const int w = lane < M ? row[lane] : 0;
      const F new_pm = __shfl_sync(FULL_MASK, c, w);
      const int parent = w >> 1;
      const F leaf_par = __shfl_sync(FULL_MASK, leaf, parent);
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
    const F pj = __shfl_sync(FULL_MASK, pm, j);
    frank += (pj < pm) || (pj == pm && j < lane);
  }
  const bool ok = use_crc && lane < M && syn == 0u && pm < big<F>();
  const unsigned ok_ranks = __reduce_or_sync(FULL_MASK, ok ? (1u << frank) : 0u);
  const int sel_rank = ok_ranks ? __ffs(ok_ranks) - 1 : 0;
  const unsigned who = __ballot_sync(FULL_MASK, lane < M && frank == sel_rank);
  if (LIST) {
    // every path into row frank of the list, before the trace is rewritten
    if (lane < M) {
      const long long o = (frame * M + frank) * K;
      int slot = lane;
      for (int i = K - 1; i >= 0; --i) {
        const int w = TI[i * M + slot];
        list_bits[o + i] = (int8_t)(w & 1);
        list_llrs[o + i] = TL[i * M + slot];
        slot = w >> 1;
      }
      list_metrics[frame * M + frank] = pm < big<F>() ? pm : inf_of(pm);
    }
    if (lane == 0) list_best[frame] = sel_rank;
    __syncwarp();
  }
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

// ---------------------------------------------------------------------------
// The by-path instantiation: list sizes 1..32 outside {1, 2, 4, 8}.
// ---------------------------------------------------------------------------

// A fork's selection, by path: the 2M candidates (lane p < M holds
// candidate 2p, bit 0, at metric c0 and 2p + 1 at c1) as unique 64-bit keys
// (`cand_key`), padded with all-ones keys, sorted by an in-warp bitonic
// network.  Returns, in lane m, the key of rank m.  Up to LM = 16 the P =
// sort_keys(M) <= 32 keys go one a lane (lane q < M: candidate 2q; lane M + p:
// candidate 2p + 1, its metric shuffled from lane p), and only the stages of
// P run; at LM = 32, two a lane (`warp_sort_keys64`).  In float64 the keys
// are (metric, index) pairs (`DKey`), the pads (+inf, all ones).
template <int LM, typename F>
__device__ __forceinline__ auto path_select(F c0, F c1, int M, int P, int lane) {
  if constexpr (LM <= 16) {
    const bool odd = lane >= M;
    const int p = odd ? lane - M : lane;
    const F c1p = __shfl_sync(FULL_MASK, c1, p);
    const auto k = lane < 2 * M ? cand_key(odd ? c1p : c0, 2 * p + odd) : pad_key(c0);
    return warp_sort_keys<2 * LM>(k, lane, P);
  } else {
    const bool on = lane < M;
    return warp_sort_keys64(on ? cand_key(c0, 2 * lane) : pad_key(c0),
                            on ? cand_key(c1, 2 * lane + 1) : pad_key(c0), lane);
  }
}

// The SCL decode with σ kept by path: lane m < M holds path m's metric,
// syndrome and σ, and its two candidates 2m and 2m+1.  It computes what
// scl_decode_kernel computes, at a runtime list size M <= LM.  The trace
// indices live in global scratch, rows of round16(M) bytes; at the end the
// frame's shared memory, free of tree levels, takes them a chunk of rows at
// a time for the walks back.  The body of scl_path_kernel (σ in
// PathSigma<LM>'s words: n <= 13 at LM 16 and 32) and of
// scl_path_wide_kernel (WIDE: one more word, n 14..16); the kernels' pointer
// arguments carry the __restrict__ qualifiers.
template <int LM, bool LIST, bool WIDE, typename F, typename Masks>
__device__ __forceinline__ void scl_path_decode(
    const F* llr, const int8_t* forced, const uint32_t* hcols, const int* sched,
    F* glob_llr, uint8_t* glob_bits, F* trace_llr,
    uint8_t* trace_idx,  // [B, K, round16(M)]: the trace indices, in global scratch
    int8_t* out_bits, F* out_llrs, uint8_t* out_pass, int8_t* list_bits, F* list_llrs,
    F* list_metrics, int* list_best, int B, int N, int n, int K, int M, int G, int use_crc,
    int frame_bytes, int frames_per_block, const Masks& masks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long frame = (long long)blockIdx.x * frames_per_block + warp;
  if (frame >= B) return;  // whole warp leaves; the kernel has no block barrier

  const int SS = (N >> G) - 1;  // entries of a path's row in shared memory
  const int SG = N - (N >> G);  // entries of a path's row in global memory
  const int TW = round16(M);    // bytes of a trace-index row
  const int P = sort_keys(M);   // keys a fork sorts
  unsigned char* base = smem + (size_t)warp * frame_bytes;
  F* Ls = reinterpret_cast<F*>(base);
  uint8_t* Bs = reinterpret_cast<uint8_t*>(Ls + M * SS);
  F* Lg = glob_llr + frame * M * SG;  // unused when G == 0
  uint8_t* Bg = glob_bits + frame * M * SG;
  F* TL = trace_llr + frame * K * M;
  uint8_t* TI = trace_idx + frame * K * TW;
  const F* ch = llr + frame * N;
  const int8_t* plan = forced ? forced + frame * K : nullptr;
  auto so = [&](int l) { return (N >> G) - (N >> (l - 1)); };
  auto go = [&](int l) { return N - (N >> (l - 1)); };

  const unsigned sig_id = PathSigma<LM, WIDE>::identity(lane);
  PathSigma<LM, WIDE> sig;  // lane m < M: σ of path m
  sig.init(sig_id);
  F pm = (lane == 0) ? F(0) : big<F>();  // lane m < M: metric of path m
  uint32_t syn = 0;                       // lane m < M: CRC syndrome of path m
  int info_i = 0;
  int word = sched[0];
  int s_prev = 0;  // the previous phase's store level
  for (int p = 0; p < N; ++p) {
    const int next_word = p + 1 < N ? sched[p + 1] : 0;
    const int gl = word & 31;
    const int is_frozen = word >> 10 & 1;
    int fb = -1;
    uint32_t hc = 0;
    if (!is_frozen) {
      if (plan) fb = plan[info_i];
      if (use_crc) hc = hcols[info_i];
    }
    const int l0 = p == 0 ? 1 : gl;
    {
      // σ back to identity on the levels rewritten since the last fork: the
      // bit level the previous phase's chain stored, and the LLR levels
      // l0..n−1 this phase's descent writes (`csrc/pac_decode.cu` has why
      // no read through σ falls between those writes and this point)
      unsigned r[PathSigma<LM, WIDE>::kWords];
#pragma unroll
      for (int k = 0; k < PathSigma<LM, WIDE>::kWords; ++k) r[k] = masks.llr[l0][k] | masks.bit[s_prev][k];
      sig.reset(r, sig_id);
    }

    // ---- f/g updates down to level n−1 ----
    for (int l = l0; l < n; ++l) {
      const bool is_g = (p != 0) && (l == gl);
      const bool via = is_g && l > 1 && (word >> 11 & 1);
      const int own = via ? sig.get(l - 2) : 0;
      if (l > G + 1) {
        path_fg_pass(Ls + so(l), Bs + so(l), SS, Ls + so(l - 1), SS, via, own, is_g, n - l, M,
                     lane);
      } else {  // the few passes that touch global memory: generic pointers
        const bool sh = l > G;
        path_fg_pass(sh ? Ls + so(l) : Lg + go(l), sh ? Bs + so(l) : Bg + go(l), sh ? SS : SG,
                     l > 1 ? Lg + go(l - 1) : ch, l > 1 ? SG : 0, via, own, is_g, n - l, M, lane);
      }
      __syncwarp();
    }
    // the leaf (level n): lane m computes it from its parent row
    const bool g_leaf = gl == n;
    F leaf = 0;
    if (lane < M) {
      const int r = (g_leaf && n > 1 && (word >> 11 & 1)) ? sig.get(n - 2) : lane;
      const F* row = n == 1 ? ch : n - 1 > G ? Ls + so(n - 1) + r * SS : Lg + go(n - 1) + r * SG;
      leaf = g_leaf ? g_update(row[0], row[1], Bs[lane * SS + so(n)]) : f_minsum(row[0], row[1]);
    }

    // ---- leaf decision: extend every path, or fork and keep the best M ----
    int bit = 0;
    if (is_frozen) {
      if (lane < M) pm = pm + softplus(-leaf);
    } else {
      F c0 = pm + softplus(-leaf), c1 = pm + softplus(leaf);
      if (fb == 1) c0 = big<F>();
      if (fb == 0) c1 = big<F>();
      // survivor m: the candidate of rank m, into trace slot m, its metric
      // back from the key
      const auto key = path_select<LM>(c0, c1, M, P, lane);
      const int w = lane < M ? key_index(key) : 0;
      const int parent = w >> 1;
      const F leaf_par = __shfl_sync(FULL_MASK, leaf, parent);
      const uint32_t syn_par = __shfl_sync(FULL_MASK, syn, parent);
      if (lane < M) {
        bit = w & 1;
        pm = key_metric(key);
        TI[info_i * TW + lane] = (uint8_t)w;
        TL[info_i * M + lane] = leaf_par;
        syn = bit ? syn_par ^ hc : syn_par;
      }
      sig.fork(parent);  // σ ← σ[parent] on every level
      ++info_i;
    }

    // ---- partial-sum chain ----
    const int s = word >> 5 & 31;
    if (s > 0) {
      const int cmask = word >> 11;  // bit l: level l's left bits through σ
      if (lane < M) {
        uint8_t* cur = s > G ? Bs + lane * SS + so(s) : Bg + lane * SG + go(s);
        if (s == n) {
          cur[0] = (uint8_t)bit;
        } else {
          const int r = (cmask >> n & 1) ? sig.get(2 * n - 3) : lane;
          const uint8_t left = Bs[r * SS + so(n)];
          cur[1] = (uint8_t)bit;
          cur[0] = (uint8_t)(left ^ bit);
        }
      }
      __syncwarp();
      for (int lv = n - 1; lv > s; --lv) {
        const bool via = cmask >> lv & 1;
        const int own = via ? sig.get(n + lv - 3) : 0;
        if (s > G)
          path_chain_pass(Bs + so(s), SS, Bs + so(lv), SS, via, own, n - lv, M, lane);
        else
          path_chain_pass(Bg + go(s), SG, lv > G ? Bs + so(lv) : Bg + go(lv), lv > G ? SS : SG,
                          via, own, n - lv, M, lane);
        __syncwarp();
      }
    }
    s_prev = s;
    word = next_word;
  }

  // ---- final stable sort of the list, CRC selection, backtrack ----
  // lane r < M: the key (metric, path) of final rank r
  const auto fkey = warp_sort_keys<LM>(lane < M ? cand_key(pm, lane) : pad_key(pm), lane, P / 2);
  const int path_r = lane < M ? key_index(fkey) : 0;
  const bool ok = use_crc && syn == 0u && pm < big<F>();  // of path `lane`
  const bool ok_r = __shfl_sync(FULL_MASK, (int)ok, path_r);
  const unsigned ok_ranks = __ballot_sync(FULL_MASK, lane < M && ok_r);
  const int sel_rank = ok_ranks ? __ffs(ok_ranks) - 1 : 0;
  int best = __shfl_sync(FULL_MASK, path_r, sel_rank);  // lane 0's walk: the selected path
  int slot = path_r;                                       // lane r's walk (LIST): path of rank r
  if (LIST) {
    if (lane < M) {
      const F mr = key_metric(fkey);
      list_metrics[frame * M + lane] = mr < big<F>() ? mr : inf_of(mr);
    }
    if (lane == 0) list_best[frame] = sel_rank;
  }
  if (lane == 0) out_pass[frame] = ok_ranks ? 1 : 0;
  // the walks back, over chunks of trace rows copied into the frame's shared
  // memory (16-byte rows apart, R >= 1 rows: frame_bytes >= round16(5·M))
  uint8_t* TIs = base;
  const int R = frame_bytes / TW;
  for (int hi = K - 1; hi >= 0; hi -= R) {
    const int lo = hi - R + 1 > 0 ? hi - R + 1 : 0;
    __syncwarp();  // the tree's (or the previous chunk's) last reads are done
    const uint4* src = reinterpret_cast<const uint4*>(TI + lo * TW);
    uint4* dst = reinterpret_cast<uint4*>(TIs);
    for (int v = lane; v < (hi - lo + 1) * TW / 16; v += 32) dst[v] = src[v];
    __syncwarp();
    if (LIST) {
      // every path into row r of the list, before lane 0 rewrites slot 0
      if (lane < M) {
        const long long o = (frame * M + lane) * K;
        for (int i = hi; i >= lo; --i) {
          const int w = TIs[(i - lo) * TW + slot];
          list_bits[o + i] = (int8_t)(w & 1);
          list_llrs[o + i] = TL[i * M + slot];
          slot = w >> 1;
        }
      }
      __syncwarp();
    }
    if (lane == 0) {
      // the selected path's (slot << 1 | bit) into slot 0 of each row; row i
      // is read before it is overwritten, and later steps read rows below i
      for (int i = hi; i >= lo; --i) {
        uint8_t* row = TIs + (i - lo) * TW;
        const int w = row[best];
        row[0] = (uint8_t)((best << 1) | (w & 1));
        best = w >> 1;
      }
    }
    __syncwarp();
    for (int i = lo + lane; i <= hi; i += 32) {
      const int r = TIs[(i - lo) * TW];
      out_bits[frame * K + i] = (int8_t)(r & 1);
      out_llrs[frame * K + i] = TL[i * M + (r >> 1)];
    }
  }
}

#define SCL_PATH_PARAMS(F)                                                                       \
  const F* __restrict__ llr, const int8_t* __restrict__ forced,                                  \
      const uint32_t* __restrict__ hcols, const int* __restrict__ sched, F* glob_llr,            \
      uint8_t* glob_bits, F* trace_llr, uint8_t* trace_idx, int8_t* __restrict__ out_bits,       \
      F* __restrict__ out_llrs, uint8_t* __restrict__ out_pass,                                  \
      int8_t* __restrict__ list_bits, F* __restrict__ list_llrs,                                 \
      F* __restrict__ list_metrics, int* __restrict__ list_best, int B, int N, int n, int K,     \
      int M, int G, int use_crc, int frame_bytes, int frames_per_block
#define SCL_PATH_ARGS                                                                           \
  llr, forced, hcols, sched, glob_llr, glob_bits, trace_llr, trace_idx, out_bits, out_llrs,     \
      out_pass, list_bits, list_llrs, list_metrics, list_best, B, N, n, K, M, G, use_crc,       \
      frame_bytes, frames_per_block, masks

// F: float, or double (the float64 instantiations, N <= 8192)
template <int LM, bool LIST, typename F>
__global__ void __launch_bounds__(32 * MAX_FRAMES_PER_BLOCK, sizeof(F) == 8 ? F64_MIN_BLOCKS : PATH_MIN_BLOCKS)
    scl_path_kernel(SCL_PATH_PARAMS(F), const ResetMasks masks) {
  scl_path_decode<LM, LIST, false, F>(SCL_PATH_ARGS);
}

// LM 16 and 32 at N 16384..65536: σ in one more word (float32)
template <int LM, bool LIST>
__global__ void __launch_bounds__(32 * MAX_FRAMES_PER_BLOCK, PATH_MIN_BLOCKS)
    scl_path_wide_kernel(SCL_PATH_PARAMS(float), const WideResetMasks masks) {
  scl_path_decode<LM, LIST, true, float>(SCL_PATH_ARGS);
}

// ---------------------------------------------------------------------------
// Over warps: list sizes 33..1024, one frame a block, one thread a path.
// ---------------------------------------------------------------------------

// The SCL decode with a frame spread over the warps of a block:
// thread m < M holds path m's metric and syndrome and its two candidates 2m
// and 2m+1; σ is a table in shared memory (`DeepSigma`), and each exchange
// between paths is a shared-memory write, a block barrier and a read.  T is
// the width of a trace entry and a σ field, F the LLRs' float type (float,
// or double at N <= 8192: the sort then runs on the pair keys).  It
// computes what scl_decode_kernel computes.  The body of scl_deep_kernel (σ rows of
// DEEP_SIGMA_WORDS words at most: n <= 13 at 16-bit fields) and of
// scl_deep_wide_kernel (WORDS = DEEP_WIDE_SIGMA_WORDS: n 14..16).
template <typename T, bool LIST, int WORDS, typename F>
__device__ __forceinline__ void scl_deep_decode(
    const F* llr, const int8_t* forced, const uint32_t* hcols, const int* sched,
    F* glob_llr, uint8_t* glob_bits, F* trace_llr,
    T* trace_idx,  // [B, K, M]: the trace indices, in global scratch
    int8_t* out_bits, F* out_llrs, uint8_t* out_pass, int8_t* list_bits, F* list_llrs,
    F* list_metrics, int* list_best, int N, int n, int K, int M, int G, int use_crc) {
  using Key = KeyOf<F>;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long frame = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool act = tid < M;  // thread m < M: path m

  const DeepLayout lay = deep_layout(N, n, M, G, sizeof(T), 2, sizeof(F));
  const int SS = (N >> G) - 1;
  const int SG = N - (N >> G);
  DeepSigma<T, WORDS> sig{reinterpret_cast<T*>(smem + lay.sig), lay.sig_row / (int)sizeof(T),
                   lay.sig_row / 4};
  unsigned char* keys = smem + lay.keys;
  F* Ls = reinterpret_cast<F*>(smem + lay.ls);
  F* leafS = reinterpret_cast<F*>(smem + lay.words);
  uint32_t* synS = reinterpret_cast<uint32_t*>(smem + lay.words + round16((int)sizeof(F) * M));
  uint8_t* Bs = smem + lay.bs;
  T* TI = trace_idx + frame * K * M;
  int* selS = reinterpret_cast<int*>(smem + lay.sel);
  F* Lg = glob_llr + frame * M * SG;  // unused when G == 0
  uint8_t* Bg = glob_bits + frame * M * SG;
  F* TL = trace_llr + frame * K * M;
  const F* ch = llr + frame * N;
  const int8_t* plan = forced ? forced + frame * K : nullptr;
  auto so = [&](int l) { return (N >> G) - (N >> (l - 1)); };
  auto go = [&](int l) { return N - (N >> (l - 1)); };

  if (act) sig.init(tid, tid, 2 * n - 2);
  __syncthreads();
  F pm = (tid == 0) ? F(0) : big<F>();  // thread m < M: metric of path m
  uint32_t syn = 0;                        // thread m < M: CRC syndrome of path m
  int info_i = 0;
  int word = sched[0];
  int s_prev = 0;  // the previous phase's store level
  for (int p = 0; p < N; ++p) {
    const int next_word = p + 1 < N ? sched[p + 1] : 0;
    const int gl = word & 31;
    const int is_frozen = word >> 10 & 1;
    int fb = -1;
    uint32_t hc = 0;
    if (!is_frozen) {
      if (plan) fb = plan[info_i];
      if (use_crc) hc = hcols[info_i];
    }
    const int l0 = p == 0 ? 1 : gl;
    // σ back to identity on the levels rewritten since the last fork, in
    // the thread's own row (as scl_path_kernel); no other thread reads
    // these fields before the next barrier
    if (act) sig.reset(tid, tid, l0 - 1, n - 1, s_prev >= 2 ? n + s_prev - 3 : -1);

    // ---- f/g updates down to level n−1 ----
    for (int l = l0; l < n; ++l) {
      const bool is_g = (p != 0) && (l == gl);
      const T* via = (is_g && l > 1 && (word >> 11 & 1)) ? sig.field(l - 2) : nullptr;
      if (l > G + 1) {
        block_fg_pass(Ls + so(l), Bs + so(l), SS, Ls + so(l - 1), SS, via, sig.row, is_g, n - l, M,
                      tid, nt);
      } else {  // the few passes that touch global memory: generic pointers
        const bool sh = l > G;
        block_fg_pass(sh ? Ls + so(l) : Lg + go(l), sh ? Bs + so(l) : Bg + go(l), sh ? SS : SG,
                      l > 1 ? Lg + go(l - 1) : ch, l > 1 ? SG : 0, via, sig.row, is_g, n - l, M,
                      tid, nt);
      }
      __syncthreads();
    }
    // the leaf (level n): thread m computes it from its parent row
    const bool g_leaf = gl == n;
    F leaf = 0;
    if (act) {
      const int r = (g_leaf && n > 1 && (word >> 11 & 1)) ? sig.get(tid, n - 2) : tid;
      const F* row = n == 1 ? ch : n - 1 > G ? Ls + so(n - 1) + r * SS : Lg + go(n - 1) + r * SG;
      leaf = g_leaf ? g_update(row[0], row[1], Bs[tid * SS + so(n)]) : f_minsum(row[0], row[1]);
    }

    // ---- leaf decision: extend every path, or fork and keep the best M ----
    int bit = 0;
    if (is_frozen) {
      if (act) pm = pm + softplus(-leaf);
    } else {
      F c0 = pm + softplus(-leaf), c1 = pm + softplus(leaf);
      if (fb == 1) c0 = big<F>();
      if (fb == 0) c1 = big<F>();
      if (act) {
        leafS[tid] = leaf;
        synS[tid] = syn;
      }
      // thread m's keys: candidates 2m and 2m+1 (pads from M on)
      block_sort_keys(keys, act ? cand_key(c0, 2 * tid) : pad_key(c0),
                      act ? cand_key(c1, 2 * tid + 1) : pad_key(c0), sort_keys(M), tid);
      __syncthreads();
      // survivor m: the candidate of rank m, into trace slot m
      int parent = 0;
      if (act) {
        const Key key = key_at<Key>(keys, sort_keys(M), tid);
        const int w = key_index(key);
        TI[info_i * M + tid] = (T)w;
        parent = w >> 1;
        bit = w & 1;
        pm = key_metric(key);
        TL[info_i * M + tid] = leafS[parent];
        syn = bit ? synS[parent] ^ hc : synS[parent];
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
          cur[0] = (uint8_t)bit;
        } else {
          const int r = (cmask >> n & 1) ? sig.get(tid, 2 * n - 3) : tid;
          const uint8_t left = Bs[r * SS + so(n)];
          cur[1] = (uint8_t)bit;
          cur[0] = (uint8_t)(left ^ bit);
        }
      }
      __syncthreads();
      for (int lv = n - 1; lv > s; --lv) {
        const T* via = (cmask >> lv & 1) ? sig.field(n + lv - 3) : nullptr;
        if (s > G)
          block_chain_pass(Bs + so(s), SS, Bs + so(lv), SS, via, sig.row, n - lv, M, tid, nt);
        else
          block_chain_pass(Bg + go(s), SG, lv > G ? Bs + so(lv) : Bg + go(lv), lv > G ? SS : SG,
                           via, sig.row, n - lv, M, tid, nt);
        __syncthreads();
      }
    }
    s_prev = s;
    word = next_word;
  }

  // ---- final stable sort of the list, CRC selection, backtrack ----
  F* metric = reinterpret_cast<F*>(keys);
  if (act) metric[tid] = pm;
  if (tid == 0) *selS = M;
  __syncthreads();
  int least;
  const bool ok = use_crc && act && syn == 0u && pm < big<F>();
  const int frank = final_rank(metric, M, tid, pm, ok, selS, &least);
  const int sel_rank = least < M ? least : 0;
  if (LIST) {
    if (act) {
      const long long o = (frame * M + frank) * K;
      int slot = tid;
      for (int i = K - 1; i >= 0; --i) {
        const int w = TI[i * M + slot];
        list_bits[o + i] = (int8_t)(w & 1);
        list_llrs[o + i] = TL[i * M + slot];
        slot = w >> 1;
      }
      list_metrics[frame * M + frank] = pm < big<F>() ? pm : inf_of(pm);
    }
    if (tid == 0) list_best[frame] = sel_rank;
    __syncthreads();
  }
  if (act && frank == sel_rank) {
    // the selected path's (slot << 1 | bit) into slot 0 of each trace row
    int slot = tid;
    for (int i = K - 1; i >= 0; --i) {
      const int w = TI[i * M + slot];
      TI[i * M] = (T)((slot << 1) | (w & 1));
      slot = w >> 1;
    }
    out_pass[frame] = least < M ? 1 : 0;
  }
  __syncthreads();
  for (int i = tid; i < K; i += nt) {
    const int r = TI[i * M];
    out_bits[frame * K + i] = (int8_t)(r & 1);
    out_llrs[frame * K + i] = TL[i * M + (r >> 1)];
  }
}

#define SCL_DEEP_PARAMS(T, F)                                                                    \
  const F* __restrict__ llr, const int8_t* __restrict__ forced,                                  \
      const uint32_t* __restrict__ hcols, const int* __restrict__ sched, F* glob_llr,            \
      uint8_t* glob_bits, F* trace_llr, T* trace_idx, int8_t* __restrict__ out_bits,             \
      F* __restrict__ out_llrs, uint8_t* __restrict__ out_pass,                                  \
      int8_t* __restrict__ list_bits, F* __restrict__ list_llrs,                                 \
      F* __restrict__ list_metrics, int* __restrict__ list_best, int N, int n, int K, int M, \
      int G, int use_crc
#define SCL_DEEP_ARGS                                                                            \
  llr, forced, hcols, sched, glob_llr, glob_bits, trace_llr, trace_idx, out_bits, out_llrs,      \
      out_pass, list_bits, list_llrs, list_metrics, list_best, N, n, K, M, G, use_crc

// F: float, or double (the float64 instantiations, N <= 8192)
template <typename T, bool LIST, typename F>
__global__ void __launch_bounds__(DEEP_MAX_M)
    scl_deep_kernel(SCL_DEEP_PARAMS(T, F)) {
  scl_deep_decode<T, LIST, DEEP_SIGMA_WORDS, F>(SCL_DEEP_ARGS);
}

// 16-bit entries (M 129..1024) at N 16384..65536: σ rows of up to 15 words (float32)
template <bool LIST>
__global__ void __launch_bounds__(DEEP_MAX_M) scl_deep_wide_kernel(SCL_DEEP_PARAMS(uint16_t, float)) {
  scl_deep_decode<uint16_t, LIST, DEEP_WIDE_SIGMA_WORDS, float>(SCL_DEEP_ARGS);
}

// ---------------------------------------------------------------------------
// Over a cluster: list sizes 1025..65536, one frame a cluster of blocks.
// ---------------------------------------------------------------------------

// The SCL decode with a frame spread over a cluster of C = cluster_blocks(M)
// blocks of 1024 threads (`list_decode.cuh` has the layout and the
// barriers), each thread holding PPT paths (1 up to M = 16384, 2 up to
// 32768, 4 above):
// path m = r·1024·PPT + k·1024 + tid of rank r (k < PPT) has its metric and
// syndrome in thread tid's registers, and its candidates 2m and 2m+1 among
// the thread's sort keys.  Tree levels G+1..n of the block's paths are in
// its shared memory, levels 1..G of every path in global scratch, and each
// block runs the f/g and chain passes of its own paths: a read through σ
// takes the path's field from the block's own rows of σ, and its tree row,
// which may be another block's, through DSMEM (a shared level) or from L2
// (a global one).  A fork publishes each path's leaf and syndrome (one of
// two sets by the info phase's parity), sorts the 2M candidates over the
// cluster, and takes the parent's words and σ row (through DSMEM; past one
// path a thread σ is in global scratch, `sigma_g`, and the row comes from
// L2, and at four the words too, `words_g`).  A phase that read another path's row through σ ends with a split
// cluster barrier, waited for before the next phase's passes.  The final
// rank is the cluster sort of the M keys (metric, m); the thread of path m
// takes the key of rank m, and the selected rank, the least of those whose
// path passes the CRC, is an atomicMin on rank 0's shared word through
// DSMEM.  It computes what scl_decode_kernel computes.  F: the LLRs' float
// type (double at one path a thread: rows, leaf and metrics in double, the
// sort on the pair keys).
template <bool LIST, int PPT, typename F>
__device__ __forceinline__ void scl_cluster_decode(
    const F* __restrict__ llr, const int8_t* __restrict__ forced,
    const uint32_t* __restrict__ hcols, const int* __restrict__ sched,
    F* glob_llr,        // [B, M, N-(N>>G)]: LLR levels 1..G, null when G == 0
    uint8_t* glob_bits, // [B, M, N-(N>>G)]: partial-sum levels 1..G
    F* trace_llr,       // [B, K, M]
    ClusterEntry<PPT>* trace_idx,  // [B, K, M]
    int8_t* __restrict__ out_bits, F* __restrict__ out_llrs, uint8_t* __restrict__ out_pass,
    int8_t* __restrict__ list_bits, F* __restrict__ list_llrs, F* __restrict__ list_metrics,
    int* __restrict__ list_best, int N, int n, int K, int M, int G, int use_crc,
    ClusterEntry<PPT>* sigma_g,  // [B, 2, M, row]: σ's two tables past one path a thread, else null
    uint32_t* words_g) {  // [B, 2, 2, M]: the published word sets at four paths a thread, else null
  using Off = ClusterOff<PPT>;
  using E = ClusterEntry<PPT>;  // a σ field and a trace entry
  using Key = KeyOf<F>;
  constexpr int PATHS = CLUSTER_THREADS * PPT;  // paths a block
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long frame = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int base = rank * PATHS;  // the block's first path
  int m[PPT];                     // this thread's paths
  bool act[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    m[k] = base + k * CLUSTER_THREADS + tid;
    act[k] = m[k] < M;
  }
  const int Mr = M - base < 0 ? 0 : M - base < PATHS ? M - base : PATHS;
  const int P = sort_keys(M);

  const ClusterLayout lay = cluster_layout<PPT>(N, n, G, 2, sizeof(F));
  const int SS = (N >> G) - 1;  // entries of a path's shared row: levels G+1..n
  const int SG = N - (N >> G);  // entries of a path's global row: levels 1..G
  // σ after i forks: table i & 1 (the other is the next fork's target),
  // from the block's first path's row
  auto sigma = [&](int i) {
    if constexpr (PPT == 1)
      return DeepSigma<E>{reinterpret_cast<E*>(smem + (i & 1) * lay.sig2), lay.sig_row / 2, lay.sig_row / 4};
    else
      return DeepSigma<E>{sigma_g + ((frame * 2 + (i & 1)) * M + base) * (lay.sig_row / (int)sizeof(E)),
                          lay.sig_row / (int)sizeof(E), lay.sig_row / 4};
  };
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + lay.keys);
  F* Ls = reinterpret_cast<F*>(smem + lay.ls);
  uint8_t* Bs = smem + lay.bs;
  int* selS = reinterpret_cast<int*>(smem + lay.sel);
  F* Lg = glob_llr + frame * M * SG;  // unused when G == 0
  uint8_t* Bg = glob_bits + frame * M * SG;
  F* TL = trace_llr + frame * K * M;
  E* TI = trace_idx + frame * K * M;
  const F* ch = llr + frame * N;
  const int8_t* plan = forced ? forced + frame * K : nullptr;
  auto so = [&](int l) { return (N >> G) - (N >> (l - 1)); };
  auto go = [&](int l) { return N - (N >> (l - 1)); };
  // levels 1..G in global scratch: a path's row of SG entries up to two
  // paths a thread; at four, by level ([G][M][N >> l]), so that the narrow
  // levels a phase reads are a few contiguous kilobytes a block, where a
  // path's row put each of them in a 32-byte sector of its own.  glev(g,
  // l): level l's first row; gw(l): a row's entries
  constexpr bool BY_LEVEL = PPT >= 4;
  auto glev = [&](auto* g, int l) { return g + (Off)M * go(l); };
  auto gw = [&](int l) { return BY_LEVEL ? N >> l : SG; };
  // the published leaf and syndrome of set i (an info phase's parity), from
  // the block's first path: in shared memory (the leaves of F, then the
  // syndromes), or at four paths a thread in global scratch
  auto leafS = [&](int i) {
    if constexpr (words_global<PPT>())
      return reinterpret_cast<F*>(words_g + (frame * 2 + i) * 2 * M + base);
    else
      return reinterpret_cast<F*>(smem + lay.words + i * lay.word_set);
  };
  auto synS = [&](int i) {
    if constexpr (words_global<PPT>())
      return words_g + ((frame * 2 + i) * 2 + 1) * M + base;
    else
      return reinterpret_cast<uint32_t*>(smem + lay.words + i * lay.word_set + (int)sizeof(F) * PATHS);
  };
  // path p's entry of a published array whose block-local start is `own`:
  // another block's through DSMEM, or from L2 (written before the sort's
  // cluster barriers)
  auto published = [&](auto* own, int p) {
    if constexpr (words_global<PPT>())
      return __ldcg(own - base + p);
    else
      return *path_entry<PPT>(own, p);
  };

#pragma unroll
  for (int k = 0; k < PPT; ++k)
    if (act[k]) sigma(0).init(k * CLUSTER_THREADS + tid, m[k], 2 * n - 2);
  if (m[0] == 0) *selS = M;
  __syncthreads();
  F pm[PPT];          // metric of path m[k]
  uint32_t syn[PPT];  // CRC syndrome of path m[k]
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    pm[k] = (m[k] == 0) ? F(0) : big<F>();
    syn[k] = 0;
  }
  int info_i = 0;
  bool pending = false;   // a split cluster barrier arrived at, not yet waited for
  int word = sched[0];
  int s_prev = 0;
  for (int p = 0; p < N; ++p) {
    const int next_word = p + 1 < N ? sched[p + 1] : 0;
    const int gl = word & 31;
    const int is_frozen = word >> 10 & 1;
    int fb = -1;
    uint32_t hc = 0;
    if (!is_frozen) {
      if (plan) fb = plan[info_i];
      if (use_crc) hc = hcols[info_i];
    }
    const int l0 = p == 0 ? 1 : gl;
    DeepSigma<E> sig = sigma(info_i);
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      if (act[k]) sig.reset(k * CLUSTER_THREADS + tid, m[k], l0 - 1, n - 1, s_prev >= 2 ? n + s_prev - 3 : -1);
    // another block may still read the rows this phase rewrites
    if (pending) cluster_wait();
    pending = false;

    // ---- f/g updates down to level n−1, this block's paths ----
    for (int l = l0; l < n; ++l) {
      const bool is_g = (p != 0) && (l == gl);
      const E* via = (is_g && l > 1 && (word >> 11 & 1)) ? sig.field(l - 2) : nullptr;
      F* dst = l > G ? Ls + so(l) : BY_LEVEL ? glev(Lg, l) + (Off)base * gw(l) : Lg + (Off)base * SG + go(l);
      const uint8_t* dbits = l > G ? Bs + so(l)
                                   : BY_LEVEL ? glev(Bg, l) + (Off)base * gw(l) : Bg + (Off)base * SG + go(l);
      const int ds = l > G ? SS : gw(l);
      if (l - 1 > G)
        cluster_fg_pass<true, PPT>(dst, dbits, ds, Ls + so(l - 1), SS, via, sig.row, is_g, n - l, base, rank,
                                   Mr, tid);
      else
        cluster_fg_pass<false, PPT>(dst, dbits, ds, l > 1 ? (BY_LEVEL ? glev(Lg, l - 1) : Lg + go(l - 1)) : ch,
                                    l > 1 ? gw(l - 1) : 0, via, sig.row,
                                    is_g, n - l, base, rank, Mr, tid);
      __syncthreads();
    }
    // the leaf (level n) from the parent row, level n−1
    const bool g_leaf = gl == n;
    F leaf[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int lm = k * CLUSTER_THREADS + tid;
      leaf[k] = 0;
      if (act[k]) {
        const int r = (g_leaf && n > 1 && (word >> 11 & 1)) ? sig.get(lm, n - 2) : m[k];
        F a, b;
        if (n == 1) {
          a = ch[0];
          b = ch[1];
        } else if (n - 1 > G) {
          const F* row = cluster_row<PPT>(Ls + so(n - 1), r, SS, rank);
          a = row[0];
          b = row[1];
        } else {
          const F* row = BY_LEVEL ? glev(Lg, n - 1) + (Off)r * 2 : Lg + go(n - 1) + (Off)r * SG;
          a = __ldcg(row);
          b = __ldcg(row + 1);
        }
        leaf[k] = g_leaf ? g_update(a, b, Bs[lm * SS + so(n)]) : f_minsum(a, b);
      }
    }

    // ---- leaf decision: extend every path, or fork and keep the best M ----
    int bit[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) bit[k] = 0;
    if (is_frozen) {
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        if (act[k]) pm[k] = pm[k] + softplus(-leaf[k]);
    } else {
      const int set = info_i & 1;
      Key kk[2 * PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        F c0 = pm[k] + softplus(-leaf[k]), c1 = pm[k] + softplus(leaf[k]);
        if (fb == 1) c0 = big<F>();
        if (fb == 0) c1 = big<F>();
        if (act[k]) {
          leafS(set)[k * CLUSTER_THREADS + tid] = leaf[k];
          synS(set)[k * CLUSTER_THREADS + tid] = syn[k];
        }
        kk[2 * k] = act[k] ? cand_key(c0, 2 * m[k]) : pad_key(c0);
        kk[2 * k + 1] = act[k] ? cand_key(c1, 2 * m[k] + 1) : pad_key(c0);
      }
      unsigned long long* sorted =
          cluster_sort<PPT>(keys, kk, P, rank, tid, info_i * cluster_exchanges<PPT>(P));
      // survivor m: the candidate of rank m, into trace slot m
      int parent[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        parent[k] = 0;
        if (act[k]) {
          const Key key = cluster_key<PPT, Key>(sorted, m[k]);
          const int w = key_index(key);
          TI[(Off)info_i * M + m[k]] = (E)w;
          parent[k] = w >> 1;
          bit[k] = w & 1;
          pm[k] = key_metric(key);
          TL[(Off)info_i * M + m[k]] = published(leafS(set), parent[k]);
          const uint32_t sp = published(synS(set), parent[k]);
          syn[k] = bit[k] ? sp ^ hc : sp;
        }
      }
      // σ ← σ[parent] on every level
      if constexpr (PPT == 1) {
        cluster_sigma_fork(sig, sigma(info_i + 1).tab, tid, parent[0], act[0]);
      } else {
        E* next = sigma(info_i + 1).tab;
#pragma unroll
        for (int k = 0; k < PPT; ++k)
          if (act[k]) global_sigma_fork(sig, next, k * CLUSTER_THREADS + tid, parent[k] - base);
        __syncthreads();
      }
      sig = sigma(++info_i);
    }

    // ---- partial-sum chain, this block's paths ----
    const int s = word >> 5 & 31;
    if (s > 0) {
      const int cmask = word >> 11;  // bit l: level l's left bits through σ
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int lm = k * CLUSTER_THREADS + tid;
        if (act[k]) {
          uint8_t* cur = s > G ? Bs + lm * SS + so(s)
                               : BY_LEVEL ? glev(Bg, s) + (Off)m[k] * gw(s) : Bg + (Off)m[k] * SG + go(s);
          if (s == n) {
            cur[0] = (uint8_t)bit[k];
          } else {
            const int r = (cmask >> n & 1) ? sig.get(lm, 2 * n - 3) : m[k];
            const uint8_t left = *cluster_row<PPT>(Bs + so(n), r, SS, rank);
            cur[1] = (uint8_t)bit[k];
            cur[0] = (uint8_t)(left ^ bit[k]);
          }
        }
      }
      __syncthreads();
      uint8_t* st = s > G ? Bs + so(s) : BY_LEVEL ? glev(Bg, s) + (Off)base * gw(s) : Bg + (Off)base * SG + go(s);
      const int sts = s > G ? SS : gw(s);
      for (int lv = n - 1; lv > s; --lv) {
        const E* via = (cmask >> lv & 1) ? sig.field(n + lv - 3) : nullptr;
        if (lv > G)
          cluster_chain_pass<true, PPT>(st, sts, Bs + so(lv), SS, via, sig.row, n - lv, base, rank, Mr, tid);
        else
          cluster_chain_pass<false, PPT>(st, sts, BY_LEVEL ? glev(Bg, lv) : Bg + go(lv), gw(lv), via, sig.row,
                                         n - lv, base, rank, Mr, tid);
        __syncthreads();
      }
    }
    // a row read through σ may be another block's: this block arrives, and
    // waits before it next writes a row (split)
    if (word >> 11) {
      cluster_arrive();
      pending = true;
    }
    s_prev = s;
    word = next_word;
  }
  if (pending) cluster_wait();

  // ---- final stable sort of the list, CRC selection, backtrack ----
  uint32_t* passS = synS(info_i & 1);
  Key kk[2 * PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (act[k]) passS[k * CLUSTER_THREADS + tid] = use_crc && syn[k] == 0u && pm[k] < big<F>();  // path m passes
    kk[2 * k] = act[k] ? cand_key(pm[k], m[k]) : pad_key(pm[k]);
    kk[2 * k + 1] = pad_key(pm[k]);
  }
  unsigned long long* sorted = cluster_sort<PPT>(keys, kk, P, rank, tid, info_i * cluster_exchanges<PPT>(P));
  // the thread of path m < M: the key (metric, path) of final rank m
  Key fkey[PPT];
  int path_r[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    fkey[k] = act[k] ? cluster_key<PPT, Key>(sorted, m[k]) : pad_key(pm[k]);
    path_r[k] = act[k] ? key_index(fkey[k]) : 0;
    if (act[k] && published(passS, path_r[k])) atomicMin(cluster.map_shared_rank(selS, 0), m[k]);
  }
  cluster.sync();
  const int least = *cluster.map_shared_rank(selS, 0);
  const int sel_rank = least < M ? least : 0;
  if (LIST) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (act[k]) {
        const F mr = key_metric(fkey[k]);
        list_metrics[frame * M + m[k]] = mr < big<F>() ? mr : inf_of(mr);
        // the path of rank m into row m of the list, before the trace is rewritten
        const long long o = (frame * M + m[k]) * K;
        int slot = path_r[k];
        for (int i = K - 1; i >= 0; --i) {
          const int w = __ldcg(TI + (Off)i * M + slot);
          list_bits[o + i] = (int8_t)(w & 1);
          list_llrs[o + i] = __ldcg(TL + (Off)i * M + slot);
          slot = w >> 1;
        }
      }
    }
    if (m[0] == 0) list_best[frame] = sel_rank;
  }
  cluster.sync();  // every walk has read the trace, and rank 0's word is read
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (act[k] && m[k] == sel_rank) {
      // the selected path's (slot << 1 | bit) into slot 0 of each trace row
      int slot = path_r[k];
      for (int i = K - 1; i >= 0; --i) {
        const int w = __ldcg(TI + (Off)i * M + slot);
        TI[(Off)i * M] = (E)((slot << 1) | (w & 1));
        slot = w >> 1;
      }
      out_pass[frame] = least < M ? 1 : 0;
    }
  }
  cluster.sync();
  for (int i = rank * CLUSTER_THREADS + tid; i < K; i += C * CLUSTER_THREADS) {
    const int r = __ldcg(TI + (Off)i * M);
    out_bits[frame * K + i] = (int8_t)(r & 1);
    out_llrs[frame * K + i] = __ldcg(TL + (Off)i * M + (r >> 1));
  }
}

#define SCL_CLUSTER_PARAMS(E, F)                                                                   \
  const F* __restrict__ llr, const int8_t* __restrict__ forced,                                    \
      const uint32_t* __restrict__ hcols, const int* __restrict__ sched, F* glob_llr,              \
      uint8_t* glob_bits, F* trace_llr, E* trace_idx, int8_t* __restrict__ out_bits,               \
      F* __restrict__ out_llrs, uint8_t* __restrict__ out_pass,                                    \
      int8_t* __restrict__ list_bits, F* __restrict__ list_llrs,                                   \
      F* __restrict__ list_metrics, int* __restrict__ list_best, int N, int n, int K, int M,       \
      int G, int use_crc
#define SCL_CLUSTER_ARGS                                                                           \
  llr, forced, hcols, sched, glob_llr, glob_bits, trace_llr, trace_idx, out_bits, out_llrs,        \
      out_pass, list_bits, list_llrs, list_metrics, list_best, N, n, K, M, G, use_crc

// M 1025..16384: one path a thread, σ in the blocks' shared memory; F:
// float, or double (the float64 instantiation, N <= 8192)
template <bool LIST, typename F>
__global__ void __launch_bounds__(CLUSTER_THREADS) scl_cluster_kernel(SCL_CLUSTER_PARAMS(uint16_t, F)) {
  scl_cluster_decode<LIST, 1, F>(SCL_CLUSTER_ARGS, nullptr, nullptr);
}

// M 16385..32768: two paths a thread on a cluster of 16, σ in global scratch
template <bool LIST>
__global__ void __launch_bounds__(CLUSTER_THREADS) scl_cluster_pair_kernel(SCL_CLUSTER_PARAMS(uint16_t, float),
                                                                           uint16_t* sigma_g) {
  scl_cluster_decode<LIST, 2, float>(SCL_CLUSTER_ARGS, sigma_g, nullptr);
}

// M 32769..65536: four paths a thread on a cluster of 16, 32-bit trace
// entries and σ fields, σ and the published words in global scratch
template <bool LIST>
__global__ void __launch_bounds__(CLUSTER_THREADS) scl_cluster_quad_kernel(SCL_CLUSTER_PARAMS(uint32_t, float),
                                                                           uint32_t* sigma_g,
                                                                           uint32_t* words_g) {
  scl_cluster_decode<LIST, 4, float>(SCL_CLUSTER_ARGS, sigma_g, words_g);
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// every kernel argument but the list size, the σ masks and the stream; F
// the LLRs' float type (double at M <= 16384 and N <= 8192)
template <typename F>
struct ArgsOf {
  const F* llr;
  const int8_t* forced;
  const uint32_t* hcols;
  const int* sched;
  F* glob_llr;
  uint8_t* glob_bits;
  F* trace_llr;
  int8_t* out_bits;
  F* out_llrs;
  uint8_t* out_pass;
  int8_t* list_bits;
  F* list_llrs;
  F* list_metrics;
  int* list_best;
  int B, N, n, K, G, use_crc, frame_bytes, frames_per_block;
};
using Args = ArgsOf<float>;

template <int M, bool LIST, typename F>
int launch_as(const ArgsOf<F>& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.frame_bytes * a.frames_per_block;
  cudaError_t err = set_smem(scl_decode_kernel<M, LIST, F>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.B + a.frames_per_block - 1) / a.frames_per_block;
  scl_decode_kernel<M, LIST, F><<<blocks, 32 * a.frames_per_block, smem, stream>>>(
      a.llr, a.forced, a.hcols, a.sched, a.glob_llr, a.glob_bits, a.trace_llr, a.out_bits,
      a.out_llrs, a.out_pass, a.list_bits, a.list_llrs, a.list_metrics, a.list_best, a.B, a.N,
      a.n, a.K, a.G, a.use_crc, a.frame_bytes, a.frames_per_block);
  return (int)cudaGetLastError();
}

// the by-path kernel of width LM: scl_path_kernel, or WIDE (LM 16 and 32
// past n = 13, float32) scl_path_wide_kernel
template <int LM, bool LIST, bool WIDE, typename F>
auto path_kernel() {
  if constexpr (WIDE)
    return scl_path_wide_kernel<LM, LIST>;
  else
    return scl_path_kernel<LM, LIST, F>;
}

template <int LM, bool LIST, bool WIDE, typename F>
int launch_path_as(const ArgsOf<F>& a, int M, uint8_t* trace_idx, cudaStream_t stream) {
  // the walks back take the trace a chunk of 16-byte rows at a time through
  // the frame's shared memory: a whole number of them, at least one row
  if (!trace_idx || a.n > MAX_LEVELS || !PathSigma<LM, WIDE>::holds(a.n) || a.frame_bytes % 16 ||
      a.frame_bytes < round16(M))
    return (int)cudaErrorInvalidValue;
  const auto kernel = path_kernel<LM, LIST, WIDE, F>();
  const size_t smem = (size_t)a.frame_bytes * a.frames_per_block;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.B + a.frames_per_block - 1) / a.frames_per_block;
  kernel<<<blocks, 32 * a.frames_per_block, smem, stream>>>(
      a.llr, a.forced, a.hcols, a.sched, a.glob_llr, a.glob_bits, a.trace_llr, trace_idx,
      a.out_bits, a.out_llrs, a.out_pass, a.list_bits, a.list_llrs, a.list_metrics, a.list_best,
      a.B, a.N, a.n, a.K, M, a.G, a.use_crc, a.frame_bytes, a.frames_per_block,
      reset_masks<LM, WIDE>(a.n));
  return (int)cudaGetLastError();
}

// the list instantiation when the list outputs are given, else the sweeps' one
// whether list size M goes to its byte-word instantiation at n
bool byte_words(int M, int n) {
  return (M == 1 || M == 2 || M == 4 || M == 8) && (M == 1 || n <= BYTE_WORD_MAX_LEVELS);
}

template <int M, typename F>
int launch(const ArgsOf<F>& a, cudaStream_t stream) {
  return a.list_bits ? launch_as<M, true>(a, stream) : launch_as<M, false>(a, stream);
}

template <int LM, typename F>
int launch_path(const ArgsOf<F>& a, int M, void* trace_idx, cudaStream_t stream) {
  uint8_t* ti = static_cast<uint8_t*>(trace_idx);
  if constexpr (LM >= 16 && std::is_same<F, float>::value)
    if (path_wide<LM>(a.n))
      return a.list_bits ? launch_path_as<LM, true, true>(a, M, ti, stream)
                         : launch_path_as<LM, false, true>(a, M, ti, stream);
  return a.list_bits ? launch_path_as<LM, true, false>(a, M, ti, stream)
                     : launch_path_as<LM, false, false>(a, M, ti, stream);
}

// the over-warps kernel: scl_deep_kernel<T, LIST, F>, or WIDE (16-bit
// entries past n = 13, float32) scl_deep_wide_kernel
template <typename T, bool LIST, bool WIDE, typename F>
auto deep_kernel() {
  if constexpr (WIDE)
    return scl_deep_wide_kernel<LIST>;
  else
    return scl_deep_kernel<T, LIST, F>;
}

template <typename T, bool LIST, bool WIDE, typename F>
int launch_deep_as(const ArgsOf<F>& a, int M, T* trace_idx, cudaStream_t stream) {
  const DeepLayout lay = deep_layout(a.N, a.n, M, a.G, sizeof(T), 2, sizeof(F));
  if (!trace_idx || a.n > MAX_LEVELS ||
      lay.sig_row > 4 * (WIDE ? DEEP_WIDE_SIGMA_WORDS : DEEP_SIGMA_WORDS) || lay.total != a.frame_bytes ||
      a.frames_per_block != 1)
    return (int)cudaErrorInvalidValue;
  const auto kernel = deep_kernel<T, LIST, WIDE, F>();
  cudaError_t err = set_smem(kernel, lay.total);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B, deep_threads(M), lay.total, stream>>>(
      a.llr, a.forced, a.hcols, a.sched, a.glob_llr, a.glob_bits, a.trace_llr, trace_idx,
      a.out_bits, a.out_llrs, a.out_pass, a.list_bits, a.list_llrs, a.list_metrics, a.list_best,
      a.N, a.n, a.K, M, a.G, a.use_crc);
  return (int)cudaGetLastError();
}

// byte trace entries while 2M <= 256, else 16-bit ones (wide past n = 13,
// float32 only: the float64 entry points take n <= 13)
template <typename F>
int launch_deep(const ArgsOf<F>& a, int M, void* trace_idx, cudaStream_t stream) {
  if (M <= 128)
    return a.list_bits ? launch_deep_as<uint8_t, true, false>(a, M, static_cast<uint8_t*>(trace_idx), stream)
                       : launch_deep_as<uint8_t, false, false>(a, M, static_cast<uint8_t*>(trace_idx), stream);
  uint16_t* ti = static_cast<uint16_t*>(trace_idx);
  if constexpr (std::is_same<F, float>::value)
    if (deep_wide<uint16_t>(a.n))
      return a.list_bits ? launch_deep_as<uint16_t, true, true>(a, M, ti, stream)
                         : launch_deep_as<uint16_t, false, true>(a, M, ti, stream);
  return a.list_bits ? launch_deep_as<uint16_t, true, false>(a, M, ti, stream)
                     : launch_deep_as<uint16_t, false, false>(a, M, ti, stream);
}

// the plan of launch_deep's instantiation (best-only: the list one has the
// same launch bounds)
template <typename F>
int plan_deep_of(int M, int n, int frame_bytes, int max_block_smem, int* frames_per_block, int* frames_per_sm) {
  if (M > 128) {
    if constexpr (std::is_same<F, float>::value)
      if (deep_wide<uint16_t>(n))
        return plan_deep(scl_deep_wide_kernel<false>, M, frame_bytes, max_block_smem, frames_per_block,
                         frames_per_sm);
    return plan_deep(scl_deep_kernel<uint16_t, false, F>, M, frame_bytes, max_block_smem, frames_per_block,
                     frames_per_sm);
  }
  return plan_deep(scl_deep_kernel<uint8_t, false, F>, M, frame_bytes, max_block_smem, frames_per_block,
                   frames_per_sm);
}

// F double: one path a thread only (the float64 instantiation)
template <bool LIST, int PPT, typename F = float>
int launch_cluster_as(const ArgsOf<F>& a, int M, void* trace_idx, void* sigma, cudaStream_t stream) {
  using E = ClusterEntry<PPT>;
  const ClusterLayout lay = cluster_layout<PPT>(a.N, a.n, a.G, 2, sizeof(F));
  // levels 1..G in global scratch, G+1..n in each block's shared memory,
  // one frame a cluster; past one path a thread σ in global scratch
  if (!trace_idx || (PPT > 1 && !sigma) || (a.G > 0 && (!a.glob_llr || !a.glob_bits)) || a.n > MAX_LEVELS ||
      a.G < 0 || a.G >= a.n || lay.total != a.frame_bytes || a.frames_per_block != 1)
    return (int)cudaErrorInvalidValue;
  E* ti = static_cast<E*>(trace_idx);
  E* sg = static_cast<E*>(sigma);
  if constexpr (PPT == 1)
    return launch_cluster_kernel(scl_cluster_kernel<LIST, F>, a.B, M, lay.total, stream, a.llr, a.forced,
                                 a.hcols, a.sched, a.glob_llr, a.glob_bits, a.trace_llr, ti,
                                 a.out_bits, a.out_llrs, a.out_pass, a.list_bits, a.list_llrs,
                                 a.list_metrics, a.list_best, a.N, a.n, a.K, M, a.G, a.use_crc);
  else if constexpr (PPT == 2)
    return launch_cluster_kernel(scl_cluster_pair_kernel<LIST>, a.B, M, lay.total, stream, a.llr, a.forced,
                                 a.hcols, a.sched, a.glob_llr, a.glob_bits, a.trace_llr, ti,
                                 a.out_bits, a.out_llrs, a.out_pass, a.list_bits, a.list_llrs,
                                 a.list_metrics, a.list_best, a.N, a.n, a.K, M, a.G, a.use_crc, sg);
  else  // the published word sets after σ's tables, [B][2][2][M]
    return launch_cluster_kernel(scl_cluster_quad_kernel<LIST>, a.B, M, lay.total, stream, a.llr, a.forced,
                                 a.hcols, a.sched, a.glob_llr, a.glob_bits, a.trace_llr, ti,
                                 a.out_bits, a.out_llrs, a.out_pass, a.list_bits, a.list_llrs,
                                 a.list_metrics, a.list_best, a.N, a.n, a.K, M, a.G, a.use_crc, sg,
                                 reinterpret_cast<uint32_t*>(static_cast<char*>(sigma) +
                                                             (size_t)a.B * 2 * M * lay.sig_row));
}

int launch_cluster(const Args& a, int M, void* trace_idx, void* sigma, cudaStream_t stream) {
  switch (cluster_ppt(M)) {
    case 4:
      return a.list_bits ? launch_cluster_as<true, 4>(a, M, trace_idx, sigma, stream)
                         : launch_cluster_as<false, 4>(a, M, trace_idx, sigma, stream);
    case 2:
      return a.list_bits ? launch_cluster_as<true, 2>(a, M, trace_idx, sigma, stream)
                         : launch_cluster_as<false, 2>(a, M, trace_idx, sigma, stream);
  }
  return a.list_bits ? launch_cluster_as<true, 1>(a, M, trace_idx, sigma, stream)
                     : launch_cluster_as<false, 1>(a, M, trace_idx, sigma, stream);
}

// The frames a block (1..MAX_FRAMES_PER_BLOCK) that let an SM hold the most
// frames at once, by the occupancy calculator (shared memory, registers and
// warps all counted); ties go to more frames a block.  The list
// instantiation runs on the same plan: it has the same launch bounds.
template <typename Kern>
int plan(Kern kernel, int frame_bytes, int max_block_smem, int* frames_per_block,
         int* frames_per_sm) {
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

// list sizes 1..32, one path a lane of a warp: the byte-word
// instantiations (M ∈ {1, 2, 4, 8} where `byte_words`), which the sweeps
// launch, else by path
template <typename F>
int launch_warp(const ArgsOf<F>& a, int M, void* trace_idx, cudaStream_t st) {
#if !SCL_BY_PATH_ONLY
  if (byte_words(M, a.n)) switch (M) {
      case 1: return launch<1>(a, st);
      case 2: return launch<2>(a, st);
      case 4: return launch<4>(a, st);
      case 8: return launch<8>(a, st);
    }
#endif
#if SCL_LEAST_PATH_WIDTH <= 4
  if (M <= 4) return launch_path<4>(a, M, trace_idx, st);
#endif
  if (M <= 8) return launch_path<8>(a, M, trace_idx, st);
  if (M <= 16) return launch_path<16>(a, M, trace_idx, st);
  return launch_path<32>(a, M, trace_idx, st);
}

// the plan of launch_warp's instantiation (best-only: the list one has the
// same launch bounds)
template <typename F>
int plan_warp(int M, int n, int frame_bytes, int max_block_smem, int* frames_per_block, int* frames_per_sm) {
#define SCL_PLAN(kernel) \
  return plan(kernel, frame_bytes, max_block_smem, frames_per_block, frames_per_sm)
#if !SCL_BY_PATH_ONLY
  if (byte_words(M, n)) switch (M) {
      case 1: SCL_PLAN((scl_decode_kernel<1, false, F>));
      case 2: SCL_PLAN((scl_decode_kernel<2, false, F>));
      case 4: SCL_PLAN((scl_decode_kernel<4, false, F>));
      case 8: SCL_PLAN((scl_decode_kernel<8, false, F>));
    }
#endif
#if SCL_LEAST_PATH_WIDTH <= 4
  if (M <= 4) SCL_PLAN((scl_path_kernel<4, false, F>));
#endif
  if (M <= 8) SCL_PLAN((scl_path_kernel<8, false, F>));
  if constexpr (std::is_same<F, float>::value) {
    if (M <= 16 && path_wide<16>(n)) SCL_PLAN((scl_path_wide_kernel<16, false>));
    if (M > 16 && path_wide<32>(n)) SCL_PLAN((scl_path_wide_kernel<32, false>));
  }
  if (M <= 16) SCL_PLAN((scl_path_kernel<16, false, F>));
  SCL_PLAN((scl_path_kernel<32, false, F>));
#undef SCL_PLAN
}

template <typename F>
ArgsOf<F> args_of(const void* llr, const void* forced, const void* hcols, const void* sched, void* glob_llr,
                  void* glob_bits, void* trace_llr, void* out_bits, void* out_llrs, void* out_pass,
                  void* list_bits, void* list_llrs, void* list_metrics, void* list_best, int B, int N, int n,
                  int K, int G, int use_crc, int frame_bytes, int frames_per_block) {
  return {static_cast<const F*>(llr), static_cast<const int8_t*>(forced),
          static_cast<const uint32_t*>(hcols), static_cast<const int*>(sched),
          static_cast<F*>(glob_llr), static_cast<uint8_t*>(glob_bits),
          static_cast<F*>(trace_llr), static_cast<int8_t*>(out_bits),
          static_cast<F*>(out_llrs), static_cast<uint8_t*>(out_pass),
          static_cast<int8_t*>(list_bits), static_cast<F*>(list_llrs),
          static_cast<F*>(list_metrics), static_cast<int*>(list_best),
          B, N, n, K, G, use_crc, frame_bytes, frames_per_block};
}

}  // namespace

// f64: the LLRs, the level and trace LLRs and the LLR and metric outputs are
// float64 (double) rather than float32
extern "C" int scl_decode_launch(const void* llr, const void* forced, const void* hcols,
                                 const void* sched, void* glob_llr, void* glob_bits,
                                 void* trace_llr, void* trace_idx, void* sigma, void* out_bits, void* out_llrs,
                                 void* out_pass, void* list_bits, void* list_llrs,
                                 void* list_metrics, void* list_best, int B, int N, int n, int K,
                                 int M, int G, int use_crc, int frame_bytes, int frames_per_block,
                                 int f64, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f64) {  // M 1..16384 at n <= 13: one path a lane up to 32, over warps up to 1024, one path a thread above
    if (M < 1 || M > F64_MAX_M || n > BYTE_WORD_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    const ArgsOf<double> d = args_of<double>(llr, forced, hcols, sched, glob_llr, glob_bits, trace_llr, out_bits,
                                             out_llrs, out_pass, list_bits, list_llrs, list_metrics, list_best, B,
                                             N, n, K, G, use_crc, frame_bytes, frames_per_block);
    if (M > DEEP_MAX_M)
      return d.list_bits ? launch_cluster_as<true, 1>(d, M, trace_idx, sigma, st)
                         : launch_cluster_as<false, 1>(d, M, trace_idx, sigma, st);
    if (M >= DEEP_MIN_M) return launch_deep(d, M, trace_idx, st);
    return launch_warp(d, M, trace_idx, st);
  }
  const Args a = args_of<float>(llr, forced, hcols, sched, glob_llr, glob_bits, trace_llr, out_bits, out_llrs,
                                out_pass, list_bits, list_llrs, list_metrics, list_best, B, N, n, K, G, use_crc,
                                frame_bytes, frames_per_block);
  if (M < 1 || M > CLUSTER_MAX_M) return (int)cudaErrorInvalidValue;
  if (M > DEEP_MAX_M) return launch_cluster(a, M, trace_idx, sigma, st);
  if (M >= DEEP_MIN_M) return launch_deep(a, M, trace_idx, st);
  return launch_warp(a, M, trace_idx, st);
}

extern "C" int scl_launch_plan(int M, int n, int frame_bytes, int max_block_smem, int f64,
                               int* frames_per_block, int* frames_per_sm) {
  if (f64) {  // the float64 instantiations: M 1..16384 at n <= 13
    if (M < 1 || M > F64_MAX_M || n > BYTE_WORD_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (M > DEEP_MAX_M) {  // frames_per_sm: the frames (clusters) the card runs at once
      *frames_per_block = 1;
      return plan_cluster(scl_cluster_kernel<false, double>, M, frame_bytes, max_block_smem, frames_per_sm);
    }
    if (M >= DEEP_MIN_M)
      return plan_deep_of<double>(M, n, frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
    return plan_warp<double>(M, n, frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
  }
  if (M < 1 || M > CLUSTER_MAX_M) return (int)cudaErrorInvalidValue;
  if (M > DEEP_MAX_M) {  // frames_per_sm: the frames (clusters) the card runs at once
    *frames_per_block = 1;
    switch (cluster_ppt(M)) {
      case 4: return plan_cluster(scl_cluster_quad_kernel<false>, M, frame_bytes, max_block_smem, frames_per_sm);
      case 2: return plan_cluster(scl_cluster_pair_kernel<false>, M, frame_bytes, max_block_smem, frames_per_sm);
    }
    return plan_cluster(scl_cluster_kernel<false, float>, M, frame_bytes, max_block_smem, frames_per_sm);
  }
  if (M >= DEEP_MIN_M)
    return plan_deep_of<float>(M, n, frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
  return plan_warp<float>(M, n, frame_bytes, max_block_smem, frames_per_block, frames_per_sm);
}

extern "C" const char* scl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
