// Layered normalized min-sum LDPC decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `polar_code_tpu/nr/ldpc/nms_pallas.py:31`
// `_kernel_body` (built by `_build`, called by `decode_ldpc_nms_pallas`).  It
// computes what `polar_code_tpu_torch/nr/ldpc/decode_nms.py`
// `decode_ldpc_nms_batch` computes on the lifted circulant graph: hard
// decisions, the iteration each frame stopped at, and the final parity check.
//
// The code: row z of block-row r touches, in each nonzero block c with shift
// s, the column c*Z + (z + s) mod Z (the Pallas kernel's roll becomes index
// arithmetic).  The Z rows of one block-row touch disjoint columns, so they
// update in parallel, and block-rows run in order: together that is the
// sequential row order the plain version computes.  One thread owns check
// row z of every block-row; after each iteration the frame checks its
// syndrome, block-row by block-row, and stops at the first failing one; a
// frame whose syndrome passes stops and is never touched again, which keeps
// its LLRs exactly, as the plain version's `where(done, llr, new_llr)` does.
// Without early stop (`early_stop` 0, the plain version's
// `early_stop=False`) no syndrome is checked between iterations: every frame
// runs `max_iter` of them, and its bits and parity are its final LLRs'.
//
// What bounds it on this card: neither bytes (n floats in, n bytes and two
// words out a frame) nor the arithmetic peak, but the instructions each edge
// costs and each frame's serial chain of block-rows.  The design keeps an
// edge's visit to a few instructions and many frames on each SM:
//
// * Two modes.  WARP (Z <= 32, when its tables fit): one warp decodes one
//   frame, lane z owns row z, and a block holds `frames_per_block` warps, as
//   many as the occupancy calculator lets an SM hold (`nms_cuda.py::
//   launch_plan`).  Block-rows are separated by `__syncwarp`, the syndrome
//   vote is `__any_sync`, and a frame that stops leaves its loop while the
//   block's other frames go on: no block barrier stands in the loop.  BLOCK
//   (every other shape): a frame keeps a block of ceil(Z/32) warps, with
//   `__syncthreads` between block-rows.  In both, a block walks frames
//   blockIdx, blockIdx + grid, ... (the wrapper sizes the grid to what the
//   card holds at once), so a warp that stops early takes its next frame.
// * Columns fixed once.  A row's column for each edge never changes.  WARP
//   keeps them in a block-shared table as byte offsets into the frame's
//   LLRs, [8-edge chunk][half][lane] of four u32 (one 16-byte load for four
//   edges), and fetches a block-row's chunks while the block-row before it
//   computes.  BLOCK keeps (4s, 4c*Z) an edge and forms min(4z + 4s,
//   4z + 4s - 4Z) over unsigned, plus 4c*Z.
// * `ext` in registers.  A row's edge loop is unrolled to a compile-time
//   bound D (8 or 32, the wrapper's pick from the graph's largest degree);
//   ext = L - msg stays in registers between the pass that finds the minima
//   and the pass that writes, which reads no L and no message.  A row's D
//   loads go out together (past the row's end a lane reads a column that
//   exists), and its arithmetic runs over its degree only, entered by one
//   jump into a fall-through chain of edges (`edges_down`), last edge first.
//   A row of degree above 32 goes in 32-edge chunks, and its write pass
//   computes ext again from L and the old record.
// * Messages in compressed check-row form.  Under two-min a row keeps one
//   record instead of one float an edge: A1 = alpha*min1, A2 = alpha*min2
//   (0 when min1 == 0), the index of an edge at min1, and a sign word a 32
//   edges, bit j the message sign of the chunk's edge j: its ext sign XOR
//   the row's sign parity (the popcount of the ext signs, which are
//   funnel-shifted in edge by edge).  Edge e's message is (e == idx ? A2 :
//   A1) with that sign.  Under shared min a row keeps its one message.
//   Records lie [row][word][lane]: in shared memory when they fit, else
//   (BLOCK) in a global scratch a block slot, where the next block-row's
//   record is loaded while this one computes.
//
// Exactness: the plain version's expressions, built without fast math and
// with -fmad=false.  ext = llr - msg; min1/min2 as fminf(min2, fmaxf(min1,
// a)), fminf(min1, a); the update (alpha * sp) * min1 (shared) or
// (alpha * (sp * sign(ext))) * (|ext| == min1 ? min2 : min1) (two-min); llr =
// ext + update.  With sp = +-1 those equal +-(alpha*min1) and
// +-(alpha*(sel)), the sign the parity of the ext signs (times the edge's
// own sign): IEEE products are sign-symmetric.  Where |ext| == min1 at two
// edges, min2 == min1, so which edge the record names does not matter.
// Where some ext is +-0, min1 == 0 and the old update is +-0 at every edge;
// A1 = alpha*0 and A2 = 0 give +-0 too.  The values can then differ only in
// the sign of a zero, which no output reads: `L < 0`, fabsf, fminf and fmaxf
// treat +0 and -0 alike, and x - (+-0) and x + (+-0) are x for every x but
// a zero.  alpha is the float32 of the caller's value.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned SIGN = 0x80000000u;
constexpr int WARP = 0, BLOCK = 1, BLOCK_1024 = 2;  // BLOCK: <= 512 threads; BLOCK_1024: <= 1024

struct Params {
  const float* llr;
  const int* row_tab;    // WARP: int2 {first chunk, degree} a block-row; BLOCK: row_ptr [mb+1]
  const void* col_tab;   // WARP: uint4 [chunks][2][32]; BLOCK: int2 {4s, 4c*Z} [E]
  int8_t* out_hard;
  int* out_iters;
  uint8_t* out_ok;
  unsigned* rec_scratch; // BLOCK with records in global memory: [grid][mb][nw][Z]
  int B, mb, n, Z, E, max_iter;
  float alpha;
  int early_stop;        // 0: every frame runs max_iter iterations
  int nw;                // record words a row: 1 (shared min) or 3 + sign words (two-min)
  int col_chunks;        // WARP: 8-edge chunks of the column table
  int tables_bytes;      // WARP: block-shared table bytes (a multiple of 16)
  int frame_bytes;       // WARP: bytes a frame (LLRs, then records at `rec_offset`)
  int rec_offset;        // byte offset of the records (in a frame's region for WARP; 0 = global)
  int frames_per_block;  // WARP
};

struct RowGeom {
  int first;  // WARP: first 8-edge chunk; BLOCK: first edge
  int deg;
};

// a row's record as it is carried between block-rows (two-min: A1, A2,
// argmin, sign word 0; shared min: the message in `a1`)
struct Rec {
  float a1, a2;
  int idx;
  unsigned s;
};

// a row's column source, fetched a block-row ahead: WARP the row's first
// D/8 chunks of the column table, BLOCK its place in the edge table.
// Columns are byte offsets into the frame's LLRs.
template <int D>
struct WarpCols {
  RowGeom g;
  uint4 v[D / 4];
};

template <int D>
struct BlockCols {
  RowGeom g;
};

__device__ __forceinline__ void unpack4(const uint4& v, int* col) {
  col[0] = v.x;
  col[1] = v.y;
  col[2] = v.z;
  col[3] = v.w;
}

// the LLR at byte offset `off` of a frame's LLRs
__device__ __forceinline__ float& at(float* L, int off) {
  return *reinterpret_cast<float*>(reinterpret_cast<char*>(L) + off);
}

// Past a row's end a lane reads a column that exists (0 in WARP, z in
// BLOCK) and ignores it, so a row's loads go out together without branches.
struct WarpFrame {
  const uint4* ctab;
  const int2* rows;
  float* L;
  unsigned* rec;
  int lane, nw;
  bool active;
  __device__ RowGeom row(int r) const {
    const int2 g = rows[r];
    return {g.x, g.y};
  }
  template <int D>
  __device__ WarpCols<D> fetch(int r) const {
    WarpCols<D> c;
    c.g = row(r);
    const uint4* t = ctab + c.g.first * 64 + lane;
#pragma unroll
    for (int q = 0; q < D / 4; ++q) c.v[q] = 4 * q < c.g.deg ? t[q * 32] : make_uint4(0, 0, 0, 0);
    return c;
  }
  template <int D>
  __device__ void cols(const WarpCols<D>& c, int (&col)[D]) const {
#pragma unroll
    for (int q = 0; q < D / 4; ++q) unpack4(c.v[q], col + 4 * q);
  }
  template <int D>
  __device__ void cols_at(const RowGeom& g, int base, int (&col)[D]) const {
    const uint4* t = ctab + (g.first + (base >> 3)) * 64 + lane;
#pragma unroll
    for (int q = 0; q < D / 4; ++q)
      unpack4(base + 4 * q < g.deg ? t[q * 32] : make_uint4(0, 0, 0, 0), col + 4 * q);
  }
  __device__ unsigned& word(int r, int w) const { return rec[(r * nw + w) * 32 + lane]; }
  __device__ void sync() const { __syncwarp(); }
  __device__ bool any(int bad) const { return __any_sync(FULL, bad); }
};

struct BlockFrame {
  const int2* etab;
  const int* rp;
  float* L;
  unsigned* rec;
  int z, Z, nw;
  bool active;
  __device__ RowGeom row(int r) const { return {rp[r], rp[r + 1] - rp[r]}; }
  template <int D>
  __device__ BlockCols<D> fetch(int r) const {
    return {row(r)};
  }
  template <int D>
  __device__ void cols(const BlockCols<D>& c, int (&col)[D]) const {
    cols_at<D>(c.g, 0, col);
  }
  // in bytes, (z + s) mod Z + c*Z as min(z + s, z + s - Z) over unsigned, + c*Z
  template <int D>
  __device__ void cols_at(const RowGeom& g, int base, int (&col)[D]) const {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int2 t = base + j < g.deg ? etab[g.first + base + j] : make_int2(0, 0);
      const unsigned u = (unsigned)(4 * z + t.x);
      col[j] = (int)min(u, u - (unsigned)(4 * Z)) + t.y;
    }
  }
  __device__ unsigned& word(int r, int w) const { return rec[(size_t)(r * nw + w) * Z + z]; }
  __device__ void sync() const { __syncthreads(); }
  __device__ bool any(int bad) const { return __syncthreads_or(bad); }
};

template <bool SE, class F>
__device__ __forceinline__ Rec load_rec(const F& f, int r) {
  if (SE) {
    return {__uint_as_float(f.word(r, 0)), __uint_as_float(f.word(r, 1)), (int)f.word(r, 2),
            f.word(r, 3)};
  }
  return {__uint_as_float(f.word(r, 0)), 0.f, 0, 0u};
}

// edge e's two-min message: A2 at the argmin, else A1, with the sign bit
// of `w` (a sign word shifted so that e's bit is bit 31)
__device__ __forceinline__ float message(const Rec& m, int e, unsigned w) {
  return __uint_as_float(__float_as_uint(e == m.idx ? m.a2 : m.a1) ^ (w & SIGN));
}

// fn(j) for the edges j = n-1 down to 0 of a row (n <= D), with one jump
// into a fall-through chain instead of a test at each edge; j is a
// compile-time constant in fn, so register arrays stay registers
template <int D, class Fn>
__device__ __forceinline__ void edges_down(int n, Fn&& fn) {
#define NMS_EDGE(k) \
  case k:           \
    if constexpr (k <= D) fn(std::integral_constant<int, k - 1>{}); \
    [[fallthrough]];
  switch (n) {
    NMS_EDGE(32) NMS_EDGE(31) NMS_EDGE(30) NMS_EDGE(29) NMS_EDGE(28) NMS_EDGE(27) NMS_EDGE(26)
    NMS_EDGE(25) NMS_EDGE(24) NMS_EDGE(23) NMS_EDGE(22) NMS_EDGE(21) NMS_EDGE(20) NMS_EDGE(19)
    NMS_EDGE(18) NMS_EDGE(17) NMS_EDGE(16) NMS_EDGE(15) NMS_EDGE(14) NMS_EDGE(13) NMS_EDGE(12)
    NMS_EDGE(11) NMS_EDGE(10) NMS_EDGE(9) NMS_EDGE(8) NMS_EDGE(7) NMS_EDGE(6) NMS_EDGE(5)
    NMS_EDGE(4) NMS_EDGE(3) NMS_EDGE(2) NMS_EDGE(1)
    default:
      break;
  }
#undef NMS_EDGE
}

// One row's update.  On entry `next` holds this row's record and `pf` its
// columns (both fetched a row ahead); on return, the next block-row's.  A
// row's loads go out together (past its end a lane reads a column that
// exists); its arithmetic runs over its degree only, edges taken from the
// last down, so that the sign bits shifted in edge by edge leave edge j at
// bit j.
template <int D, bool SE, class F, class P>
__device__ __forceinline__ void update_row(const F& f, int r, int mb, float alpha, Rec& next,
                                           P& pf) {
  const Rec old = next;
  const P cur = pf;
  const int rn = r + 1 == mb ? 0 : r + 1;
  if (rn != r) {
    next = load_rec<SE>(f, rn);
    pf = f.template fetch<D>(rn);
  }
  const int deg = cur.g.deg;
  float m1 = INFINITY, m2 = INFINITY;
  int idx = 0;
  unsigned sgn = 0;  // ext sign bits
  Rec nr;
  // pass 1 over one chunk of n edges: ext, the minima, the argmin, the signs
  auto find = [&](float* ext, int n, int base, const Rec& o, unsigned ow) {
    edges_down<D>(n, [&](auto jc) {
      constexpr int j = decltype(jc)::value;
      const float x = ext[j] - (SE ? message(o, base + j, ow << (31 - j)) : o.a1);
      ext[j] = x;
      sgn = __funnelshift_l(__float_as_uint(x), sgn, 1);
      const float a = fabsf(x);
      if (SE) {
        m2 = fminf(m2, fmaxf(m1, a));
        idx = a < m1 ? base + j : idx;
      }
      m1 = fminf(m1, a);
    });
  };
  if (D < 32 || deg <= D) {
    int col[D];
    float ext[D];
    f.template cols<D>(cur, col);
#pragma unroll
    for (int j = 0; j < D; ++j) ext[j] = at(f.L, col[j]);
    find(ext, deg, 0, old, old.s);
    const unsigned pm = __popc(sgn) & 1 ? FULL : 0u;  // the sign product's sign
    if (SE) {
      nr = {alpha * m1, m1 == 0.f ? 0.f : alpha * m2, idx, sgn ^ pm};
      edges_down<D>(deg, [&](auto jc) {
        constexpr int j = decltype(jc)::value;
        at(f.L, col[j]) = ext[j] + message(nr, j, nr.s << (31 - j));
      });
    } else {
      nr.a1 = __uint_as_float(__float_as_uint(alpha * m1) ^ (pm & SIGN));
      edges_down<D>(deg, [&](auto jc) {
        constexpr int j = decltype(jc)::value;
        at(f.L, col[j]) = ext[j] + nr.a1;
      });
    }
  } else {
    // degree above 32: 32-edge chunks, sign word k for chunk k; the write
    // pass computes ext again (no thread but this one touches these columns
    // in between, so it is the same value)
    int col[D];
    float lv[D];
    unsigned par = 0;
    for (int base = 0; base < deg; base += D) {
      const unsigned ow = base == 0 ? old.s : f.word(r, 3 + (base >> 5));
      f.template cols_at<D>(cur.g, base, col);
#pragma unroll
      for (int j = 0; j < D; ++j) lv[j] = at(f.L, col[j]);
      sgn = 0;
      find(lv, min(D, deg - base), base, old, ow);
      par ^= __popc(sgn);
    }
    const unsigned pm = par & 1 ? FULL : 0u;
    if (SE) {
      nr = {alpha * m1, m1 == 0.f ? 0.f : alpha * m2, idx, 0u};
    } else {
      nr.a1 = __uint_as_float(__float_as_uint(alpha * m1) ^ (pm & SIGN));
    }
    for (int base = 0; base < deg; base += D) {
      const unsigned ow = base == 0 ? old.s : f.word(r, 3 + (base >> 5));
      f.template cols_at<D>(cur.g, base, col);
#pragma unroll
      for (int j = 0; j < D; ++j) lv[j] = at(f.L, col[j]);
      unsigned w = 0;
      edges_down<D>(min(D, deg - base), [&](auto jc) {
        constexpr int j = decltype(jc)::value;
        const float x = lv[j] - (SE ? message(old, base + j, ow << (31 - j)) : old.a1);
        const unsigned xb = __float_as_uint(x);
        w = __funnelshift_l(xb, w, 1);
        at(f.L, col[j]) = x + (SE ? message(nr, base + j, xb ^ pm) : nr.a1);
      });
      if (SE) {
        if (base == 0) nr.s = w ^ pm;
        else f.word(r, 3 + (base >> 5)) = w ^ pm;
      }
    }
  }
  f.word(r, 0) = __float_as_uint(nr.a1);
  if (SE) {
    f.word(r, 1) = __float_as_uint(nr.a2);
    f.word(r, 2) = (unsigned)nr.idx;
    f.word(r, 3) = nr.s;
  }
  if (rn == r) next = nr;
}

// every thread of the frame calls this: true iff some row's parity fails;
// it stops at the first block-row that fails.  `pf0` holds row 0's columns.
// The sign bit of L + 0 is L < 0 (-0 + 0 is +0).
template <int D, class F, class P>
__device__ bool syndrome_fails(const F& f, int mb, const P& pf0) {
  for (int r = 0; r < mb; ++r) {
    unsigned par = 0;
    if (f.active) {
      const RowGeom g = r == 0 ? pf0.g : f.row(r);
      int col[D];
      for (int base = 0; base < g.deg; base += D) {
        if (r == 0 && base == 0) f.template cols<D>(pf0, col);
        else f.template cols_at<D>(g, base, col);
        float lv[D];
#pragma unroll
        for (int j = 0; j < D; ++j) lv[j] = at(f.L, col[j]);
        edges_down<D>(min(D, g.deg - base), [&](auto jc) {
          par ^= __float_as_uint(lv[decltype(jc)::value] + 0.f);
        });
      }
    }
    if (f.any(par >> 31)) return true;
  }
  return false;
}

// decode the frame whose LLRs are in f.L (records zeroed, frame synced)
template <int D, bool SE, class F>
__device__ void decode(const F& f, const Params& p, int& iters, int& ok) {
  Rec next = {0.f, 0.f, 0, 0u};
  decltype(f.template fetch<D>(0)) pf{};
  if (p.mb > 0 && f.active) pf = f.template fetch<D>(0);
  int stopped = 0, it = 0;
  for (; it < p.max_iter; ++it) {
    for (int r = 0; r < p.mb; ++r) {
      if (f.active) update_row<D, SE>(f, r, p.mb, p.alpha, next, pf);
      f.sync();
    }
    if (p.early_stop && !syndrome_fails<D>(f, p.mb, pf)) {
      stopped = 1;
      break;
    }
  }
  // a frame that never stopped reports the check of its final LLRs: the
  // last iteration's (failed, under early stop), or the input's when
  // max_iter is 0
  ok = stopped || ((p.max_iter == 0 || !p.early_stop) && !syndrome_fails<D>(f, p.mb, pf));
  iters = stopped ? it + 1 : p.max_iter;
}

template <int D, bool SE>
__device__ void warp_body(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint4* gtab = static_cast<const uint4*>(p.col_tab);
  const int2* grow = reinterpret_cast<const int2*>(p.row_tab);
  uint4* ctab = reinterpret_cast<uint4*>(smem);
  int2* rows = reinterpret_cast<int2*>(smem + 1024 * p.col_chunks);
  for (int i = threadIdx.x; i < p.col_chunks * 64; i += blockDim.x) ctab[i] = gtab[i];
  for (int i = threadIdx.x; i < p.mb; i += blockDim.x) rows[i] = grow[i];
  __syncthreads();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* region = smem + p.tables_bytes + w * p.frame_bytes;
  WarpFrame f{ctab, rows, reinterpret_cast<float*>(region),
              reinterpret_cast<unsigned*>(region + p.rec_offset), lane, p.nw, lane < p.Z};
  const int n = p.n;
  for (int frame = blockIdx.x * p.frames_per_block + w; frame < p.B;
       frame += gridDim.x * p.frames_per_block) {
    const float* src = p.llr + (size_t)frame * n;
    for (int i = lane; i < n; i += 32) f.L[i] = src[i];
    for (int k = 0; k < p.mb * p.nw; ++k) f.rec[k * 32 + lane] = 0u;
    __syncwarp();
    int iters, ok;
    decode<D, SE>(f, p, iters, ok);
    int8_t* hard = p.out_hard + (size_t)frame * n;
    for (int i = lane; i < n; i += 32) hard[i] = f.L[i] < 0.f ? 1 : 0;
    if (lane == 0) {
      p.out_iters[frame] = iters;
      p.out_ok[frame] = ok ? 1 : 0;
    }
    __syncwarp();
  }
}

template <int D, bool SE>
__device__ void block_body(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = p.n, mb = p.mb, E = p.E;
  int2* etab = reinterpret_cast<int2*>(smem);
  float* L = reinterpret_cast<float*>(smem + 8 * E);
  int* rp = reinterpret_cast<int*>(smem + 8 * E + 4 * n);
  unsigned* rec = p.rec_offset
                      ? reinterpret_cast<unsigned*>(smem + p.rec_offset)
                      : p.rec_scratch + (size_t)blockIdx.x * mb * p.nw * p.Z;
  const int2* getab = static_cast<const int2*>(p.col_tab);
  for (int i = threadIdx.x; i < E; i += blockDim.x) etab[i] = getab[i];
  for (int i = threadIdx.x; i <= mb; i += blockDim.x) rp[i] = p.row_tab[i];

  const int z = threadIdx.x;
  BlockFrame f{etab, rp, L, rec, z, p.Z, p.nw, z < p.Z};
  for (int frame = blockIdx.x; frame < p.B; frame += gridDim.x) {
    __syncthreads();  // the tables, or the last frame's final reads of L
    const float* src = p.llr + (size_t)frame * n;
    for (int i = z; i < n; i += blockDim.x) L[i] = src[i];
    if (f.active)
      for (int k = 0; k < mb * p.nw; ++k) rec[(size_t)k * p.Z + z] = 0u;
    __syncthreads();
    int iters, ok;
    decode<D, SE>(f, p, iters, ok);
    int8_t* hard = p.out_hard + (size_t)frame * n;
    for (int i = z; i < n; i += blockDim.x) hard[i] = L[i] < 0.f ? 1 : 0;
    if (z == 0) {
      p.out_iters[frame] = iters;
      p.out_ok[frame] = ok ? 1 : 0;
    }
  }
}

template <int D, bool SE>
__global__ void nms_kernel_warp(const Params p) {
  warp_body<D, SE>(p);
}

template <int D, bool SE>
__global__ void __launch_bounds__(512) nms_kernel_block(const Params p) {
  block_body<D, SE>(p);
}

template <int D, bool SE>
__global__ void __launch_bounds__(1024) nms_kernel_1024(const Params p) {
  block_body<D, SE>(p);
}

using Kernel = void (*)(Params);

template <int D, bool SE>
Kernel pick_mode(int mode) {
  if (mode == WARP) return nms_kernel_warp<D, SE>;
  if (mode == BLOCK) return nms_kernel_block<D, SE>;
  return nms_kernel_1024<D, SE>;
}

template <int D>
Kernel pick_se(int se, int mode) {
  return se ? pick_mode<D, true>(mode) : pick_mode<D, false>(mode);
}

Kernel pick(int D, int se, int mode) {
  if (mode < WARP || mode > BLOCK_1024 || (mode == WARP && D > 32)) return nullptr;
  if (D == 8) return pick_se<8>(se, mode);
  if (D == 32) return pick_se<32>(se, mode);
  return nullptr;
}

cudaError_t set_smem(Kernel k, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// Blocks of `threads` threads with `smem` bytes of dynamic shared memory an
// SM holds at once (occupancy calculator), the kernel's registers a thread
// and the most threads a block of it may have.
extern "C" int nms_occupancy(int D, int se, int mode, int threads, int smem, int* blocks_per_sm,
                             int* regs, int* max_threads) {
  Kernel k = pick(D, se, mode);
  if (!k) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(k));
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *max_threads = attr.maxThreadsPerBlock;
  *blocks_per_sm = 0;
  if (threads > attr.maxThreadsPerBlock) return 0;
  err = set_smem(k, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(k), threads, smem);
}

extern "C" int nms_decode_launch(const void* llr, const void* row_tab, const void* col_tab,
                                 void* out_hard, void* out_iters, void* out_ok, void* rec_scratch,
                                 int B, int mb, int n, int Z, int E, int max_iter, float alpha,
                                 int early_stop, int nw, int col_chunks, int tables_bytes,
                                 int frame_bytes, int rec_offset, int frames_per_block, int D,
                                 int se, int mode, int grid, int threads, int smem, void* stream) {
  Kernel k = pick(D, se, mode);
  if (!k || grid < 1) return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(llr), static_cast<const int*>(row_tab), col_tab,
           static_cast<int8_t*>(out_hard), static_cast<int*>(out_iters),
           static_cast<uint8_t*>(out_ok), static_cast<unsigned*>(rec_scratch),
           B, mb, n, Z, E, max_iter, alpha, early_stop, nw, col_chunks, tables_bytes,
           frame_bytes, rec_offset, frames_per_block};
  cudaError_t err = set_smem(k, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(k), dim3(grid), dim3(threads), args,
                         (size_t)smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
