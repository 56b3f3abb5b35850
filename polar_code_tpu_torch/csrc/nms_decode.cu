// Layered normalized min-sum LDPC decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `polar_code_tpu/nr/ldpc/nms_pallas.py`
// `_kernel_body` (built by `_build`, called by `decode_ldpc_nms_pallas`).  It
// computes what `polar_code_tpu_torch/nr/ldpc/decode_nms.py`
// `decode_ldpc_nms_batch` computes on the lifted circulant graph: hard
// decisions, the iteration each frame stopped at, and the final parity check.
//
// Design: one block decodes one frame; thread z owns check row z of every
// block-row (so Z <= 1024 threads).  Row z of block-row r touches, in each
// nonzero block c with shift s, the column c*Z + (z + s) mod Z: the Pallas
// kernel's roll becomes index arithmetic.  The Z rows of one block-row touch
// disjoint columns, so they update in parallel; block-rows run in order with
// a barrier between them.  Together that is the sequential row order the
// plain version computes.  The frame's LLRs and the edge tables live in
// dynamic shared memory; the messages (one a row, or one an edge under
// self-exclusion) are only ever touched by the thread that owns their row,
// so they need no barrier: they sit in shared memory when the block has room
// for them, else in global scratch the wrapper allocates, laid out [k][z] so
// a warp's accesses are contiguous.  After each iteration the block ORs its
// rows' parity failures (`__syncthreads_or`); a frame whose syndrome passes
// stops there and is never touched again, which keeps its LLRs exactly, as
// the plain version's `where(done, llr, new_llr)` does.
//
// What bounds it on this card: neither bytes (n floats in, n bytes and two
// words out a frame) nor arithmetic peak, but each frame's serial chain of
// block-rows (two dependent passes over the row's edges in shared memory, a
// barrier) times the iterations it runs; many frames per SM hide it.
//
// Exactness: the plain version's expressions, op for op, built without fast
// math and with -fmad=false: ext = llr - msg; the sign product of +-1/0
// values (exact in any order, sign(0) = 0); min1/min2; the update
// (alpha * sp) * min1 (shared) or (alpha * (sp * sign(ext))) * (|ext| == min1
// ? min2 : min1) (two-min; on a tie min2 == min1, which equals the plain
// version's leave-out-the-argmin min); llr = ext + update.  alpha is the
// float32 of the caller's value.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// column of row z's edge in block-column c with shift s (0 <= s < Z)
__device__ __forceinline__ int edge_column(int c, int s, int z, int Z) {
  const int t = z + s;
  return c * Z + (t >= Z ? t - Z : t);
}

// every thread of the block calls this: nonzero iff some row's parity fails
__device__ int syndrome_fails(const float* L, const int* rp, const int* ec, const int* es,
                              int mb, int Z, int z) {
  int bad = 0;
  for (int r = 0; r < mb; ++r) {
    int par = 0;
    for (int e = rp[r]; e < rp[r + 1]; ++e) par ^= (L[edge_column(ec[e], es[e], z, Z)] < 0.f);
    bad |= par;
  }
  return __syncthreads_or(bad);
}

__global__ void __launch_bounds__(1024) nms_decode_kernel(
    const float* __restrict__ llr_in, const int* __restrict__ row_ptr,
    const int* __restrict__ edge_col, const int* __restrict__ edge_shift,
    int8_t* __restrict__ out_hard, int* __restrict__ out_iters, uint8_t* __restrict__ out_ok,
    float* __restrict__ msg_scratch, int mb, int n, int Z, int E, int max_iter, float alpha,
    int self_exclude, int msg_smem_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* L = reinterpret_cast<float*>(smem);  // [n] working LLRs
  int* rp = reinterpret_cast<int*>(L + n);    // [mb + 1] edges of block-row r: rp[r]..rp[r+1]
  int* ec = rp + (mb + 1);                    // [E] block-column of each edge
  int* es = ec + E;                           // [E] shift of each edge, reduced mod Z
  const int frame = blockIdx.x;
  const int z = threadIdx.x;
  const int msg_rows = self_exclude ? E : mb;
  // the wrapper places the messages (`nms_cuda.py::smem_plan`): at a byte
  // offset past the LLRs and tables, or in global scratch when it passes 0
  float* msg = msg_smem_offset ? reinterpret_cast<float*>(smem + msg_smem_offset)
                               : msg_scratch + (size_t)frame * msg_rows * Z;

  const float* src = llr_in + (size_t)frame * n;
  for (int i = z; i < n; i += blockDim.x) L[i] = src[i];
  for (int i = z; i <= mb; i += blockDim.x) rp[i] = row_ptr[i];
  for (int i = z; i < E; i += blockDim.x) {
    ec[i] = edge_col[i];
    es[i] = edge_shift[i];
  }
  for (int k = 0; k < msg_rows; ++k) msg[k * Z + z] = 0.f;
  __syncthreads();

  int stopped = 0;
  int it = 0;
  for (; it < max_iter; ++it) {
    for (int r = 0; r < mb; ++r) {
      const int e0 = rp[r], e1 = rp[r + 1];
      float sp = 1.f, m1 = INFINITY, m2 = INFINITY;
      for (int e = e0; e < e1; ++e) {
        const float ext = L[edge_column(ec[e], es[e], z, Z)] - msg[(self_exclude ? e : r) * Z + z];
        sp = sp * sign_of(ext);
        const float a = fabsf(ext);
        if (self_exclude) m2 = fminf(m2, fmaxf(m1, a));  // only two-min reads min2
        m1 = fminf(m1, a);
      }
      if (self_exclude) {
        for (int e = e0; e < e1; ++e) {
          const int col = edge_column(ec[e], es[e], z, Z);
          const float ext = L[col] - msg[e * Z + z];
          const float u = (alpha * (sp * sign_of(ext))) * (fabsf(ext) == m1 ? m2 : m1);
          msg[e * Z + z] = u;
          L[col] = ext + u;
        }
      } else {
        const float prev = msg[r * Z + z];
        const float u = (alpha * sp) * m1;
        for (int e = e0; e < e1; ++e) {
          const int col = edge_column(ec[e], es[e], z, Z);
          L[col] = (L[col] - prev) + u;
        }
        msg[r * Z + z] = u;
      }
      __syncthreads();
    }
    if (!syndrome_fails(L, rp, ec, es, mb, Z, z)) {
      stopped = 1;
      break;
    }
  }
  // a frame that never stopped reports the check of its final LLRs: the
  // last iteration's, or the input's when max_iter is 0
  const int ok = stopped || (max_iter == 0 && !syndrome_fails(L, rp, ec, es, mb, Z, z));

  int8_t* hard = out_hard + (size_t)frame * n;
  for (int i = z; i < n; i += blockDim.x) hard[i] = L[i] < 0.f ? 1 : 0;
  if (z == 0) {
    out_iters[frame] = stopped ? it + 1 : max_iter;
    out_ok[frame] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int nms_decode_launch(const void* llr, const void* row_ptr, const void* edge_col,
                                 const void* edge_shift, void* out_hard, void* out_iters,
                                 void* out_ok, void* msg_scratch, int B, int mb, int n, int Z,
                                 int E, int max_iter, float alpha, int self_exclude,
                                 int msg_smem_offset, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  nms_decode_kernel<<<B, Z, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<const int*>(row_ptr),
      static_cast<const int*>(edge_col), static_cast<const int*>(edge_shift),
      static_cast<int8_t*>(out_hard), static_cast<int*>(out_iters),
      static_cast<uint8_t*>(out_ok), static_cast<float*>(msg_scratch), mb, n, Z, E, max_iter,
      alpha, self_exclude, msg_smem_offset);
  return (int)cudaGetLastError();
}

extern "C" const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
