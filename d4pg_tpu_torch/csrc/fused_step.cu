// Kernel B4: the fused-descent step for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel of d4pg_tpu/ops/pallas_fused_step.py
// (_fused_step_kernel, called by fused_categorical_loss_descent): in one
// launch, the categorical loss of grad step t (B1f's per-row ce and ov)
// and the tree-descent counts of step t+1's B stratified prefixes (B3's
// count). The tree is constant for a whole megastep dispatch (priorities
// write back after the K steps), so every step's prefixes are known up
// front and step t can descend for step t+1.
//
// Grid: blocks [0, B) run c51::loss_row for their batch row, exactly as
// kernel B1f does; the remaining ceil(B / warps-per-block) blocks stage the
// chunk offsets from the chunk sums of the dispatch's one B3 call and count
// one draw per warp with per_tree::count_draw, exactly as B3's pass 2 does.
// Both halves are the __noinline__ bodies of the shared headers, launched
// with the same block size as B1f (A rounded up to a warp), so ce/ov are
// bit-equal to B1f's and idx to B3's on the same inputs, the byte-parity
// the Pallas version gets by sharing loss_tile and count_tile.
//
// Bound on an H100 at the learner's shapes (B = 256, A = 51, L = 2^20):
// B1f's bytes (q, p [B, A], r, d [B] in, ce, ov out: ~0.1 MB) plus the
// prefixes, the chunk sums (4 KB) and, in each chunk a draw lands in, the
// leaves from the chunk's start to the furthest draw (half a chunk on
// average: ~0.5 MB at B distinct chunks), about 0.2 us at 3.35 TB/s; the
// loss and count arithmetic is far below the float32 peak. Like B1f it is
// bound by launch latency and one partial wave in practice. The backward
// pass is kernel B1b (csrc/projection.cu), as the Pallas VJP reuses
// _fused_loss_grad_kernel: the descent takes no gradient.

#include "c51_rows.cuh"
#include "per_tree.cuh"

namespace {

__global__ void fused_step_kernel(const float* __restrict__ q,
                                  const float* __restrict__ p,
                                  const float* __restrict__ r,
                                  const float* __restrict__ d,
                                  float* __restrict__ ce,
                                  float* __restrict__ ov, int B, int A,
                                  float v_min, float v_max, float delta,
                                  const float* __restrict__ leaves, int L,
                                  const float* __restrict__ sums, int nchunks,
                                  const float* __restrict__ prefixes,
                                  int* __restrict__ idx) {
  extern __shared__ float smem[];
  if ((int)blockIdx.x < B) {
    c51::loss_row(q, p, r, d, ce, ov, blockIdx.x, A, v_min, v_max, delta,
                  smem);
    return;  // uniform across the block
  }
  per_tree::stage_offsets(sums, nchunks, smem);
  const int warps = blockDim.x >> 5;
  per_tree::count_warp(leaves, L, smem, nchunks, prefixes, B, idx,
                       (blockIdx.x - B) * warps + (threadIdx.x >> 5));
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), allocates nothing, does
// not synchronise, and returns cudaGetLastError() so the caller can raise
// on a refused launch. The caller passes contiguous buffers: q, p [B, A]
// f32, r, d, prefixes [B] f32, ce, ov [B] f32 and idx [B] int32 (written),
// leaves [L] f32, sums [nchunks] f32 from per_tree_find_prefix on the same
// leaves; 2 <= A <= 1024, B >= 1.
extern "C" int c51_fused_step(const float* q, const float* p, const float* r,
                              const float* d, float* ce, float* ov, int B,
                              int A, float v_min, float v_max, float delta,
                              const float* leaves, int L, const float* sums,
                              int nchunks, const float* prefixes, int* idx,
                              void* stream) {
  if (B < 1 || L < 1 || nchunks != per_tree::num_chunks(L) ||
      nchunks > per_tree::kMaxChunks) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = c51::threads_for(A);
  const int warps = threads / 32;
  const size_t loss_smem = c51::smem_for(A);
  const size_t count_smem = (size_t)nchunks * sizeof(float);
  const int grid = B + (B + warps - 1) / warps;
  fused_step_kernel<<<grid, threads,
                      loss_smem > count_smem ? loss_smem : count_smem,
                      (cudaStream_t)stream>>>(q, p, r, d, ce, ov, B, A, v_min,
                                              v_max, delta, leaves, L, sums,
                                              nchunks, prefixes, idx);
  return (int)cudaGetLastError();
}
