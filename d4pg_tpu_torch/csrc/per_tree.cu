// Kernel B3: the device-PER prefix descent for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernel of d4pg_tpu/ops/pallas_tree.py
// (_count_kernel / count_tile, called by find_prefix_pallas):
//   idx[d] = min(#{ i : cumsum(leaves)[i] <= prefixes[d] }, L - 1).
// The Pallas kernel keeps the whole leaf array in VMEM and sweeps it per
// 128-draw tile with triangular matmuls; a Hopper block cannot hold 4 MiB,
// so this is the two-pass design of per_tree.cuh (chunk sums, then one warp
// per draw searching the staged chunk offsets and counting inside one
// chunk). The design, its numerics and its bound are stated there.
//
// One C call launches both passes and writes two outputs: the indices,
// and the exclusive chunk offsets E that its count blocks searched (block 0
// stores them). The fused-descent megastep hands E to every B4 launch of
// the dispatch, whose count blocks load it and run the same count_draw, so
// B4's indices equal B3's. The chunk sums S are scratch the caller
// provides. Both passes run the shared walk of per_tree.cuh; pass 1 runs 4
// warps (chunks) a block, pass 2 8 warps (draws) a block, each block
// staging E itself.

#include "per_tree.cuh"

namespace {

constexpr int kSumWarps = 4;    // pass 1: warps (chunks) per block
constexpr int kCountWarps = 8;  // pass 2: warps (draws) per block

__global__ void chunk_sums_kernel(const float* __restrict__ leaves, int L,
                                  int nchunks, float* __restrict__ sums) {
  const int c = blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (c >= nchunks) return;  // uniform across the warp
  const per_tree::Walk w = per_tree::walk_chunk(
      leaves, L, c * per_tree::kChunk, 0.f, INFINITY);
  if ((threadIdx.x & 31) == 0) sums[c] = w.run;
}

__global__ void count_kernel(const float* __restrict__ leaves, int L,
                             const float* __restrict__ sums,
                             float* __restrict__ offsets, int nchunks,
                             const float* __restrict__ prefixes, int n,
                             int* __restrict__ idx) {
  extern __shared__ float E[];
  const int draw = blockIdx.x * kCountWarps + (threadIdx.x >> 5);
  const float prefix = draw < n ? prefixes[draw] : 0.f;
  per_tree::stage_offsets(sums, nchunks, E);
  if (blockIdx.x == 0) {
    for (int c = threadIdx.x; c < nchunks; c += blockDim.x) offsets[c] = E[c];
  }
  per_tree::count_warp(leaves, L, E, nchunks, prefix, n, idx, draw);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), allocates nothing, does
// not synchronise, and returns cudaGetLastError() so the caller can raise
// on a refused launch. The caller passes contiguous buffers: leaves [L]
// f32 (L >= 1), sums [nchunks] f32 (scratch), offsets [nchunks] f32
// (written), prefixes [n] f32, idx [n] int32 (written), n >= 1. A chunk
// count that disagrees with kChunk, or one whose offsets exceed shared
// memory, returns cudaErrorInvalidValue.
extern "C" int per_tree_find_prefix(const float* leaves, int L, float* sums,
                                    float* offsets, int nchunks,
                                    const float* prefixes, int n, int* idx,
                                    void* stream) {
  if (L < 1 || n < 1 || nchunks != per_tree::num_chunks(L) ||
      nchunks > per_tree::kMaxChunks) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  chunk_sums_kernel<<<(nchunks + kSumWarps - 1) / kSumWarps, 32 * kSumWarps,
                      0, s>>>(leaves, L, nchunks, sums);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  count_kernel<<<(n + kCountWarps - 1) / kCountWarps, 32 * kCountWarps,
                 nchunks * sizeof(float), s>>>(leaves, L, sums, offsets,
                                               nchunks, prefixes, n, idx);
  return (int)cudaGetLastError();
}
