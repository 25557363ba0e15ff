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
// and the exclusive chunk offsets E that its count blocks searched. Pass 1
// runs 4 warps (chunks) a block and writes the chunk sums S (scratch the
// caller provides); its last block to finish computes E from S once and
// stores it. It knows it is the last by a ticket: every block takes one
// from a device counter after its sums are fenced, and the block that
// draws gridDim.x - 1 reads all of S (through L2). That block resets the counter to 0,
// so the next call, or the next replay of a CUDA graph holding this one,
// starts from 0 with no host step. Pass 2 runs 8 warps (draws) a block;
// each block loads E, as B4's count blocks do. Pass 2 is a programmatic
// dependent launch (Hopper): its blocks are scheduled while pass 1's last
// block computes E, load their prefixes, then wait (griddepcontrol.wait)
// for pass 1 to end; that hides its launch behind pass 1's tail. The fused-descent megastep
// hands E to every B4 launch of the dispatch, whose count blocks run the
// same count_draw, so B4's indices equal B3's. Both passes run the shared
// walk of per_tree.cuh.

#include <cuda/atomic>

#include "per_tree.cuh"

namespace {

constexpr int kSumWarps = 4;    // pass 1: warps (chunks) per block
constexpr int kCountWarps = 8;  // pass 2: warps (draws) per block

__global__ void chunk_sums_kernel(const float* __restrict__ leaves, int L,
                                  int nchunks, float* sums,
                                  float* __restrict__ offsets,
                                  unsigned* __restrict__ ticket) {
  __shared__ bool last;
  // Pass 2 may be scheduled now (programmatic dependent launch); it waits
  // for this grid's end before it reads E.
  asm volatile("griddepcontrol.launch_dependents;");
  const int c = blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (c < nchunks) {  // uniform across the warp
    const per_tree::Walk w = per_tree::walk_chunk(
        leaves, L, c * per_tree::kChunk, 0.f, INFINITY);
    if ((threadIdx.x & 31) == 0) sums[c] = w.run;
  }
  // The ticket: the barrier puts the block's S ahead of thread 0, whose
  // acq_rel add publishes it device-wide (release) and, in the last block,
  // orders every other block's S before that block's reads (acquire).
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> t(*ticket);
    last = t.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x < 32) {
    per_tree::store_offsets(sums, nchunks, offsets);
    if (threadIdx.x == 0) *ticket = 0u;
  }
}

__global__ void count_kernel(const float* __restrict__ leaves, int L,
                             const float* __restrict__ offsets, int nchunks,
                             const float* __restrict__ prefixes, int n,
                             int* __restrict__ idx) {
  extern __shared__ __align__(16) float E[];
  const int draw = blockIdx.x * kCountWarps + (threadIdx.x >> 5);
  const float prefix = draw < n ? prefixes[draw] : 0.f;
  // Launched while pass 1 may still run: wait for it to finish and for its
  // writes (E) to be visible. A no-op under an ordinary launch.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  per_tree::load_offsets(offsets, nchunks, E);  // every thread, a barrier
  per_tree::count_warp(leaves, L, E, nchunks, prefix, n, idx, draw);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), allocates nothing, does
// not synchronise, and returns cudaGetLastError() so the caller can raise
// on a refused launch. The caller passes contiguous buffers: leaves [L]
// f32 (L >= 1), sums [nchunks] f32 (scratch), offsets [nchunks] f32
// (written, 16-byte aligned), prefixes [n] f32, idx [n] int32 (written),
// n >= 1, and `ticket`, one uint32 that is 0 on entry and is 0 again when
// pass 1 ends: calls that share a ticket must not overlap. A chunk count
// that disagrees with kChunk, or one whose offsets exceed shared memory,
// returns cudaErrorInvalidValue.
extern "C" int per_tree_find_prefix(const float* leaves, int L, float* sums,
                                    float* offsets, int nchunks,
                                    const float* prefixes, int n, int* idx,
                                    unsigned* ticket, void* stream) {
  if (L < 1 || n < 1 || nchunks != per_tree::num_chunks(L) ||
      nchunks > per_tree::kMaxChunks) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  chunk_sums_kernel<<<(nchunks + kSumWarps - 1) / kSumWarps, 32 * kSumWarps,
                      0, s>>>(leaves, L, nchunks, sums, offsets, ticket);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // Pass 2 with programmatic stream serialization: its blocks launch while
  // pass 1's last block computes E, and load their prefixes meanwhile.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kCountWarps - 1) / kCountWarps);
  cfg.blockDim = dim3(32 * kCountWarps);
  cfg.dynamicSmemBytes = nchunks * sizeof(float);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, count_kernel, leaves, L,
                                 (const float*)offsets, nchunks, prefixes, n,
                                 idx);
}
