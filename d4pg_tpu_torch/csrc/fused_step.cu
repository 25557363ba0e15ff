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
// Grid: R = c51::kRowsPerBlock (4) warps a block, B1f's
// block size. Blocks [0, ceil(E * B / R)) are loss blocks, over the E x B
// logit rows of E stacked critics (E = 1 unstacked): warp w runs
// c51::loss_row_warp for logit row qr = blockIdx.x * R + w and target row
// qr % B, exactly as kernel B1f does. The next ceil(B / R) blocks are
// count blocks, once whatever E is (every member of the JAX package's
// vmapped step ran the same descent and it returns member 0's): every
// thread first loads the chunk offsets that the dispatch's one B3 call
// stored (4 KB at L = 2^20, 16-byte loads, one barrier), then warp w
// counts draw (blockIdx.x - ceil(E * B / R)) * R + w with
// per_tree::count_draw, exactly as B3's pass 2 does. Both halves are the __noinline__ bodies of the shared
// headers and B1f and B3 search and sum the same values, so ce/ov are
// bit-equal to B1f's and idx to B3's on the same inputs, the byte-parity
// the Pallas version gets by sharing loss_tile and count_tile.
//
// Bound on an H100 at the learner's shapes (E = 1, B = 256, A = 51, L = 2^20):
// B1f's bytes (q, p [B, A], r, d [B] in, ce, ov out: ~0.1 MB) plus the
// prefixes, the offsets (4 KB) and, in each chunk a draw lands in, the
// leaves from the chunk's start to the furthest draw (about half a chunk a
// draw: ~0.5 MB), about 0.18 us at 3.35 TB/s; the loss and count
// arithmetic is far below the float32 peak. What sets its time is the
// longest chain of dependent latencies in one partial wave. Count blocks
// that stage the offsets from the chunk sums themselves (warp 0 walking ~64
// dependent loads behind a barrier) and walk their chunk four segments a
// round trip outlast the loss blocks; here a count warp waits for the offsets
// (one round trip), a two-round ballot search in shared memory, and one
// round trip for its chunk, which one scan counts; a loss warp waits for
// one round trip of loads, then Phi and warp shuffles. The count half
// still needs one dependent round trip more than the loss half: it cannot
// know which chunk to load before it has the offsets. The backward pass is
// kernel B1b (csrc/projection.cu), as the Pallas VJP reuses
// _fused_loss_grad_kernel: the descent takes no gradient.

#include "c51_rows.cuh"
#include "per_tree.cuh"

namespace {

template <int NPL>
__global__ void fused_step_kernel(const float* __restrict__ q,
                                  const float* __restrict__ p,
                                  const float* __restrict__ r,
                                  const float* __restrict__ d,
                                  float* __restrict__ ce,
                                  float* __restrict__ ov, int E, int B,
                                  int A, float v_min, float v_max,
                                  float delta,
                                  const float* __restrict__ leaves, int L,
                                  const float* __restrict__ offsets,
                                  int nchunks,
                                  const float* __restrict__ prefixes,
                                  int* __restrict__ idx) {
  extern __shared__ __align__(16) float dyn[];
  const int rows = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int loss_blocks = (E * B + rows - 1) / rows;
  if ((int)blockIdx.x < loss_blocks) {  // uniform across the block
    const int qr = blockIdx.x * rows + w;
    if (qr < E * B) {
      c51::loss_row_warp<NPL>(q, p, r, d, ce, ov, qr, qr % B, A, v_min, v_max,
                              delta,
                              reinterpret_cast<float2*>(dyn) + (size_t)w * A);
    }
    return;
  }
  const int draw = (blockIdx.x - loss_blocks) * rows + w;
  const float prefix = draw < B ? prefixes[draw] : 0.f;
  per_tree::load_offsets(offsets, nchunks, dyn);  // every thread, a barrier
  per_tree::count_warp(leaves, L, dyn, nchunks, prefix, B, idx, draw);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), allocates nothing, does
// not synchronise, and returns cudaGetLastError() so the caller can raise
// on a refused launch. The caller passes contiguous buffers: q [E, B, A]
// and p [B, A] f32, r, d, prefixes [B] f32, ce, ov [E, B] f32 and idx [B]
// int32 (written), leaves [L] f32, offsets [nchunks] f32 from
// per_tree_find_prefix on the same leaves; 2 <= A <= 1024, E >= 1, B >= 1,
// E * B * A < 2^31.
extern "C" int c51_fused_step(const float* q, const float* p, const float* r,
                              const float* d, float* ce, float* ov, int E,
                              int B, int A, float v_min, float v_max,
                              float delta, const float* leaves, int L,
                              const float* offsets, int nchunks,
                              const float* prefixes, int* idx,
                              void* stream) {
  if (E < 1 || B < 1 || L < 1 || nchunks != per_tree::num_chunks(L) ||
      nchunks > per_tree::kMaxChunks) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = c51::kRowsPerBlock;
  const int loss_blocks = (E * B + rows - 1) / rows;
  const int count_blocks = (B + rows - 1) / rows;
  const size_t loss_smem = c51::warp_smem_for(A);
  const size_t count_smem = (size_t)nchunks * sizeof(float);
  c51::with_atoms_per_lane(A, [&](auto npl) {
    fused_step_kernel<decltype(npl)::value>
        <<<loss_blocks + count_blocks, 32 * rows,
           loss_smem > count_smem ? loss_smem : count_smem,
           (cudaStream_t)stream>>>(q, p, r, d, ce, ov, E, B, A, v_min, v_max,
                                   delta, leaves, L, offsets, nchunks,
                                   prefixes, idx);
  });
  return (int)cudaGetLastError();
}
