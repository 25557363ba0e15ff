// C51 categorical projection and fused projection + cross-entropy kernels
// for Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the three Pallas TPU kernels of d4pg_tpu/ops/pallas_projection.py:
//   c51_project          <- _projection_kernel        (categorical_projection_pallas)
//   c51_fused_loss_fwd   <- _fused_loss_kernel        (fused_categorical_loss, forward)
//   c51_fused_loss_bwd   <- _fused_loss_grad_kernel   (fused_categorical_loss, VJP)
//
// The projection is the hat-function gather of _project_tile:
//   m[b, i] = sum_j p[b, j] * max(0, 1 - |bfrac[b, j] - i|),
//   bfrac[b, j] = (clip(r[b] + d[b] * z_j, v_min, v_max) - v_min) / delta.
// The row functions live in c51_rows.cuh, so the kernels cannot drift apart
// numerically (the Pallas code's no-drift discipline): B2 calls
// project_row; B1f's body is c51::loss_row_warp, which kernel B4
// (csrc/fused_step.cu) runs too, and B1b's is c51::grad_row_warp, which
// rounds bfrac through the same c51::bfrac_at as loss_row_warp.
//
// What bounds them on an H100: at the learner's shapes (B = 256, A = 51) the
// fused forward reads q, p [B, A] and r, d [B] (about 106 KB) and writes two
// [B] vectors: ~0.03 us at 3.35 TB/s, and the arithmetic Phi needs (each
// source atom lands on at most two destinations) is far below the float32
// peak. So each launch is bound by launch latency and by the chain of
// dependent memory and reduction latencies inside one partial wave of
// blocks, not by bytes or FLOPs. None of them writes m to device memory
// (forward and backward recompute it on chip, as the Pallas kernels do in
// VMEM), and each is one launch with no workspace.
//
// Layouts:
//   - B1f and B1b: one warp per batch row, kRowsPerBlock = 4 rows a block
//     (64 blocks of 128 threads for B = 256). The warp issues the loads of
//     its row (q, p, r, d, and B1b's g_ce, g_ov) together, before Phi, so
//     that one memory latency covers them; it reduces with warp shuffles
//     only (no __syncthreads). Since ce and ov are linear in m, B1f never
//     forms m: each lane pushes its source atoms' mass onto the staged
//     (log_softmax, softmax) of the two atoms each lands between
//     (c51::loss_row_warp says why that beats a gather per destination).
//     B1b's dq needs m per destination atom: the warp forms m in its shared
//     slice by the same push, lanes that share a destination summing in
//     lane order (no atomics, so dq is deterministic), then stores dq
//     coalesced (c51::grad_row_warp).
//   - B2: one block per batch row, thread i owns destination atom i (block
//     size = A rounded up to a warp; threads past A are masked), the row's
//     p and bfrac in shared memory (p_s[A] | bfrac_s[A]), every thread
//     walks the A source atoms. Moving it onto a warp per row is queued.

#include "c51_rows.cuh"

namespace {

using namespace c51;

// Replaces _projection_kernel (categorical_projection_pallas): m = Phi(r + d*z)
// written out, [B, A].
__global__ void project_kernel(const float* __restrict__ p,
                               const float* __restrict__ r,
                               const float* __restrict__ d,
                               float* __restrict__ m, int A, float v_min,
                               float v_max, float delta) {
  extern __shared__ float smem[];
  const size_t row = (size_t)blockIdx.x * A;
  const float mi = project_row(p + row, r[blockIdx.x], d[blockIdx.x], A, v_min,
                               v_max, delta, smem, smem + A);
  if ((int)threadIdx.x < A) m[row + threadIdx.x] = mi;
}

// Replaces _fused_loss_kernel (fused_categorical_loss, forward): per row
// ce = -sum(m * log_softmax(q)), ov = |-sum(m * softmax(q))|; m stays in
// registers. One warp per row; warps past B have no row and do nothing
// (no barrier follows in the block).
template <int NPL>
__global__ void fused_loss_fwd_kernel(const float* __restrict__ q,
                                      const float* __restrict__ p,
                                      const float* __restrict__ r,
                                      const float* __restrict__ d,
                                      float* __restrict__ ce,
                                      float* __restrict__ ov, int B, int A,
                                      float v_min, float v_max, float delta) {
  extern __shared__ __align__(16) float row_stage[];
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b < B) {
    loss_row_warp<NPL>(q, p, r, d, ce, ov, b, A, v_min, v_max, delta,
                       reinterpret_cast<float2*>(row_stage) + (size_t)w * A);
  }
}

// Replaces _fused_loss_grad_kernel (the VJP of fused_categorical_loss), with
// Phi recomputed rather than saved:
//   dce/dq = softmax * sum(m) - m
//   dov/dq = sign(dot) * softmax * (m - dot),  dot = sum(m * softmax)
// One warp per row, as B1f; warps past B have no row and do nothing.
template <int NPL>
__global__ void fused_loss_bwd_kernel(const float* __restrict__ q,
                                      const float* __restrict__ p,
                                      const float* __restrict__ r,
                                      const float* __restrict__ d,
                                      const float* __restrict__ g_ce,
                                      const float* __restrict__ g_ov,
                                      float* __restrict__ dq, int B, int A,
                                      float v_min, float v_max, float delta) {
  extern __shared__ __align__(16) float row_stage[];
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b < B) {
    grad_row_warp<NPL>(q, p, r, d, g_ce, g_ov, dq, b, A, v_min, v_max, delta,
                       row_stage + (size_t)w * grad_warp_floats(A));
  }
}

}  // namespace

// C entry points. Each launches on `stream` (PyTorch's current stream),
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// so the caller can raise on a refused launch. The caller guarantees
// 2 <= A <= 1024, contiguous float32 buffers and B >= 0.

extern "C" int c51_project(const float* p, const float* r, const float* d,
                           float* m, int B, int A, float v_min, float v_max,
                           float delta, void* stream) {
  if (B > 0) {
    project_kernel<<<B, c51::threads_for(A), c51::smem_for(A),
                     (cudaStream_t)stream>>>(p, r, d, m, A, v_min, v_max,
                                             delta);
  }
  return (int)cudaGetLastError();
}

extern "C" int c51_fused_loss_fwd(const float* q, const float* p,
                                  const float* r, const float* d, float* ce,
                                  float* ov, int B, int A, float v_min,
                                  float v_max, float delta, void* stream) {
  if (B > 0) {
    const int rows = c51::kRowsPerBlock;
    c51::with_atoms_per_lane(A, [&](auto npl) {
      fused_loss_fwd_kernel<decltype(npl)::value>
          <<<(B + rows - 1) / rows, 32 * rows, c51::warp_smem_for(A),
             (cudaStream_t)stream>>>(q, p, r, d, ce, ov, B, A, v_min, v_max,
                                     delta);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int c51_fused_loss_bwd(const float* q, const float* p,
                                  const float* r, const float* d,
                                  const float* g_ce, const float* g_ov,
                                  float* dq, int B, int A, float v_min,
                                  float v_max, float delta, void* stream) {
  if (B > 0) {
    const int rows = c51::kRowsPerBlock;
    const size_t smem = rows * c51::grad_warp_floats(A) * sizeof(float);
    c51::with_atoms_per_lane(A, [&](auto npl) {
      fused_loss_bwd_kernel<decltype(npl)::value>
          <<<(B + rows - 1) / rows, 32 * rows, smem, (cudaStream_t)stream>>>(
              q, p, r, d, g_ce, g_ov, dq, B, A, v_min, v_max, delta);
    });
  }
  return (int)cudaGetLastError();
}
