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
// All three kernels call the same __device__ project_row, and B1f's body is
// c51::loss_row, which kernel B4 (csrc/fused_step.cu) runs too: the row
// functions live in c51_rows.cuh, so the kernels cannot drift apart
// numerically (the Pallas code's no-drift discipline).
//
// Layout: one block per batch row, thread i owns destination atom i (block
// size = A rounded up to a warp; threads past A are masked). The row's p and
// bfrac live in shared memory and every thread walks the A source atoms.
//
// What bounds them on an H100: at the learner's shapes (B = 256, A = 51) the
// fused forward reads q, p [B, A] and r, d [B] (about 106 KB) and writes two
// [B] vectors: well under a microsecond at 3.35 TB/s, and the arithmetic
// (A^2 hat terms per row, about 4 MFLOP) is a few tens of nanoseconds at the
// float32 peak. So each launch is bound by launch latency and by one wave of
// B small blocks, not by bytes or FLOPs. The design answers that by never
// materialising m in device memory (forward and backward recompute it in
// shared memory and registers, as the Pallas kernels do in VMEM), by doing
// one launch per call with no workspace, and by reducing in-block with warp
// shuffles. Packing several rows per block, or fusing into the critic's
// output layer, is left for a later change.

#include "c51_rows.cuh"

namespace {

using namespace c51;

// Shared memory layout of every kernel: p_s[A] | bfrac_s[A] | scratch[32].

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
// registers.
__global__ void fused_loss_fwd_kernel(const float* __restrict__ q,
                                      const float* __restrict__ p,
                                      const float* __restrict__ r,
                                      const float* __restrict__ d,
                                      float* __restrict__ ce,
                                      float* __restrict__ ov, int A,
                                      float v_min, float v_max, float delta) {
  extern __shared__ float smem[];
  loss_row(q, p, r, d, ce, ov, blockIdx.x, A, v_min, v_max, delta, smem);
}

// Replaces _fused_loss_grad_kernel (the VJP of fused_categorical_loss), with
// Phi recomputed rather than saved:
//   dce/dq = softmax * sum(m) - m
//   dov/dq = sign(dot) * softmax * (m - dot),  dot = sum(m * softmax)
// sum(m) and sign(dot) are computed, not assumed, so the gradient is exact
// for unnormalized inputs too.
__global__ void fused_loss_bwd_kernel(const float* __restrict__ q,
                                      const float* __restrict__ p,
                                      const float* __restrict__ r,
                                      const float* __restrict__ d,
                                      const float* __restrict__ g_ce,
                                      const float* __restrict__ g_ov,
                                      float* __restrict__ dq, int A,
                                      float v_min, float v_max, float delta) {
  extern __shared__ float smem[];
  float* scratch = smem + 2 * A;
  const int b = blockIdx.x;
  const size_t row = (size_t)b * A;
  const bool live = (int)threadIdx.x < A;
  const float m = project_row(p + row, r[b], d[b], A, v_min, v_max, delta,
                              smem, smem + A);
  float lse;
  const float sh = shifted_logit(q + row, A, scratch, &lse);
  const float sm = live ? expf(sh - lse) : 0.f;
  const float msum = block_sum(m, scratch);
  const float dot = block_sum(m * sm, scratch);
  const float sgn = (float)((dot > 0.f) - (dot < 0.f));
  if (live) {
    dq[row + threadIdx.x] =
        g_ce[b] * (sm * msum - m) + g_ov[b] * sgn * sm * (m - dot);
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
    fused_loss_fwd_kernel<<<B, c51::threads_for(A), c51::smem_for(A),
                            (cudaStream_t)stream>>>(q, p, r, d, ce, ov, A,
                                                    v_min, v_max, delta);
  }
  return (int)cudaGetLastError();
}

extern "C" int c51_fused_loss_bwd(const float* q, const float* p,
                                  const float* r, const float* d,
                                  const float* g_ce, const float* g_ov,
                                  float* dq, int B, int A, float v_min,
                                  float v_max, float delta, void* stream) {
  if (B > 0) {
    fused_loss_bwd_kernel<<<B, c51::threads_for(A), c51::smem_for(A),
                            (cudaStream_t)stream>>>(q, p, r, d, g_ce, g_ov, dq,
                                                    A, v_min, v_max, delta);
  }
  return (int)cudaGetLastError();
}
