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
// All three kernels call the same __device__ project_row, so they cannot
// drift apart numerically (the Pallas code's no-drift discipline).
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

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max, result broadcast to every thread. blockDim.x is a
// multiple of 32; `scratch` holds 32 floats of shared memory. The leading
// barrier keeps a previous reduction's readers ahead of this one's writers.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return warp_sum(lane < nwarps ? scratch[lane] : 0.f);
}

__device__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return warp_max(lane < nwarps ? scratch[lane] : -INFINITY);
}

// Phi(r + d*z) for one row: returns m[i] for this thread's atom (0 for the
// masked threads past A). Stages p and bfrac of the row in shared memory.
__device__ float project_row(const float* __restrict__ p_row, float r, float d,
                             int A, float v_min, float v_max, float delta,
                             float* p_s, float* bfrac_s) {
  for (int j = threadIdx.x; j < A; j += blockDim.x) {
    const float z = v_min + (float)j * delta;
    const float tz = fminf(fmaxf(r + d * z, v_min), v_max);
    bfrac_s[j] = (tz - v_min) / delta;
    p_s[j] = p_row[j];
  }
  __syncthreads();
  float acc = 0.f;
  if ((int)threadIdx.x < A) {
    const float fi = (float)threadIdx.x;
    for (int j = 0; j < A; ++j) {
      acc += p_s[j] * fmaxf(0.f, 1.f - fabsf(bfrac_s[j] - fi));
    }
  }
  return acc;
}

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

// Log-softmax pieces of one row of logits: returns q_i - max for the live
// threads (0 for masked ones) and writes the row's log-sum-exp of the
// shifted logits to *lse.
__device__ float shifted_logit(const float* __restrict__ q_row, int A,
                               float* scratch, float* lse) {
  const bool live = (int)threadIdx.x < A;
  const float qi = live ? q_row[threadIdx.x] : -INFINITY;
  const float mx = block_max(qi, scratch);
  const float sh = live ? qi - mx : 0.f;
  *lse = logf(block_sum(live ? expf(sh) : 0.f, scratch));
  return sh;
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
  float* scratch = smem + 2 * A;
  const int b = blockIdx.x;
  const size_t row = (size_t)b * A;
  const bool live = (int)threadIdx.x < A;
  const float m = project_row(p + row, r[b], d[b], A, v_min, v_max, delta,
                              smem, smem + A);
  float lse;
  const float sh = shifted_logit(q + row, A, scratch, &lse);
  const float logp = sh - lse;
  const float ce_sum = block_sum(live ? m * logp : 0.f, scratch);
  const float ov_sum = block_sum(live ? m * expf(logp) : 0.f, scratch);
  if (threadIdx.x == 0) {
    ce[b] = -ce_sum;
    ov[b] = fabsf(-ov_sum);
  }
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

inline int threads_for(int A) { return ((A + 31) / 32) * 32; }
inline size_t smem_for(int A) { return (2 * (size_t)A + 32) * sizeof(float); }

}  // namespace

// C entry points. Each launches on `stream` (PyTorch's current stream),
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// so the caller can raise on a refused launch. The caller guarantees
// 2 <= A <= 1024, contiguous float32 buffers and B >= 0.

extern "C" int c51_project(const float* p, const float* r, const float* d,
                           float* m, int B, int A, float v_min, float v_max,
                           float delta, void* stream) {
  if (B > 0) {
    project_kernel<<<B, threads_for(A), smem_for(A), (cudaStream_t)stream>>>(
        p, r, d, m, A, v_min, v_max, delta);
  }
  return (int)cudaGetLastError();
}

extern "C" int c51_fused_loss_fwd(const float* q, const float* p,
                                  const float* r, const float* d, float* ce,
                                  float* ov, int B, int A, float v_min,
                                  float v_max, float delta, void* stream) {
  if (B > 0) {
    fused_loss_fwd_kernel<<<B, threads_for(A), smem_for(A),
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
    fused_loss_bwd_kernel<<<B, threads_for(A), smem_for(A),
                            (cudaStream_t)stream>>>(q, p, r, d, g_ce, g_ov, dq,
                                                    A, v_min, v_max, delta);
  }
  return (int)cudaGetLastError();
}
