// Row functions of the C51 projection and the fused projection + loss,
// shared by csrc/projection.cu (kernels B1f, B1b, B2) and
// csrc/fused_step.cu (kernel B4), as the Pallas files share
// _project_tile / loss_tile. One definition, so the kernels cannot drift.
//
// Layout of every caller: one block per batch row, thread i owns
// destination atom i, blockDim.x = A rounded up to a warp (threads past A
// are masked), dynamic shared memory p_s[A] | bfrac_s[A] | scratch[32]
// (smem_for(A) floats).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace c51 {

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
__device__ inline float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return warp_sum(lane < nwarps ? scratch[lane] : 0.f);
}

__device__ inline float block_max(float v, float* scratch) {
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
__device__ inline float project_row(const float* __restrict__ p_row, float r,
                                    float d, int A, float v_min, float v_max,
                                    float delta, float* p_s, float* bfrac_s) {
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

// Log-softmax pieces of one row of logits: returns q_i - max for the live
// threads (0 for masked ones) and writes the row's log-sum-exp of the
// shifted logits to *lse.
__device__ inline float shifted_logit(const float* __restrict__ q_row, int A,
                                      float* scratch, float* lse) {
  const bool live = (int)threadIdx.x < A;
  const float qi = live ? q_row[threadIdx.x] : -INFINITY;
  const float mx = block_max(qi, scratch);
  const float sh = live ? qi - mx : 0.f;
  *lse = logf(block_sum(live ? expf(sh) : 0.f, scratch));
  return sh;
}

// The fused forward of row b: ce[b] = -sum(m * log_softmax(q)),
// ov[b] = |-sum(m * softmax(q))|, m = Phi(r + d*z) kept in registers.
// Not inlined: kernels B1f and B4 run this one compiled body, so their
// ce/ov are bit-equal on the same inputs by construction.
__device__ __noinline__ void loss_row(const float* __restrict__ q,
                                      const float* __restrict__ p,
                                      const float* __restrict__ r,
                                      const float* __restrict__ d,
                                      float* __restrict__ ce,
                                      float* __restrict__ ov, int b, int A,
                                      float v_min, float v_max, float delta,
                                      float* smem) {
  float* scratch = smem + 2 * A;
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

inline int threads_for(int A) { return ((A + 31) / 32) * 32; }
inline size_t smem_for(int A) { return (2 * (size_t)A + 32) * sizeof(float); }

}  // namespace c51
