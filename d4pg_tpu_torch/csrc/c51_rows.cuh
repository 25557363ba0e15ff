// Row functions of the C51 projection and the fused projection + loss,
// shared by csrc/projection.cu (kernels B1f, B1b, B2) and
// csrc/fused_step.cu (kernel B4), as the Pallas files share
// _project_tile / loss_tile. One definition, so the kernels cannot drift.
//
// Two layouts, one per body:
//   - project_row / shifted_logit (B1b, B2): one block per batch row,
//     thread i owns destination atom i, blockDim.x = A rounded up to a warp
//     (threads past A are masked), dynamic shared memory
//     p_s[A] | bfrac_s[A] | scratch[32] (smem_for(A) floats);
//   - loss_row_warp (B1f, and B4's loss blocks): one warp per batch row,
//     kRowsPerBlock rows a block, lane l owns atoms l, l + 32, ...;
//     each warp stages its row's (log_softmax, softmax) pairs in its own A
//     float2 of dynamic shared memory (warp_smem_for(A) bytes a block) and
//     reduces with shuffles only.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

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

// The fused forward of row b by one warp: ce[b] = -sum(m * log_softmax(q)),
// ov[b] = |-sum(m * softmax(q))|, m = Phi(r + d*z), which is never formed.
// Both sums are linear in m, and m_i = sum_j p_j * hat(bfrac_j - i), where
// hat(x) = max(0, 1 - |x|) is nonzero only at the two atoms
// lo = floor(bfrac_j) and lo + 1. So
//   sum_i m_i g_i = sum_j p_j * (hat(bfrac_j - lo) g_lo + hat(bfrac_j - lo - 1) g_lo+1)
// for g = log_softmax(q) and g = softmax(q): lane l stages g for atoms
// l, l + 32, ... in the warp's shared slice `lg` (A float2), then pushes
// the mass of its source atoms l, l + 32, ... onto their two neighbours.
// That is two shared loads a source and no search: a gather per
// destination atom costs a search for the run of sources that reach it,
// and the whole row on one lane where a terminal (d = 0) or clipped row
// sends every source to one or two atoms. NPL = ceil(A / 32) rounded up to
// a power of two (with_atoms_per_lane). All 32 lanes call it; no block
// barrier. Not inlined: kernels B1f and B4 run this one compiled body, so
// their ce/ov are bit-equal on the same inputs by construction.
template <int NPL>
__device__ __noinline__ void loss_row_warp(const float* __restrict__ q,
                                           const float* __restrict__ p,
                                           const float* __restrict__ r,
                                           const float* __restrict__ d,
                                           float* __restrict__ ce,
                                           float* __restrict__ ov, int b,
                                           int A, float v_min, float v_max,
                                           float delta, float2* lg) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)b * A;
  // Every load of the row first, so that their latencies overlap.
  const float rb = r[b], db = d[b];
  float qv[NPL], pv[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int i = lane + 32 * k;
    qv[k] = i < A ? q[row + i] : -INFINITY;
    pv[k] = i < A ? p[row + i] : 0.f;
  }
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < NPL; ++k) mx = fmaxf(mx, qv[k]);
  mx = warp_max(mx);
  float se = 0.f;
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    if (lane + 32 * k < A) se += expf(qv[k] - mx);
  }
  const float lse = logf(warp_sum(se));
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int i = lane + 32 * k;
    if (i < A) {
      const float logp = (qv[k] - mx) - lse;
      lg[i] = make_float2(logp, expf(logp));
    }
  }
  __syncwarp();
  // bfrac rounded step by step as the plain version (project_plain) rounds
  // it on the card: each product and sum on its own (no FMA contraction),
  // and the division as a multiply by the float32 reciprocal, which is how
  // ATen divides a CUDA tensor by a scalar. bfrac reaches A - 1, where one
  // ulp is up to A * 2^-24 (6e-5 at A = 1024), and one ulp of bfrac moves
  // ce by that times the gap between neighbouring logits: over the stated
  // tolerance at A = 1024 (measured on the card against float64).
  const float inv_delta = 1.f / delta;
  float ce_acc = 0.f, ov_acc = 0.f;
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int j = lane + 32 * k;
    if (j < A) {
      const float z = __fadd_rn(v_min, __fmul_rn((float)j, delta));
      const float tz = fminf(fmaxf(__fadd_rn(rb, __fmul_rn(db, z)), v_min), v_max);
      const float bf = __fmul_rn(__fsub_rn(tz, v_min), inv_delta);
      const int lo = min(max((int)floorf(bf), 0), A - 1);
      const float w0 = fmaxf(0.f, 1.f - fabsf(bf - (float)lo));
      const float2 g0 = lg[lo];
      float t_ce = w0 * g0.x, t_ov = w0 * g0.y;
      if (lo + 1 < A) {
        const float w1 = fmaxf(0.f, 1.f - fabsf(bf - (float)(lo + 1)));
        const float2 g1 = lg[lo + 1];
        t_ce += w1 * g1.x;
        t_ov += w1 * g1.y;
      }
      ce_acc += pv[k] * t_ce;
      ov_acc += pv[k] * t_ov;
    }
  }
  const float ce_sum = warp_sum(ce_acc);
  const float ov_sum = warp_sum(ov_acc);
  if (lane == 0) {
    ce[b] = -ce_sum;
    ov[b] = fabsf(-ov_sum);
  }
}

inline int threads_for(int A) { return ((A + 31) / 32) * 32; }
inline size_t smem_for(int A) { return (2 * (size_t)A + 32) * sizeof(float); }

// Warp-per-row layout: rows (warps) a block. Chosen on the card from 2, 4
// and 8 (B = 256, A = 51): 4 was the fastest for B4, whose count blocks
// take as many draws as its loss blocks take rows, and within a few
// percent of the fastest for B1f. The staging, 8 bytes an atom a row,
// stays within the default 48 KB of dynamic shared memory up to A = 1024
// (32 KB).
constexpr int kRowsPerBlock = 4;
inline size_t warp_smem_for(int A) {
  return (size_t)kRowsPerBlock * A * sizeof(float2);
}

// Calls f(std::integral_constant<int, NPL>()) with the NPL of
// loss_row_warp for A atoms (2 <= A <= 1024): ceil(A / 32) rounded up to
// a power of two, so that B1f and B4 pick the same instantiation.
template <typename F>
inline void with_atoms_per_lane(int A, F&& f) {
  if (A <= 32) f(std::integral_constant<int, 1>());
  else if (A <= 64) f(std::integral_constant<int, 2>());
  else if (A <= 128) f(std::integral_constant<int, 4>());
  else if (A <= 256) f(std::integral_constant<int, 8>());
  else if (A <= 512) f(std::integral_constant<int, 16>());
  else f(std::integral_constant<int, 32>());
}

}  // namespace c51
