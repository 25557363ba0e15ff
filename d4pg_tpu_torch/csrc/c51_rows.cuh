// Row functions of the C51 projection and the fused projection + loss,
// shared by csrc/projection.cu (kernels B1f, B1b, B2) and
// csrc/fused_step.cu (kernel B4), as the Pallas files share
// _project_tile / loss_tile. One definition, so the kernels cannot drift.
//
// One layout for every body: one warp per batch row, kRowsPerBlock rows a
// block, lane l owns atoms l, l + 32, ...; each warp stages what its row
// needs in its own slice of dynamic shared memory and reduces with
// shuffles only. loss_row_warp is the body of B1f and of B4's loss blocks;
// form_m_warp forms m per destination atom for B2 (which stores it) and
// for B1b (grad_row_warp, which differentiates it). Every body rounds
// bfrac through bfrac_at.
//
// Stacked critics (E members, the JAX package's vmap over the critic
// stack): the logits and everything indexed like them (q, dq, ce, ov,
// g_ce, g_ov) are [E, B, ...], the target side (p, r, d) is [B, ...] and
// shared by the members. A body takes two row indices: qr, the row of the
// logits (e * B + b), and b, the target row it reads. E = 1 is qr == b,
// the unstacked launch, with the same arithmetic bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace c51 {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// bfrac of source atom j, (clip(r + d*z_j, v_min, v_max) - v_min) / delta,
// rounded step by step as the plain version (project_plain) rounds it on
// the card: each product and sum on its own (no FMA contraction), and the
// division as a multiply by the float32 reciprocal inv_delta, which is how
// ATen divides a CUDA tensor by a scalar. bfrac reaches A - 1, where one
// ulp is up to A * 2^-24 (6e-5 at A = 1024); one ulp moves B1f's ce by that
// times the gap between neighbouring logits and B1b's m (and so dq) by that
// times p_j: over the stated tolerance at A = 1024 (measured on the card,
// for B1f, B1b and B2). The forward (loss_row_warp) and form_m_warp (B2,
// and the backward through grad_row_warp) all call it, so the backward
// differentiates the very Phi the forward computed, and B2 writes it.
__device__ __forceinline__ float bfrac_at(int j, float r, float d, float v_min,
                                          float v_max, float delta,
                                          float inv_delta) {
  const float z = __fadd_rn(v_min, __fmul_rn((float)j, delta));
  const float tz = fminf(fmaxf(__fadd_rn(r, __fmul_rn(d, z)), v_min), v_max);
  return __fmul_rn(__fsub_rn(tz, v_min), inv_delta);
}

// The row's max logit (.x) and log-sum-exp of the shifted logits (.y), by
// one warp: lane l holds the logits of atoms l, l + 32, ... (-inf past A).
template <int NPL>
__device__ __forceinline__ float2 row_max_lse(const float (&qv)[NPL], int A) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < NPL; ++k) mx = fmaxf(mx, qv[k]);
  mx = warp_max(mx);
  float se = 0.f;
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    if (lane + 32 * k < A) se += expf(qv[k] - mx);
  }
  return make_float2(mx, logf(warp_sum(se)));
}

// The fused forward of logit row qr (target row b) by one warp:
// ce[qr] = -sum(m * log_softmax(q)), ov[qr] = |-sum(m * softmax(q))|,
// m = Phi(r[b] + d[b]*z) from p[b], which is never formed.
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
                                           float* __restrict__ ov, int qr,
                                           int b, int A, float v_min,
                                           float v_max, float delta,
                                           float2* lg) {
  const int lane = threadIdx.x & 31;
  const size_t qrow = (size_t)qr * A, prow = (size_t)b * A;
  // Every load of the row first, so that their latencies overlap.
  const float rb = r[b], db = d[b];
  float qv[NPL], pv[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int i = lane + 32 * k;
    qv[k] = i < A ? q[qrow + i] : -INFINITY;
    pv[k] = i < A ? p[prow + i] : 0.f;
  }
  const float2 ml = row_max_lse<NPL>(qv, A);
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int i = lane + 32 * k;
    if (i < A) {
      const float logp = (qv[k] - ml.x) - ml.y;
      lg[i] = make_float2(logp, expf(logp));
    }
  }
  __syncwarp();
  const float inv_delta = 1.f / delta;
  float ce_acc = 0.f, ov_acc = 0.f;
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int j = lane + 32 * k;
    if (j < A) {
      const float bf = bfrac_at(j, rb, db, v_min, v_max, delta, inv_delta);
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
    ce[qr] = -ce_sum;
    ov[qr] = fabsf(-ov_sum);
  }
}

// m = Phi(r + d*z) of one row by one warp, the body kernels B2 and B1b
// share (_project_tile). pv holds the lane's p (0 past A), rb and db the
// row's r and d. A Bellman-mapped source atom lands on at most two
// destination atoms, so the warp pushes each source onto them, O(A) work a
// row with no float atomics, into its shared slice `ws` (part[32] float2 |
// m[A], m_warp_floats(A) floats): in round k lane l takes source
// j = l + 32k, rounds bfrac_j through bfrac_at and splits p_j onto
// lo = floor(bfrac_j) and lo + 1 with the hat weights; the lanes whose
// sources share lo (__match_any_sync) are a group. Every lane posts its two
// parts, then sums its group's parts in lane order in one unrolled pass
// over the 32 posts (loads issued together, whatever the group's size: a
// terminal or clipped row sends a whole round to one atom), and the
// group's lowest lane adds the sums to m[lo], then to m[lo + 1]. Groups
// have distinct lo, so no two lanes write one atom in a phase. Each m_i is
// the same sum in the same order on every call, so m is bit-equal across
// calls. Returns m, ws + 64, complete and visible to every lane. All 32
// lanes call it; no block barrier.
// Inlined. A __noinline__ body, one compiled body for both kernels, was
// timed on the card (PERF.md, section 6): with no stack frame, it cost
// B1b 0.17 us at A = 51 and B2 0.3 us at A = 51 and 9 us at A = 1024
// (likely the call waiting for every load in flight and the shared slice
// reached through generic addresses; the machine code was not read).
// Inlined, B2's m is still the m B1b differentiates: both run this
// source, where bfrac_at rounds each step explicitly and the only other
// products (p_j times a hat weight) are posted to shared memory before
// they are summed, so no multiply feeds an add that the compiler could
// contract in one kernel and not in the other.
template <int NPL>
__device__ __forceinline__ const float* form_m_warp(const float (&pv)[NPL],
                                                    float rb, float db, int A,
                                                    float v_min, float v_max,
                                                    float delta, float* ws) {
  const int lane = threadIdx.x & 31;
  const float inv_delta = 1.f / delta;
  float2* part = reinterpret_cast<float2*>(ws);
  float* msh = ws + 64;
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    if (lane + 32 * k < A) msh[lane + 32 * k] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    if (32 * k >= A) break;  // uniform: no source left in any lane
    const int j = lane + 32 * k;
    int lo = -1;  // no source: a group of its own that writes nothing
    float c0 = 0.f, c1 = 0.f;
    if (j < A) {
      const float bf = bfrac_at(j, rb, db, v_min, v_max, delta, inv_delta);
      lo = min(max((int)floorf(bf), 0), A - 1);
      c0 = pv[k] * fmaxf(0.f, 1.f - fabsf(bf - (float)lo));
      if (lo + 1 < A) c1 = pv[k] * fmaxf(0.f, 1.f - fabsf(bf - (float)(lo + 1)));
    }
    const unsigned grp = __match_any_sync(kFull, lo);
    part[lane] = make_float2(c0, c1);
    __syncwarp();  // also orders the previous round's writes of m
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      if ((grp >> t) & 1u) {
        const float2 c = part[t];
        s0 += c.x;
        s1 += c.y;
      }
    }
    const bool lead = lo >= 0 && lane == __ffs(grp) - 1;
    if (lead) msh[lo] += s0;
    __syncwarp();
    if (lead && lo + 1 < A) msh[lo + 1] += s1;
    __syncwarp();
  }
  return msh;
}

// The fused backward of logit row qr (target row b) by one warp (kernel
// B1b), the VJP of
// loss_row_warp's (ce, ov) for cotangents (g_ce, g_ov), Phi recomputed
// (_fused_loss_grad_kernel):
//   dq_i = g_ce * (softmax_i * sum(m) - m_i)
//        + g_ov * sign(dot) * softmax_i * (m_i - dot),  dot = sum(m * softmax).
// sum(m) and sign(dot) are computed, not assumed, so dq is exact for
// unnormalized p too. Unlike the forward, dq needs m_i for every
// destination atom: form_m_warp forms m in the warp's shared slice `ws`,
// rounding bfrac as the forward does, so the backward differentiates the
// forward's Phi, and dq is bit-equal across calls. The row's loads are
// issued together before Phi, sum(m) and dot come from shuffles, and dq is
// stored lane by lane (coalesced). All 32 lanes call it; no block barrier.
template <int NPL>
__device__ __forceinline__ void grad_row_warp(
    const float* __restrict__ q, const float* __restrict__ p,
    const float* __restrict__ r, const float* __restrict__ d,
    const float* __restrict__ g_ce, const float* __restrict__ g_ov,
    float* __restrict__ dq, int qr, int b, int A, float v_min, float v_max,
    float delta, float* ws) {
  const int lane = threadIdx.x & 31;
  const size_t qrow = (size_t)qr * A, prow = (size_t)b * A;
  const float rb = r[b], db = d[b], gce = g_ce[qr], gov = g_ov[qr];
  float qv[NPL], pv[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int i = lane + 32 * k;
    qv[k] = i < A ? q[qrow + i] : -INFINITY;
    pv[k] = i < A ? p[prow + i] : 0.f;
  }
  const float2 ml = row_max_lse<NPL>(qv, A);
  float sm[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) sm[k] = expf((qv[k] - ml.x) - ml.y);  // 0 past A
  const float* msh = form_m_warp<NPL>(pv, rb, db, A, v_min, v_max, delta, ws);
  float m[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    m[k] = lane + 32 * k < A ? msh[lane + 32 * k] : 0.f;
  }
  float ms = 0.f, dt = 0.f;
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    if (lane + 32 * k < A) {
      ms += m[k];
      dt += m[k] * sm[k];
    }
  }
  const float msum = warp_sum(ms);
  const float dot = warp_sum(dt);
  const float sgn = (float)((dot > 0.f) - (dot < 0.f));
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int i = lane + 32 * k;
    if (i < A) {
      dq[qrow + i] = gce * (sm[k] * msum - m[k]) + gov * sgn * sm[k] * (m[k] - dot);
    }
  }
}

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

// Floats of form_m_warp's shared slice per warp (row); even, so that
// every warp's slice starts 8-byte aligned for its float2 staging.
__host__ __device__ inline int m_warp_floats(int A) {
  return 64 + A + (A & 1);
}

// Calls f(std::integral_constant<int, NPL>()) with the NPL of the warp
// bodies for A atoms (2 <= A <= 1024): ceil(A / 32) rounded up to a power
// of two, so that B1f and B4 pick the same instantiation, and B2 and B1b.
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
