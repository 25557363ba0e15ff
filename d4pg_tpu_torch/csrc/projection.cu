// C51 categorical projection and fused projection + cross-entropy kernels
// for Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the three Pallas TPU kernels of d4pg_tpu/ops/pallas_projection.py:
//   c51_project          <- _projection_kernel        (categorical_projection_pallas)
//   c51_fused_loss_fwd   <- _fused_loss_kernel        (fused_categorical_loss, forward)
//   c51_fused_loss_bwd   <- _fused_loss_grad_kernel   (fused_categorical_loss, VJP)
//
// The projection is the hat function of _project_tile:
//   m[b, i] = sum_j p[b, j] * max(0, 1 - |bfrac[b, j] - i|),
//   bfrac[b, j] = (clip(r[b] + d[b] * z_j, v_min, v_max) - v_min) / delta.
// The row functions live in c51_rows.cuh, so the kernels cannot drift apart
// numerically (the Pallas code's no-drift discipline): B1f's body is
// c51::loss_row_warp, which kernel B4 (csrc/fused_step.cu) runs too; B2
// and B1b form m with one body, c51::form_m_warp; every body rounds bfrac
// through c51::bfrac_at.
//
// What bounds them on an H100: at the learner's shapes (B = 256, A = 51) the
// fused forward reads q, p [B, A] and r, d [B] (about 106 KB) and writes two
// [B] vectors: ~0.03 us at 3.35 TB/s, and the arithmetic Phi needs (each
// source atom lands on at most two destinations) is far below the float32
// peak. B2 reads p, r, d and writes m [B, A]: 106 KB, a bound of 3.18e-05
// ms. So each launch is bound by launch latency and by the chain of
// dependent memory and reduction latencies inside one partial wave of
// blocks, not by bytes or FLOPs. B1f and B1b never write m to device memory
// (forward and backward recompute it on chip, as the Pallas kernels do in
// VMEM), and each kernel is one launch with no workspace.
//
// Layout: one warp per batch row, kRowsPerBlock = 4 rows a block (64
// blocks of 128 threads for B = 256). With E stacked critics (twin, REDQ)
// B1f and B1b take the E x B logit rows in one launch, row e * B + b
// reading the members' shared target row b by index (no E-fold copy of
// p): E * B / 4 blocks. Each row still forms its own m: a member shares
// its target row's m with the others, and forming it once a target row is
// a later optimisation (ROADMAP queue B). The bound grows with the rows:
// at E = 10, B = 2048, A = 51 B1f reads 4.2 MB of q and 0.42 MB of p,
// 1.4 us at 3.35 TB/s.
// The warp issues the loads of its row
// (p, r, d, and B1f's and B1b's q, B1b's g_ce, g_ov) together, before Phi,
// so that one memory latency covers them; it reduces with warp shuffles
// only (no __syncthreads).
//   - B1f: since ce and ov are linear in m, B1f never forms m: each lane
//     pushes its source atoms' mass onto the staged (log_softmax, softmax)
//     of the two atoms each lands between (c51::loss_row_warp says why
//     that beats a gather per destination).
//   - B2 and B1b need m per destination atom: the warp forms it in its
//     shared slice by the same push, lanes that share a destination
//     summing in lane order (no atomics, so m and dq are deterministic;
//     c51::form_m_warp). B2 stores m, B1b dq, lane by lane (coalesced).
//     The Pallas body gathers instead: every destination atom walks all A
//     sources, A^2 hat terms a row (1,048,576 at A = 1024), which are VPU
//     lanes on the TPU but a serial loop a thread on Hopper. A source lands
//     on at most two atoms, so the push does O(A) work a row: ceil(A / 32)
//     rounds of one bfrac, one match and one 32-post group sum a lane.

#include "c51_rows.cuh"

namespace {

using namespace c51;

// Replaces _projection_kernel (categorical_projection_pallas): m = Phi(r + d*z)
// written out, [B, A]. One warp per row; warps past B have no row and do
// nothing (no barrier follows in the block).
template <int NPL>
__global__ void project_kernel(const float* __restrict__ p,
                               const float* __restrict__ r,
                               const float* __restrict__ d,
                               float* __restrict__ m, int B, int A,
                               float v_min, float v_max, float delta) {
  extern __shared__ __align__(16) float row_stage[];
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b < B) {
    const int lane = threadIdx.x & 31;
    const size_t row = (size_t)b * A;
    const float rb = r[b], db = d[b];
    float pv[NPL];
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int i = lane + 32 * k;
      pv[k] = i < A ? p[row + i] : 0.f;
    }
    const float* msh = form_m_warp<NPL>(pv, rb, db, A, v_min, v_max, delta,
                                        row_stage + (size_t)w * m_warp_floats(A));
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int i = lane + 32 * k;
      if (i < A) m[row + i] = msh[i];
    }
  }
}

// Replaces _fused_loss_kernel (fused_categorical_loss, forward): per row
// ce = -sum(m * log_softmax(q)), ov = |-sum(m * softmax(q))|; m stays in
// registers. One warp per logit row of the E x B stacked rows (row e * B
// + b reads target row b); warps past E * B have no row and do nothing
// (no barrier follows in the block).
template <int NPL>
__global__ void fused_loss_fwd_kernel(const float* __restrict__ q,
                                      const float* __restrict__ p,
                                      const float* __restrict__ r,
                                      const float* __restrict__ d,
                                      float* __restrict__ ce,
                                      float* __restrict__ ov, int E, int B,
                                      int A, float v_min, float v_max,
                                      float delta) {
  extern __shared__ __align__(16) float row_stage[];
  const int w = threadIdx.x >> 5;
  const int qr = blockIdx.x * (blockDim.x >> 5) + w;
  if (qr < E * B) {
    loss_row_warp<NPL>(q, p, r, d, ce, ov, qr, qr % B, A, v_min, v_max, delta,
                       reinterpret_cast<float2*>(row_stage) + (size_t)w * A);
  }
}

// Replaces _fused_loss_grad_kernel (the VJP of fused_categorical_loss), with
// Phi recomputed rather than saved:
//   dce/dq = softmax * sum(m) - m
//   dov/dq = sign(dot) * softmax * (m - dot),  dot = sum(m * softmax)
// One warp per logit row of the E x B stacked rows, as B1f; warps past
// E * B have no row and do nothing.
template <int NPL>
__global__ void fused_loss_bwd_kernel(const float* __restrict__ q,
                                      const float* __restrict__ p,
                                      const float* __restrict__ r,
                                      const float* __restrict__ d,
                                      const float* __restrict__ g_ce,
                                      const float* __restrict__ g_ov,
                                      float* __restrict__ dq, int E, int B,
                                      int A, float v_min, float v_max,
                                      float delta) {
  extern __shared__ __align__(16) float row_stage[];
  const int w = threadIdx.x >> 5;
  const int qr = blockIdx.x * (blockDim.x >> 5) + w;
  if (qr < E * B) {
    grad_row_warp<NPL>(q, p, r, d, g_ce, g_ov, dq, qr, qr % B, A, v_min, v_max,
                       delta, row_stage + (size_t)w * m_warp_floats(A));
  }
}

}  // namespace

// C entry points. Each launches on `stream` (PyTorch's current stream),
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// so the caller can raise on a refused launch. The caller guarantees
// 2 <= A <= 1024, contiguous float32 buffers, B >= 0 and, for the fused
// pair, E >= 1 stacked members with E * B * A < 2^31: q and dq are
// [E, B, A], ce, ov, g_ce and g_ov [E, B], p [B, A], r and d [B].

extern "C" int c51_project(const float* p, const float* r, const float* d,
                           float* m, int B, int A, float v_min, float v_max,
                           float delta, void* stream) {
  if (B > 0) {
    const int rows = c51::kRowsPerBlock;
    const size_t smem = rows * c51::m_warp_floats(A) * sizeof(float);
    c51::with_atoms_per_lane(A, [&](auto npl) {
      project_kernel<decltype(npl)::value>
          <<<(B + rows - 1) / rows, 32 * rows, smem, (cudaStream_t)stream>>>(
              p, r, d, m, B, A, v_min, v_max, delta);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int c51_fused_loss_fwd(const float* q, const float* p,
                                  const float* r, const float* d, float* ce,
                                  float* ov, int E, int B, int A, float v_min,
                                  float v_max, float delta, void* stream) {
  if (E < 1) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int rows = c51::kRowsPerBlock;
    const int n = E * B;
    c51::with_atoms_per_lane(A, [&](auto npl) {
      fused_loss_fwd_kernel<decltype(npl)::value>
          <<<(n + rows - 1) / rows, 32 * rows, c51::warp_smem_for(A),
             (cudaStream_t)stream>>>(q, p, r, d, ce, ov, E, B, A, v_min, v_max,
                                     delta);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int c51_fused_loss_bwd(const float* q, const float* p,
                                  const float* r, const float* d,
                                  const float* g_ce, const float* g_ov,
                                  float* dq, int E, int B, int A, float v_min,
                                  float v_max, float delta, void* stream) {
  if (E < 1) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int rows = c51::kRowsPerBlock;
    const int n = E * B;
    const size_t smem = rows * c51::m_warp_floats(A) * sizeof(float);
    c51::with_atoms_per_lane(A, [&](auto npl) {
      fused_loss_bwd_kernel<decltype(npl)::value>
          <<<(n + rows - 1) / rows, 32 * rows, smem, (cudaStream_t)stream>>>(
              q, p, r, d, g_ce, g_ov, dq, E, B, A, v_min, v_max, delta);
    });
  }
  return (int)cudaGetLastError();
}
