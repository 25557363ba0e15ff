// The prefix count of the device-PER descent, shared by csrc/per_tree.cu
// (kernel B3) and csrc/fused_step.cu (kernel B4), as the Pallas files share
// count_tile. One compiled body (the __noinline__ functions below), so B4's
// indices are bit-equal to B3's on the same leaves and chunk sums.
//
// The function (d4pg_tpu/ops/pallas_tree.py:find_prefix_pallas):
//   idx(prefix) = #{ i : cumsum(leaves)[i] <= prefix }, clamped to L - 1,
// which equals the segment tree's descent with its ">=" rule: a prefix on a
// cumsum boundary selects the next leaf, zero-mass leaves are skipped.
//
// A 4 MiB leaf array (L = 2^20) does not fit in a 227 KB block, so the
// cumsum is built in two levels:
//   pass 1 (chunk_sums_kernel): one warp per chunk of kChunk leaves walks
//     it in 32-leaf segments and writes the chunk's sum S[c];
//   pass 2 (count blocks of B3 and B4): each block stages the chunks'
//     exclusive prefix E[c] in shared memory (stage_offsets); one warp per
//     draw binary-searches the last chunk with E[c] <= prefix, then walks
//     that chunk from E[c] in the same 32-leaf segments, counting with a
//     warp scan (__shfl_up_sync) and __ballot_sync / __popc.
// The cumsum the count compares against is therefore
//   cs[i] = E[c] + (running sum of whole segments) + warp_scan(segment)[i],
// an order other than the tree's pairwise sums or torch.cumsum's.
//
// Numerics (the declared caveat of pallas_tree.py:22-29, made concrete):
// every cs[i] is a sum of non-negative float32 terms along a chain of at
// most  2*ceil(nchunks/32) + 5  additions for E[c] (stage_offsets: a lane's
// chunks in sequence, a warp scan of the lane totals, the lane's running
// prefix) plus  kChunk/32 + 5 + 1  for the walk (segments in sequence, a
// warp scan, the final add), so |cs[i] - exact| <= chain * 2^-24 * total
// to first order. At L = 2^20 (nchunks = 1024) the chain is 107: about
// 6.4e-6 of the total mass, a few leaves' width. A returned index is a
// valid answer when
//   cs64[idx - 1] - tol <= prefix < cs64[idx] + tol,  tol = chain*2^-24*total,
// with cs64 the float64 cumsum of the same float32 leaves (cs64[-1] = 0);
// chip_smoke.py checks exactly that at L = 2^20, and equality with the
// plain version at small L, where integer-valued leaves make every order
// exact. Zero-mass leaves sit only past the ring's fill, and the caller's
// fill clamp maps a draw that lands there back onto the last filled row.
//
// Bound on an H100 (one B3 call, L = 2^20, n = K*B = 2048 draws): the
// function must read the leaves once (4 MiB) and the prefixes, and write
// the indices: about 1.26 us at 3.35 TB/s; the adds are ~1e6, nothing at
// the float32 peak. So it is bound by bytes. Pass 1 reads the leaves once
// from device memory; pass 2 re-reads only the chunk of each draw (8 KB a
// draw, mostly from L2, which holds the whole array).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace per_tree {

constexpr int kChunk = 1024;          // leaves per chunk
constexpr int kSegs = kChunk / 32;    // 32-leaf warp segments per chunk
constexpr int kUnroll = 4;            // segments loaded ahead per step

// Hillis-Steele inclusive scan of one float per lane.
__device__ __forceinline__ float warp_incl_scan(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

struct Walk {
  float run;  // running sum where the walk stopped
  int count;  // leaves whose running cumsum is <= prefix
};

// One warp walks the leaves [lo, lo + kChunk) of a chunk (those below L;
// the rest count as absent) from the running sum `run`, in 32-leaf
// segments, counting #{i : run + cumsum within the chunk up to i <=
// prefix}. The walk stops at the first segment whose start already exceeds
// `prefix` (the running sum only grows, so nothing after it counts); with
// prefix = +inf it walks the whole chunk, which is how pass 1 takes S[c]
// (from run = 0).
// Warp-uniform: all 32 lanes call it together.
__device__ __noinline__ Walk walk_chunk(const float* __restrict__ leaves,
                                        int L, int lo, float run,
                                        float prefix) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int s = 0; s < kSegs; s += kUnroll) {
    if (run > prefix) break;  // uniform: run is the same in every lane
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = lo + (s + u) * 32 + lane;
      v[u] = i < L ? leaves[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = lo + (s + u) * 32 + lane;
      const float incl = warp_incl_scan(v[u]);
      n += __popc(__ballot_sync(0xffffffffu, i < L && run + incl <= prefix));
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  return Walk{run, n};
}

// E[c] = sum of S[0..c) for c < nchunks, into shared memory; every thread
// of the block calls it (it ends in a barrier). Warp 0 does the work in a
// fixed order: lane l sums its ceil(nchunks/32) consecutive chunk sums in
// sequence, a warp scan offsets the lanes, then each lane writes its
// running prefixes. Deterministic, so every block (of B3 and of B4) stages
// the same E from the same S.
__device__ __noinline__ void stage_offsets(const float* __restrict__ sums,
                                           int nchunks, float* E) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (nchunks + 31) / 32;
    const int c0 = lane * per;
    float t = 0.f;
    for (int j = 0; j < per; ++j) {
      if (c0 + j < nchunks) t += sums[c0 + j];
    }
    const float incl = warp_incl_scan(t);
    float run = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) run = 0.f;
    for (int j = 0; j < per; ++j) {
      if (c0 + j < nchunks) {
        E[c0 + j] = run;
        run += sums[c0 + j];
      }
    }
  }
  __syncthreads();
}

// The count of one draw, for the warp that calls it: the last chunk c with
// E[c] <= prefix (E[0] = 0), then the walk inside it. Unclamped.
__device__ __noinline__ int count_draw(const float* __restrict__ leaves, int L,
                                       const float* E, int nchunks,
                                       float prefix) {
  int lo = 0, hi = nchunks;  // E[lo] <= prefix < E[hi] (E[nchunks] = +inf)
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (E[mid] <= prefix) lo = mid; else hi = mid;
  }
  return lo * kChunk + walk_chunk(leaves, L, lo * kChunk, E[lo], prefix).count;
}

// Pass 2 for one draw (of n) per warp, E already staged: idx[draw] is the
// count clamped to L - 1.
__device__ inline void count_warp(const float* __restrict__ leaves, int L,
                                  const float* E, int nchunks,
                                  const float* __restrict__ prefixes, int n,
                                  int* __restrict__ idx, int draw) {
  if (draw >= n) return;  // uniform across the warp
  const int c = count_draw(leaves, L, E, nchunks, prefixes[draw]);
  if ((threadIdx.x & 31) == 0) idx[draw] = c < L ? c : L - 1;
}

inline int num_chunks(int L) { return (L + kChunk - 1) / kChunk; }

// Largest chunk count whose E fits the default 48 KB of dynamic shared
// memory (L up to 12288 * 1024 leaves).
constexpr int kMaxChunks = 48 * 1024 / sizeof(float);

}  // namespace per_tree
