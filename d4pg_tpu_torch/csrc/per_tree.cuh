// The prefix count of the device-PER descent, shared by csrc/per_tree.cu
// (kernel B3) and csrc/fused_step.cu (kernel B4), as the Pallas files share
// count_tile. One compiled body (the __noinline__ functions below), so B4's
// indices are bit-equal to B3's on the same leaves and chunk offsets.
//
// The function (d4pg_tpu/ops/pallas_tree.py:find_prefix_pallas):
//   idx(prefix) = #{ i : cumsum(leaves)[i] <= prefix }, clamped to L - 1,
// which equals the segment tree's descent with its ">=" rule: a prefix on a
// cumsum boundary selects the next leaf, zero-mass leaves are skipped.
//
// A 4 MiB leaf array (L = 2^20) does not fit in a 227 KB block, so the
// cumsum is built in two levels:
//   pass 1 (B3's chunk_sums_kernel): one warp per chunk of kChunk leaves
//     walks it (walk_chunk) and writes the chunk's sum S[c]; the last block
//     to finish (a ticket on a device counter) computes the chunks'
//     exclusive prefix E[c] from S once and stores it (store_offsets): B3's
//     second output, which the fused-descent megastep hands to every B4
//     launch of the dispatch;
//   pass 2 (B3's count blocks, and B4's): each block loads E into shared
//     memory (load_offsets, 16-byte loads, one barrier), so B3 and B4
//     search the very same E values. Then one warp per draw finds the
//     last chunk with E[c] <= prefix (two rounds of __ballot_sync over E
//     at L = 2^20) and walks that chunk from E[c] (count_draw).
// walk_chunk gives lane l the kChunk/32 consecutive leaves
// [lo + l*kPerLane, lo + (l+1)*kPerLane), loaded 16 bytes at a time before
// any add, so a walk waits for one memory round trip; the lane sums them in
// sequence, one warp scan (__shfl_up_sync) offsets the lanes, and each
// lane counts its own leaves. The cumsum the count compares against is
// therefore
//   cs[i] = (E[c] + warp_excl_scan(lane sums)[l]) + (lane's running sum)[i],
// an order other than the tree's pairwise sums or torch.cumsum's. Scanning
// 32-leaf segments across the warp instead costs 32 scans of 6 shuffles a
// draw, which the draws of a count block serialise on their SM's shuffle
// unit; this order needs one scan a draw.
//
// Numerics (the declared caveat of pallas_tree.py:22-29, made concrete):
// every cs[i] is a sum of non-negative float32 terms, and a term's error is
// bounded by the number of adds on its path to the result. That path is at
// most  2*ceil(nchunks/32) + 5  adds inside E[c] (store_offsets: a lane's
// chunks in sequence, a warp scan of the lane totals, the lane's running
// prefix) plus, for a leaf of an earlier chunk, its chunk sum's
// kChunk/32 - 1 + 5 (a lane's leaves in sequence, the warp scan), plus 2
// (E[c] + the lane offset, + the lane's running sum): in all at most
//   chain = 2*ceil(nchunks/32) + 5 + kChunk/32 + 5 + 1,
// so |cs[i] - exact| <= chain * 2^-24 * total to first order. At L = 2^20
// (nchunks = 1024) the chain is 107: about 6.4e-6 of the total mass, a
// few leaves' width. A returned index is a valid answer when
//   cs64[idx - 1] - tol <= prefix < cs64[idx] + tol,  tol = chain*2^-24*total,
// with cs64 the float64 cumsum of the same float32 leaves (cs64[-1] = 0);
// chip_smoke.py checks exactly that at L = 2^20, and equality with the
// plain version at small L, where integer-valued leaves make every order
// exact. Zero-mass leaves sit only past the ring's fill, and the caller's
// fill clamp maps a draw that lands there back onto the last filled row.
//
// Bound on an H100 (one B3 call, L = 2^20, n = K*B = 2048 draws): the
// function must read the leaves once (4 MiB) and the prefixes, and write
// the indices and the offsets: about 1.26 us at 3.35 TB/s; the adds are
// ~1e6, nothing at the float32 peak. So it is bound by bytes. Pass 1 reads
// the leaves once from device memory; pass 2 re-reads only the chunk of
// each draw (4 KB a draw, mostly from L2, which holds the whole array).
// What holds a count warp back is latency, not bytes: the offsets, the
// search, then the chunk's leaves. Loading a whole chunk in one go makes
// the last of these one round trip instead of up to eight, and E computed
// once in pass 1 makes the first one 16-byte load a thread instead of a
// walk over S in every count block.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace per_tree {

constexpr int kChunk = 1024;          // leaves per chunk
constexpr int kPerLane = kChunk / 32; // consecutive leaves a lane walks
constexpr unsigned kFull = 0xffffffffu;

// Hillis-Steele inclusive scan of one float per lane.
__device__ __forceinline__ float warp_incl_scan(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

struct Walk {
  float run;  // running sum past the chunk
  int count;  // leaves whose cs is <= prefix
};

// One warp walks the leaves [lo, lo + kChunk) of a chunk (those below L;
// the rest count as absent) from the running sum `run`, counting
// #{i : cs[i] <= prefix} with cs as stated above, and returns the running
// sum past the chunk, run + (the lanes' scanned total). With run = 0 and
// prefix = +inf this is how pass 1 takes S[c]; pass 1 and pass 2 run this
// one body, so S[c], E and the counts share one order.
// Every lane loads its kPerLane leaves before the first add (16-byte loads
// where the lane's leaves are whole and `leaves` is 16-byte aligned, as
// the tree's are), so the walk waits for one memory round trip.
// Warp-uniform: all 32 lanes call it together.
__device__ __noinline__ Walk walk_chunk(const float* __restrict__ leaves,
                                        int L, int lo, float run,
                                        float prefix) {
  const int lane = threadIdx.x & 31;
  const int first = lo + lane * kPerLane;
  float v[kPerLane];
  if ((reinterpret_cast<size_t>(leaves) & 15) == 0 && first + kPerLane <= L) {
    const float4* src = reinterpret_cast<const float4*>(leaves + first);
#pragma unroll
    for (int t = 0; t < kPerLane / 4; ++t) {
      const float4 x = src[t];
      v[4 * t] = x.x;
      v[4 * t + 1] = x.y;
      v[4 * t + 2] = x.z;
      v[4 * t + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      v[t] = first + t < L ? leaves[first + t] : 0.f;
    }
  }
#pragma unroll
  for (int t = 1; t < kPerLane; ++t) v[t] += v[t - 1];  // lane's running sums
  const float incl = warp_incl_scan(v[kPerLane - 1]);
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
  const float base = run + excl;
  int n = 0;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    n += (first + t < L && base + v[t] <= prefix) ? 1 : 0;
  }
  const int count = (int)__reduce_add_sync(kFull, n);
  return Walk{run + __shfl_sync(kFull, incl, 31), count};
}

// Chunk sums a lane of store_offsets holds in registers at once.
constexpr int kPiece = 32;

// v[t] = s[first + t] for t < n (n <= kPiece), 0 past n, every load issued
// before the caller's first add: 16-byte loads where the piece is whole
// and 16-byte aligned. Through L2 only (__ldcg): other blocks of the same
// launch wrote s.
__device__ __forceinline__ void load_piece(const float* s, int first, int n,
                                           float (&v)[kPiece]) {
  if (n == kPiece && (reinterpret_cast<size_t>(s + first) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(s + first);
#pragma unroll
    for (int t = 0; t < kPiece / 4; ++t) {
      const float4 x = __ldcg(src + t);
      v[4 * t] = x.x;
      v[4 * t + 1] = x.y;
      v[4 * t + 2] = x.z;
      v[4 * t + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < kPiece; ++t) v[t] = t < n ? __ldcg(s + first + t) : 0.f;
  }
}

// offsets[first + t] = run, then run += v[t], for t < n (n <= kPiece): the
// lane's running prefixes, in sequence. 16-byte stores where the piece is
// whole and 16-byte aligned (lanes 128 bytes apart: a scalar store a chunk
// would touch 32 lines an instruction, four times as often).
__device__ __forceinline__ void store_piece(float* offsets, int first, int n,
                                            const float (&v)[kPiece],
                                            float& run) {
  if (n == kPiece && (reinterpret_cast<size_t>(offsets + first) & 15) == 0) {
    float4* dst = reinterpret_cast<float4*>(offsets + first);
#pragma unroll
    for (int t = 0; t < kPiece / 4; ++t) {
      float4 o;
      o.x = run;
      run += v[4 * t];
      o.y = run;
      run += v[4 * t + 1];
      o.z = run;
      run += v[4 * t + 2];
      o.w = run;
      run += v[4 * t + 3];
      dst[t] = o;
    }
  } else {
#pragma unroll
    for (int t = 0; t < kPiece; ++t) {
      if (t < n) {
        offsets[first + t] = run;
        run += v[t];
      }
    }
  }
}

// E[c] = sum of S[0..c) for c < nchunks, stored to `offsets` by one warp
// (all 32 lanes call it), in a fixed order: lane l sums its
// per = ceil(nchunks/32) consecutive chunk sums in sequence, a warp scan
// offsets the lanes, then each lane writes its running prefixes. A lane
// holds its chunk sums kPiece at a time; up to nchunks = 1024 (L = 2^20)
// that is one piece, loaded once, so E waits for one round trip to S.
__device__ __noinline__ void store_offsets(const float* sums, int nchunks,
                                           float* __restrict__ offsets) {
  const int lane = threadIdx.x & 31;
  const int per = (nchunks + 31) / 32;
  const int c0 = lane * per;
  const int own = max(0, min(per, nchunks - c0));  // chunks of this lane
  float v[kPiece];
  float t = 0.f;
  for (int base = 0; base < per; base += kPiece) {
    load_piece(sums, c0 + base, max(0, min(kPiece, own - base)), v);
#pragma unroll
    for (int k = 0; k < kPiece; ++k) {
      if (base + k < own) t += v[k];
    }
  }
  const float incl = warp_incl_scan(t);
  float run = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) run = 0.f;
  for (int base = 0; base < per; base += kPiece) {
    const int n = max(0, min(kPiece, own - base));
    if (per > kPiece) load_piece(sums, c0 + base, n, v);
    store_piece(offsets, c0 + base, n, v, run);
  }
}

// The count of one draw, for the warp that calls it: the last chunk c with
// E[c] <= prefix (c = 0 if none), then the walk inside it. Unclamped. The
// chunk is found 32 candidates a round: lanes test E at c + lane * stride,
// __ballot_sync, c moves to the highest lane that passed, stride /= 32;
// two rounds at 1024 chunks, each one shared load deep, where a binary
// search is ten. Every E[c] it settles on has E[c] <= prefix < E[c + 1]
// (E[nchunks] = +inf) for the E values it read.
__device__ __noinline__ int count_draw(const float* __restrict__ leaves, int L,
                                       const float* E, int nchunks,
                                       float prefix) {
  const int lane = threadIdx.x & 31;
  int stride = 1;
  while (stride * 32 < nchunks) stride *= 32;
  int c = 0;
  for (; stride > 0; stride /= 32) {
    const int k = c + lane * stride;
    const unsigned hit = __ballot_sync(kFull, k < nchunks && E[k] <= prefix);
    if (hit) c += (31 - __clz(hit)) * stride;
  }
  return c * kChunk + walk_chunk(leaves, L, c * kChunk, E[c], prefix).count;
}

// E[0..nchunks) from device memory (pass 1's stored offsets) into shared
// memory, by every thread of the block, in 16-byte loads where `offsets`
// is 16-byte aligned (as find_prefix allocates it). Ends in a barrier, so
// every thread of the block must call it before any warp leaves.
__device__ __forceinline__ void load_offsets(const float* __restrict__ offsets,
                                             int nchunks, float* E) {
  int done = 0;
  if ((reinterpret_cast<size_t>(offsets) & 15) == 0) {
    done = nchunks & ~3;
    const float4* src = reinterpret_cast<const float4*>(offsets);
    float4* dst = reinterpret_cast<float4*>(E);
    for (int k = threadIdx.x; k < done / 4; k += blockDim.x) dst[k] = src[k];
  }
  for (int k = done + threadIdx.x; k < nchunks; k += blockDim.x) {
    E[k] = offsets[k];
  }
  __syncthreads();
}

// Pass 2 for one draw (of n) per warp, E already in shared memory:
// idx[draw] is the count of `prefix` (prefixes[draw], loaded by the caller
// ahead of the barrier that publishes E) clamped to L - 1.
__device__ inline void count_warp(const float* __restrict__ leaves, int L,
                                  const float* E, int nchunks, float prefix,
                                  int n, int* __restrict__ idx, int draw) {
  if (draw >= n) return;  // uniform across the warp
  const int c = count_draw(leaves, L, E, nchunks, prefix);
  if ((threadIdx.x & 31) == 0) idx[draw] = c < L ? c : L - 1;
}

inline int num_chunks(int L) { return (L + kChunk - 1) / kChunk; }

// Largest chunk count whose E fits the default 48 KB of dynamic shared
// memory (L up to 12288 * 1024 leaves).
constexpr int kMaxChunks = 48 * 1024 / sizeof(float);

}  // namespace per_tree
