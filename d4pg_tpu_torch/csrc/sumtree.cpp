// Native segment trees for prioritized replay: the port's own copy of the
// JAX package's native/sumtree.cpp (same C ABI, same arithmetic), so the
// port neither reads nor builds a file outside d4pg_tpu_torch/.
//
// Host code, built with g++ (not nvcc) by d4pg_tpu_torch/replay/native.py
// into d4pg_tpu_torch/_build/. Its name ends in .cpp so the nvcc builds of
// csrc/*.cu never pick it up.
//
// The host-side PER trees must keep up with the learner from plain CPU
// code. Layout matches d4pg_tpu_torch/replay/segment_tree.py: tree[1] is
// the root, leaves at [capacity, 2*capacity). Batched ops are scalar
// loops here: O(log C) per element with no interpreter overhead, which
// beats the vectorized-NumPy level passes at typical batch sizes (256) and
// large capacities (1e6).
//
// Exposed via a C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Tree {
  int64_t capacity;       // power of two
  bool is_min;
  std::vector<double> v;  // size 2*capacity

  double combine(double a, double b) const {
    return is_min ? std::min(a, b) : a + b;
  }
};

int64_t next_pow2(int64_t n) {
  int64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

void* st_create(int64_t capacity, int is_min) {
  Tree* t = new Tree();
  t->capacity = next_pow2(capacity);
  t->is_min = is_min != 0;
  double neutral = is_min ? std::numeric_limits<double>::infinity() : 0.0;
  t->v.assign(2 * t->capacity, neutral);
  return t;
}

void st_destroy(void* h) { delete static_cast<Tree*>(h); }

int64_t st_capacity(void* h) { return static_cast<Tree*>(h)->capacity; }

void st_set(void* h, const int64_t* idx, const double* vals, int64_t n) {
  Tree* t = static_cast<Tree*>(h);
  for (int64_t i = 0; i < n; ++i) {
    int64_t pos = idx[i] + t->capacity;
    t->v[pos] = vals[i];
    for (pos >>= 1; pos >= 1; pos >>= 1) {
      t->v[pos] = t->combine(t->v[2 * pos], t->v[2 * pos + 1]);
    }
  }
}

void st_get(void* h, const int64_t* idx, double* out, int64_t n) {
  Tree* t = static_cast<Tree*>(h);
  for (int64_t i = 0; i < n; ++i) out[i] = t->v[idx[i] + t->capacity];
}

double st_root(void* h) { return static_cast<Tree*>(h)->v[1]; }

// Batched proportional-sampling descent; boundary convention matches the
// NumPy tree (prefix == left-subtree mass goes right, skipping zero leaves).
void st_find_prefix(void* h, const double* prefixes, int64_t* out, int64_t n) {
  Tree* t = static_cast<Tree*>(h);
  for (int64_t i = 0; i < n; ++i) {
    double p = prefixes[i];
    int64_t pos = 1;
    while (pos < t->capacity) {
      double left = t->v[2 * pos];
      if (p >= left) {
        p -= left;
        pos = 2 * pos + 1;
      } else {
        pos = 2 * pos;
      }
    }
    out[i] = pos - t->capacity;
  }
}

// ------------------------------------------------------------- data plane
// Fused stratified-sample + gather: ONE call per learner dispatch does the
// K·B prefix-sum descents, the IS-weight computation, the generation-stamp
// capture, and the row gather of every transition field into caller-owned
// staging buffers. Replaces (descent call + 5 NumPy fancy-index gathers +
// np.stack + weight vector math) per dispatch — the Python-side data-plane
// cost Ape-X/Reverb identify as the throughput wall of distributed PER.
//
// prefixes are caller-generated (NumPy Generator) so the seeded draw stream
// is byte-identical to the NumPy oracle path. Draw j is dealt round-robin
// into output row (j % K)·B + j/K, i.e. contiguous [K, B] blocks whose
// batch i equals the NumPy path's flat[i::K] slice.
//
// obs_mode: 0 = float32 rows copied as-is; 1 = uint8 rows decoded to
// float32/255 (quantized pixel replay, decode-on-sample); 2 = uint8 rows
// copied raw (uint8 wire format — dequantized in-jit on device).
void st_sample_gather(void* sum_h, void* min_h, const double* prefixes,
                      int64_t n, int64_t deal_k, int64_t size, double beta,
                      const void* obs, const float* action,
                      const float* reward, const void* next_obs,
                      const float* discount, const int64_t* gen,
                      int64_t obs_dim, int64_t act_dim, int obs_mode,
                      int64_t* idx_out, int64_t* gen_out, float* w_out,
                      void* obs_out, float* act_out, float* rew_out,
                      void* next_obs_out, float* disc_out) {
  Tree* st = static_cast<Tree*>(sum_h);
  Tree* mt = static_cast<Tree*>(min_h);
  const double total = st->v[1];
  // Max IS weight from the min tree, same expression order as the NumPy
  // path so the f64 rounding (and the final f32 cast) agree exactly.
  const double max_w = std::pow((mt->v[1] / total) * (double)size, -beta);
  const int64_t bsz = n / deal_k;
  const float* obs_f = static_cast<const float*>(obs);
  const float* nobs_f = static_cast<const float*>(next_obs);
  const uint8_t* obs_u = static_cast<const uint8_t*>(obs);
  const uint8_t* nobs_u = static_cast<const uint8_t*>(next_obs);
  float* obs_out_f = static_cast<float*>(obs_out);
  float* nobs_out_f = static_cast<float*>(next_obs_out);
  uint8_t* obs_out_u = static_cast<uint8_t*>(obs_out);
  uint8_t* nobs_out_u = static_cast<uint8_t*>(next_obs_out);
  for (int64_t j = 0; j < n; ++j) {
    double p = prefixes[j];
    int64_t pos = 1;
    while (pos < st->capacity) {
      const double left = st->v[2 * pos];
      if (p >= left) {
        p -= left;
        pos = 2 * pos + 1;
      } else {
        pos = 2 * pos;
      }
    }
    int64_t idx = pos - st->capacity;
    if (idx > size - 1) idx = size - 1;
    const int64_t r = (j % deal_k) * bsz + j / deal_k;
    idx_out[r] = idx;
    gen_out[r] = gen[idx];
    const double prob = st->v[st->capacity + idx] / total;
    w_out[r] = (float)(std::pow(prob * (double)size, -beta) / max_w);
    rew_out[r] = reward[idx];
    disc_out[r] = discount[idx];
    std::memcpy(act_out + r * act_dim, action + idx * act_dim,
                act_dim * sizeof(float));
    if (obs_mode == 0) {
      std::memcpy(obs_out_f + r * obs_dim, obs_f + idx * obs_dim,
                  obs_dim * sizeof(float));
      std::memcpy(nobs_out_f + r * obs_dim, nobs_f + idx * obs_dim,
                  obs_dim * sizeof(float));
    } else if (obs_mode == 1) {
      const uint8_t* so = obs_u + idx * obs_dim;
      const uint8_t* sn = nobs_u + idx * obs_dim;
      float* dofs = obs_out_f + r * obs_dim;
      float* dnxt = nobs_out_f + r * obs_dim;
      for (int64_t c = 0; c < obs_dim; ++c) {
        dofs[c] = (float)so[c] / 255.0f;
        dnxt[c] = (float)sn[c] / 255.0f;
      }
    } else {
      std::memcpy(obs_out_u + r * obs_dim, obs_u + idx * obs_dim, obs_dim);
      std::memcpy(nobs_out_u + r * obs_dim, nobs_u + idx * obs_dim, obs_dim);
    }
  }
}

// Batched PER priority write-back: generation filter, (|td|+ε already
// applied caller-side) ^α, both tree updates, and the max-priority reduce
// in one call — the whole Python lock scope becomes this function. Entries
// whose slot was recycled since sampling (sample_gen[i] != cur_gen[idx[i]])
// are dropped, matching SampledIndices semantics. Returns the max applied
// pre-α priority, 0.0 when every entry was dropped (caller leaves
// max_priority untouched). sample_gen == nullptr applies unconditionally
// (raw-index form).
double st_update_priorities(void* sum_h, void* min_h, const int64_t* idx,
                            const double* pri, int64_t n,
                            const int64_t* sample_gen, const int64_t* cur_gen,
                            double alpha) {
  Tree* st = static_cast<Tree*>(sum_h);
  Tree* mt = static_cast<Tree*>(min_h);
  double mx = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    if (sample_gen != nullptr && sample_gen[i] != cur_gen[idx[i]]) continue;
    const double pa = std::pow(pri[i], alpha);
    for (int t = 0; t < 2; ++t) {
      Tree* tr = t ? mt : st;
      int64_t pos = idx[i] + tr->capacity;
      tr->v[pos] = pa;
      for (pos >>= 1; pos >= 1; pos >>= 1) {
        tr->v[pos] = tr->combine(tr->v[2 * pos], tr->v[2 * pos + 1]);
      }
    }
    if (pri[i] > mx) mx = pri[i];
  }
  return mx;
}

}  // extern "C"
