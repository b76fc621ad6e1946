// Device code shared by the two QO split queries (qo_query.cu, one table a
// block; qo_query_batched.cu, one table a warp): the Chan merge and its
// Kogge-Stone prefix over a chunk of W bins, the occupied neighbours from
// a chunk's ballot, the variance reduction of a boundary and the argmax
// key.  Both kernels run the same order with these, so one float32 CPU
// model of that order (tests/test_torch_kernels.py::model_scores) holds
// both bit for bit.
//
// Every operation is an explicitly rounded intrinsic (no contraction into
// FMAs; reciprocals and divisions IEEE, __frcp_rn / __fdiv_rn) and the
// shuffle order is fixed, so a rerun is bitwise equal.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#define FULL 0xffffffffu

namespace {

struct Stat {
  float n, mean, m2;
};

// Chan merge of a (left) and b (right), the TPU kernel's arithmetic with
// one reciprocal of the merged count (as the absorbs, ROADMAP C11);
// an empty side returns the other side unchanged.
__device__ __forceinline__ Stat chan(Stat a, Stat b) {
  if (!(b.n > 0.f)) return a;
  if (!(a.n > 0.f)) return b;
  const float tn = __fadd_rn(a.n, b.n);
  const float inv = __frcp_rn(tn);
  const float delta = __fsub_rn(b.mean, a.mean);
  Stat r;
  r.mean = __fmul_rn(__fadd_rn(__fmul_rn(a.n, a.mean), __fmul_rn(b.n, b.mean)),
                     inv);
  r.m2 = __fadd_rn(__fadd_rn(a.m2, b.m2),
                   __fmul_rn(__fmul_rn(__fmul_rn(delta, delta),
                                       __fmul_rn(a.n, b.n)), inv));
  r.n = tn;
  return r;
}

template <int W>
__device__ __forceinline__ Stat bcast(Stat p, int src) {
  return Stat{__shfl_sync(FULL, p.n, src, W),
              __shfl_sync(FULL, p.mean, src, W),
              __shfl_sync(FULL, p.m2, src, W)};
}

__device__ __forceinline__ float var_of(float n, float m2) {
  const float d = __fsub_rn(n, 1.f);
  return d > 0.f ? __fdiv_rn(m2, d) : 0.f;
}

// (score, bin) a preferred to b: a NaN first, then the larger score, then
// the lower bin -- a total order, so any reduction order picks the same.
__device__ __forceinline__ bool better(float as, int ab, float bs, int bb) {
  const bool an = as != as, bn = bs != bs;
  if (an != bn) return an;
  if (!an && as != bs) return as > bs;
  return ab < bb;
}

struct Chunk {
  Stat s;
  float proto;
  bool occ;
};

__device__ __forceinline__ Chunk load(const float* __restrict__ n,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ m2,
                                      const float* __restrict__ sx,
                                      long long base, int c, bool in) {
  Chunk b;
  b.s.n = in ? n[base + c] : 0.f;
  b.s.mean = in ? mean[base + c] : 0.f;
  b.s.m2 = in ? m2[base + c] : 0.f;
  const float x = in ? sx[base + c] : 0.f;
  b.occ = b.s.n > 0.f;
  b.proto = b.occ ? __fdiv_rn(x, b.s.n) : 0.f;
  return b;
}

// Inclusive Kogge-Stone prefix Chan merge over the W lanes of the segment.
template <int W>
__device__ __forceinline__ Stat prefix_scan(Stat p, int sl) {
#pragma unroll
  for (int d = 1; d < W; d <<= 1) {
    Stat o;
    o.n = __shfl_up_sync(FULL, p.n, d, W);
    o.mean = __shfl_up_sync(FULL, p.mean, d, W);
    o.m2 = __shfl_up_sync(FULL, p.m2, d, W);
    if (sl >= d) p = chan(o, p);
  }
  return p;
}

// The occupied bins of the lane's segment (W lanes) as a bit mask.
template <int W>
__device__ __forceinline__ unsigned occupied(bool occ, int lane) {
  const unsigned all = __ballot_sync(FULL, occ);
  if constexpr (W == 32) return all;
  else return (all >> (lane & ~(W - 1))) & ((1u << W) - 1u);
}

// Occupied prototypes around lane sl's bin within one chunk, from the
// chunk's occupancy mask: the last at or before it and the first strictly
// after it (has, value); without one, the value is the lane's own
// prototype.
struct Near {
  int l_has, n_has;
  float l_val, n_val;
};

template <int W>
__device__ __forceinline__ Near near_in_chunk(unsigned occm, float proto,
                                              int sl) {
  Near r;
  const unsigned upto = occm & (0xffffffffu >> (31 - sl));
  const unsigned after = sl + 1 < W ? occm >> (sl + 1) : 0u;
  r.l_has = upto != 0u;
  r.n_has = after != 0u;
  r.l_val = __shfl_sync(FULL, proto, r.l_has ? 31 - __clz(upto) : sl, W);
  r.n_val = __shfl_sync(FULL, proto, r.n_has ? sl + __ffs(after) : sl, W);
  return r;
}

template <int W>
__device__ __forceinline__ float chunk_first(unsigned occm, float proto) {
  return __shfl_sync(FULL, proto, occm ? __ffs(occm) - 1 : 0, W);
}

template <int W>
__device__ __forceinline__ float chunk_last(unsigned occm, float proto) {
  return __shfl_sync(FULL, proto, occm ? 31 - __clz(occm) : 0, W);
}

// What every bin of a table needs of its total: the total, the
// reciprocals of max(n, 1) and of n (1 where empty), and its variance.
struct Total {
  Stat t;
  float inv_tot, inv_ntot, s2d;
};

__device__ __forceinline__ Total total_of(Stat t) {
  // max(n, 1) as jnp.maximum takes it: NaN stays NaN
  const float n_tot = t.n < 1.f ? 1.f : t.n;
  return Total{t, __frcp_rn(t.n > 0.f ? t.n : 1.f), __frcp_rn(n_tot),
               var_of(t.n, t.m2)};
}

// The variance reduction of the boundary after a bin whose inclusive
// prefix is p: the complement by subtraction (Eqs. 6-7), then VR.
__device__ __forceinline__ float boundary_vr(Stat p, const Total& T) {
  const float rn = __fsub_rn(T.t.n, p.n);
  const float rmean = rn > 0.f
      ? __fdiv_rn(__fsub_rn(__fmul_rn(T.t.n, T.t.mean),
                            __fmul_rn(p.n, p.mean)), rn)
      : 0.f;
  const float delta = __fsub_rn(p.mean, rmean);
  float rm2 = __fsub_rn(__fsub_rn(T.t.m2, p.m2),
                        __fmul_rn(__fmul_rn(__fmul_rn(delta, delta),
                                            __fmul_rn(rn, p.n)),
                                  T.inv_tot));
  // max(rm2, 0) as jnp.maximum takes it: NaN stays NaN
  rm2 = rn > 0.f ? (rm2 < 0.f ? 0.f : rm2) : 0.f;
  return __fsub_rn(
      __fsub_rn(T.s2d, __fmul_rn(__fmul_rn(p.n, T.inv_ntot),
                                 var_of(p.n, p.m2))),
      __fmul_rn(__fmul_rn(rn, T.inv_ntot), var_of(rn, rm2)));
}

// The candidate threshold between two neighbouring prototypes.
__device__ __forceinline__ float midpoint(float l_val, float n_val) {
  return __fmul_rn(0.5f, __fadd_rn(l_val, n_val));
}

// (score, bin) as one unsigned key whose maximum is better()'s pick: a
// NaN first, then the larger score (-0.0 equal to +0.0), then the lower
// bin.
__device__ __forceinline__ uint64_t pick_key(float score, int bin) {
  const float v = __fadd_rn(score, 0.f);
  uint32_t u = __float_as_uint(v);
  u = v != v ? 0xffffffffu : ((u & 0x80000000u) ? ~u : (u | 0x80000000u));
  return ((uint64_t)u << 32) | (uint32_t)(INT_MAX - bin);
}

// The bin of a key.
__device__ __forceinline__ int key_bin(uint64_t key) {
  return INT_MAX - (int)(uint32_t)key;
}

// Butterfly max of the key over the W lanes of the segment.
template <int W>
__device__ __forceinline__ uint64_t max_key(uint64_t key) {
#pragma unroll
  for (int off = W >> 1; off > 0; off >>= 1) {
    const uint64_t o = __shfl_xor_sync(FULL, key, off, W);
    key = o > key ? o : key;
  }
  return key;
}

}  // namespace
