// The target-statistics algebra of the E-BST kernels (csrc/ebst.cu) and of
// the latency probes that bound them (tools_torch/chase.cu): observe, merge,
// subtract and variance in the operation order of
// repro_torch/core/stats.py.
//
// Every float operation is an explicitly rounded intrinsic (__fadd_rn,
// __fsub_rn, __fmul_rn, __fdiv_rn), so nvcc's default --fmad=true cannot
// contract a product and a sum into an FMA: the results are bitwise equal
// to the plain PyTorch versions.
#pragma once
#include <cuda_runtime.h>

namespace ebst {

struct Stats {
  float n, mean, m2;
};

// stats.observe with w = 1: n + w, mean + (w*d)/n, m2 + (w*d)*(y - mean')
__device__ __forceinline__ Stats observe(Stats s, float y) {
  const float w = 1.f;
  const float n = __fadd_rn(s.n, w);
  const float safe = n > 0.f ? n : 1.f;
  const float d = __fsub_rn(y, s.mean);
  const float mean = __fadd_rn(s.mean, __fdiv_rn(__fmul_rn(w, d), safe));
  const float m2 = __fadd_rn(s.m2, __fmul_rn(__fmul_rn(w, d),
                                            __fsub_rn(y, mean)));
  return {n, mean, m2};
}

// stats.merge (Chan et al., paper Eqs. 4-5)
__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  const float n = __fadd_rn(a.n, b.n);
  const bool live = n > 0.f;
  const float safe = live ? n : 1.f;
  const float d = __fsub_rn(b.mean, a.mean);
  const float mean = __fdiv_rn(
      __fadd_rn(__fmul_rn(a.n, a.mean), __fmul_rn(b.n, b.mean)), safe);
  const float m2 = __fadd_rn(
      __fadd_rn(a.m2, b.m2),
      __fdiv_rn(__fmul_rn(__fmul_rn(d, d), __fmul_rn(a.n, b.n)), safe));
  return {n, live ? mean : 0.f, live ? m2 : 0.f};
}

// stats.subtract (paper Eqs. 6-7); the clamp keeps a NaN, as torch.clamp
// and jnp.maximum do
__device__ __forceinline__ Stats subtract(Stats ab, Stats b) {
  const float n_a = __fsub_rn(ab.n, b.n);
  const bool live = n_a > 0.f;
  const float safe_na = live ? n_a : 1.f;
  const float mean_a = __fdiv_rn(
      __fsub_rn(__fmul_rn(ab.n, ab.mean), __fmul_rn(b.n, b.mean)), safe_na);
  const float d = __fsub_rn(b.mean, mean_a);
  const float safe_nab = ab.n > 0.f ? ab.n : 1.f;
  const float m2_a = __fsub_rn(
      __fsub_rn(ab.m2, b.m2),
      __fdiv_rn(__fmul_rn(__fmul_rn(d, d), __fmul_rn(n_a, b.n)), safe_nab));
  return {n_a, live ? mean_a : 0.f, live ? (m2_a < 0.f ? 0.f : m2_a) : 0.f};
}

// stats.variance, ddof 1
__device__ __forceinline__ float variance(Stats s) {
  const float denom = __fsub_rn(s.n, 1.f);
  return denom > 0.f ? __fdiv_rn(s.m2, denom > 0.f ? denom : 1.f) : 0.f;
}

}  // namespace ebst
