// E-BST and TE-BST attribute observers: the serial insert and the in-order
// split query, each one launch of one thread.
//
// No TPU kernel exists for these.  The reference (src/repro/core/ebst.py)
// lowers the insert to a lax.scan over rows of a lax.while_loop down the
// tree (_insert_one, ebst.py:60) and the query to a lax.while_loop over an
// explicit stack (best_split, ebst.py:135): one device program each.
// Written as PyTorch ops, every tree level would cost about ten launches
// and a host read, so here each is one kernel.
//
// State, structure-of-arrays as the reference keeps it, all on the card
// (the wrapper never reads it to the host):
//   key (cap,) f32, left/right (cap,) i32 (-1 = nil), le as three (cap,)
//   f32 planes (n, mean, m2: the targets of every row with x <= key that
//   passed the node), size () i32, total as three f32 scalars, decimals
//   () i32 (>= 0: TE-BST, x rounded to that many decimals first).
//
// ebst_insert_launch runs _insert_one for every row, in order:
//   total observes y first; x <= key goes left and observes the node's le;
//   x == key stops after that update (a duplicate adds no node; -0.0 ==
//   0.0); a nil child becomes a node whose le is observe(empty, y); at
//   capacity a row only updates the statistics along its path; a NaN x
//   goes right at every node and becomes a node of its own.
//   TE-BST: rintf(x * scale) * inv, rintf rounding half to even as
//   jnp.round does, scale = 10^decimals by repeated f32 multiplication
//   (exact up to 10^10) and inv = 1 / scale rounded once.  The reference
//   writes round(x * scale) / scale, but XLA rewrites a division by
//   pow(10, d) into a product with pow(10, -d) (the correctly rounded
//   10^-d for d <= 11), and the port keeps the reference's keys.
// ebst_query_launch runs best_split: an in-order walk with left-context
//   statistics S; at node v, left = merge(S, le[v]), right = subtract(total,
//   left), the VR scored where both sides hold weight, the first strictly
//   greater score kept; the right subtree then walks with S = left.  The
//   reference stores a node's descend step (phase 0) on its stack too;
//   here the left spine is descended in registers and only the emit steps
//   (node, S) are stored, which visits the nodes in the same order with
//   the same S, so the result is the same.
//
// Every float operation is an explicitly rounded intrinsic (__fadd_rn,
// __fsub_rn, __fmul_rn, __fdiv_rn) in the order of
// repro_torch/core/stats.py (observe, merge, subtract, variance), so
// nvcc's default --fmad=true cannot contract a product and a sum into an
// FMA: the result is bitwise equal to the plain PyTorch version.
//
// What bounds it on the H100: latency, not bytes.  Each insert depends on
// the tree the previous inserts built, so one thread walks it and the
// chain is one dependent load per level: key[cur], left[cur], right[cur]
// and le[cur] are issued together from cur, and the le update of a node
// passed on the left is a store, which the next level does not wait for.
// (chip_smoke.py phase 3 on an H100 80GB HBM3 at 700 W: 113 ns a visited
// node while the tree sits in L1, whose dependent-load latency is 23 ns,
// so at that size the level's instruction chain, not the load, sets the
// pace.)  Its bound is (levels visited) x (the card's dependent-load latency at the
// tree's size), which chip_smoke.py measures with a pointer chase.  The
// query is one pass over the nodes with its stack (16 B an entry, cap + 1
// entries) in a scratch buffer the wrapper allocates.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Stats {
  float n, mean, m2;
};

struct Entry {  // a node whose emit step is due, with its context S
  int node;
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

__global__ void ebst_insert_kernel(
    float* __restrict__ key, int* __restrict__ left, int* __restrict__ right,
    float* __restrict__ le_n, float* __restrict__ le_mean,
    float* __restrict__ le_m2, int* __restrict__ size_p,
    float* __restrict__ total, const int* __restrict__ decimals_p,
    const float* __restrict__ xs, const float* __restrict__ ys, long long N,
    int cap) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const int dec = *decimals_p;
  float scale = 1.f;
  for (int i = 0; i < dec; ++i) scale = __fmul_rn(scale, 10.f);
  const float inv = __fdiv_rn(1.f, scale);
  int size = *size_p;
  Stats tot = {total[0], total[1], total[2]};
  const Stats empty = {0.f, 0.f, 0.f};
  for (long long r = 0; r < N; ++r) {
    float x = xs[r];
    const float y = ys[r];
    if (dec >= 0) x = __fmul_rn(rintf(__fmul_rn(x, scale)), inv);
    tot = observe(tot, y);
    if (size == 0) {
      const Stats s = observe(empty, y);
      key[0] = x;
      le_n[0] = s.n; le_mean[0] = s.mean; le_m2[0] = s.m2;
      size = 1;
      continue;
    }
    int cur = 0;
    for (;;) {
      // one dependent step: every load of the level issued from cur
      const float k = key[cur];
      const int lc = left[cur], rc = right[cur];
      const Stats s = {le_n[cur], le_mean[cur], le_m2[cur]};
      const bool goes_left = x <= k;
      if (goes_left) {
        const Stats u = observe(s, y);
        le_n[cur] = u.n; le_mean[cur] = u.mean; le_m2[cur] = u.m2;
      }
      const bool is_eq = x == k;
      const int child = goes_left ? lc : rc;
      if (child == -1 && !is_eq) {
        if (size < cap) {              // at capacity: stats only
          const Stats u = observe(empty, y);
          key[size] = x;
          le_n[size] = u.n; le_mean[size] = u.mean; le_m2[size] = u.m2;
          if (goes_left) left[cur] = size; else right[cur] = size;
          ++size;
        }
        break;
      }
      if (is_eq) break;                // a duplicate adds no node
      cur = child;
    }
  }
  *size_p = size;
  total[0] = tot.n; total[1] = tot.mean; total[2] = tot.m2;
}

__global__ void ebst_query_kernel(
    const float* __restrict__ key, const int* __restrict__ left,
    const int* __restrict__ right, const float* __restrict__ le_n,
    const float* __restrict__ le_mean, const float* __restrict__ le_m2,
    const int* __restrict__ size_p, const float* __restrict__ total,
    Entry* __restrict__ stk, float* __restrict__ out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const Stats tot = {total[0], total[1], total[2]};
  const float s2_d = variance(tot);
  const float n_tot = tot.n < 1.f ? 1.f : tot.n;   // jnp.maximum(n, 1)
  float best = -INFINITY, thr = 0.f;
  int sp = 0;
  int v = *size_p > 0 ? 0 : -1;       // the next subtree to descend
  Stats S = {0.f, 0.f, 0.f};
  for (;;) {
    while (v != -1) {                  // descend the left spine
      stk[sp++] = {v, S.n, S.mean, S.m2};
      v = left[v];
    }
    if (sp == 0) break;
    const Entry e = stk[--sp];         // emit
    const Stats ctx = {e.n, e.mean, e.m2};
    const Stats node = {le_n[e.node], le_mean[e.node], le_m2[e.node]};
    const Stats L = merge(ctx, node);
    const Stats R = subtract(tot, L);
    const bool ok = L.n > 0.f && R.n > 0.f;
    const float vr = __fsub_rn(
        __fsub_rn(s2_d, __fmul_rn(__fdiv_rn(L.n, n_tot), variance(L))),
        __fmul_rn(__fdiv_rn(R.n, n_tot), variance(R)));
    const float score = ok ? vr : -INFINITY;
    if (score > best) {
      best = score;
      thr = key[e.node];
    }
    v = right[e.node];
    S = L;
  }
  const bool valid = isfinite(best);
  out[0] = thr;
  out[1] = valid ? best : 0.f;
  out[2] = valid ? 1.f : 0.f;
}

}  // namespace

// Inserts the N rows (xs, ys) in order, updating the state in place.
extern "C" int ebst_insert_launch(void* key, void* left, void* right,
                                  void* le_n, void* le_mean, void* le_m2,
                                  void* size, void* total,
                                  const void* decimals, const void* xs,
                                  const void* ys, long long n, int cap,
                                  void* stream) {
  if (n == 0) return 0;
  ebst_insert_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (float*)key, (int*)left, (int*)right, (float*)le_n, (float*)le_mean,
      (float*)le_m2, (int*)size, (float*)total, (const int*)decimals,
      (const float*)xs, (const float*)ys, n, cap);
  return (int)cudaGetLastError();
}

// Best split of the tree: out = [threshold, merit, valid]; stack holds
// cap + 1 entries of 16 bytes.
extern "C" int ebst_query_launch(const void* key, const void* left,
                                 const void* right, const void* le_n,
                                 const void* le_mean, const void* le_m2,
                                 const void* size, const void* total,
                                 void* stack, void* out, void* stream) {
  ebst_query_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const float*)key, (const int*)left, (const int*)right,
      (const float*)le_n, (const float*)le_mean, (const float*)le_m2,
      (const int*)size, (const float*)total, (Entry*)stack, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
