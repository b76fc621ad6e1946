// Per-leaf target statistics of a routed batch, merged into the running
// statistics, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this step to XLA (a sort,
// three segment sums and a Chan merge, fused by the compiler).  The same
// composition in eager PyTorch costs some 80 launches and six blocking host
// reads a forest step (each segment_reduce reads its lengths on the host),
// which is what this kernel removes.
//
// What bounds it on the H100: launch latency.  Its data is about 0.8 MB a
// step at T = 10 trees, M = 1023 nodes, B = 4,096 rows (the sort's order
// and offsets, the weights, y, and the T*M running statistics and counts
// read and written once): a quarter of a microsecond of HBM time against
// the few microseconds of any launch.  So the design keeps the stage to
// one launch with no host read, and spends no second pass over memory.
//
//   leaf_stats_kernel: a warp per entry of the folded T*M leaf axis.  The
//     batch arrives sorted by folded leaf id (order, offsets: the sort the
//     absorb walks too); row r of the folded batch is batch row r % B of
//     tree r / B.  Lane l sums the entry's rows l, l + 32, l + 64, ... in
//     that order (w and w*y, reading w[r] and y[r % B] directly), then a
//     xor butterfly over lane offsets 16, 8, 4, 2, 1 gives every lane the
//     same totals.  mean = (sum w*y) / n; a second pass in the same order
//     sums w*(y - mean)^2 (the two-pass residual M2 of
//     core/hoeffding.py::segment_stats).  Lane 0 Chan-merges (n, mean, M2)
//     into the entry's running statistics with core/stats.py::merge's
//     formulas and empty-operand rules and adds n to its seen count, in
//     place.  Every entry is merged, a leaf the batch missed included, so
//     an untouched leaf rounds as the plain composition rounds it.
//   A lane loads UNROLL strides before it sums them, so a root that holds
//   its tree's whole 4,096-row batch (a fresh tree) takes 16 rounds of
//   loads a pass, not 128; a run of up to 32 * UNROLL rows keeps its rows
//   in registers for the second pass.
//   Every operation is explicitly rounded (__fadd_rn, __fmul_rn,
//   __fdiv_rn: nothing contracts into an FMA) and no statistic goes
//   through an atomic, so the result is bitwise the same from run to run
//   and a float32 model of this order reproduces it bit for bit.
//
// The ids' check, without a host read: thread 0 of block 0 writes *bad = 1
// when the runs cover fewer rows than there are (an id outside
// [0, n_entries) lies in no run), else 0.  The caller reads the flag with
// a host read it makes anyway.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;
constexpr unsigned FULL = 0xffffffffu;

// Every lane ends with the same sum: each level adds the same pairs.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// The lane's rows of the chunk of 32 * UNROLL sorted rows from base (zero
// past the run's end).
__device__ __forceinline__ void load_chunk(
    const int* __restrict__ order, const float* __restrict__ y,
    const float* __restrict__ w, int B, int base, int hi, int lane,
    float (&wv)[UNROLL], float (&yv)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = base + u * 32 + lane;
    wv[u] = 0.f;
    yv[u] = 0.f;
    if (i < hi) {
      const int r = __ldg(order + i);
      wv[u] = __ldg(w + r);
      yv[u] = __ldg(y + r % B);
    }
  }
}

}  // namespace

__global__ void __launch_bounds__(THREADS)
leaf_stats_kernel(const int* __restrict__ order,
                  const int* __restrict__ offsets,
                  const float* __restrict__ y, const float* __restrict__ w,
                  float* __restrict__ run_n, float* __restrict__ run_mean,
                  float* __restrict__ run_m2, float* __restrict__ seen,
                  unsigned char* __restrict__ bad, int n_entries, int n_rows,
                  int B) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *bad = (offsets[n_entries] - offsets[0]) != n_rows;
  if (e >= n_entries) return;
  const int lo = offsets[e], hi = offsets[e + 1];
  const int chunk = 32 * UNROLL;

  // pass 1: n and sum w*y, lane-strided in row order
  float wv[UNROLL], yv[UNROLL];
  float sn = 0.f, sy = 0.f;
  for (int base = lo; base < hi; base += chunk) {
    load_chunk(order, y, w, B, base, hi, lane, wv, yv);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * 32 + lane < hi) {
        sn = __fadd_rn(sn, wv[u]);
        sy = __fadd_rn(sy, __fmul_rn(wv[u], yv[u]));
      }
    }
  }
  sn = warp_sum(sn);
  sy = warp_sum(sy);
  const float mean_b = sn > 0.f ? __fdiv_rn(sy, sn) : 0.f;

  // pass 2: the residual M2 against the batch's own mean, same order
  float m2 = 0.f;
  for (int base = lo; base < hi; base += chunk) {
    if (hi - lo > chunk) load_chunk(order, y, w, B, base, hi, lane, wv, yv);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * 32 + lane < hi) {
        const float d = __fsub_rn(yv[u], mean_b);
        m2 = __fadd_rn(m2, __fmul_rn(wv[u], __fmul_rn(d, d)));
      }
    }
  }
  m2 = warp_sum(m2);
  if (lane != 0) return;
  const float m2_b = sn > 0.f ? m2 : 0.f;

  // Chan merge (paper Eqs. 4-5) as stats.merge writes it
  const float a_n = run_n[e], a_mean = run_mean[e], a_m2 = run_m2[e];
  const float n = __fadd_rn(a_n, sn);
  const float safe = n > 0.f ? n : 1.f;
  const float delta = __fsub_rn(mean_b, a_mean);
  const float mean = __fdiv_rn(
      __fadd_rn(__fmul_rn(a_n, a_mean), __fmul_rn(sn, mean_b)), safe);
  const float merged_m2 = __fadd_rn(
      __fadd_rn(a_m2, m2_b),
      __fdiv_rn(__fmul_rn(__fmul_rn(delta, delta), __fmul_rn(a_n, sn)),
                safe));
  run_n[e] = n;
  run_mean[e] = n > 0.f ? mean : 0.f;
  run_m2[e] = n > 0.f ? merged_m2 : 0.f;
  seen[e] = __fadd_rn(seen[e], sn);
}

extern "C" int leaf_stats_launch(const void* order, const void* offsets,
                                 const void* y, const void* w, void* run_n,
                                 void* run_mean, void* run_m2, void* seen,
                                 void* bad, int n_entries, int n_rows, int B,
                                 void* stream) {
  const int blocks = n_entries > 0 ? (n_entries + WARPS - 1) / WARPS : 1;
  leaf_stats_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)order, (const int*)offsets, (const float*)y,
      (const float*)w, (float*)run_n, (float*)run_mean, (float*)run_m2,
      (float*)seen, (unsigned char*)bad, n_entries, n_rows, B > 0 ? B : 1);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
