// Every forest step's drift test, with the window-state writes after it, in
// one launch.
//
// Replaces no TPU kernel: the JAX package leaves this step to XLA (some
// fifty elementwise ops on (T,) arrays, fused by the compiler).  The same
// composition in eager PyTorch (core/forest.py::_update, the forest.drift
// stage, and the window writes of forest.vote) costs about 60 launches and
// a pageable host-to-device copy of drift_decay a step, which is what this
// kernel removes.
//
// What bounds it on the H100: launch latency.  It reads and writes some 60
// bytes a member, under 4 KB at T = 64: nanoseconds of HBM time against the
// few microseconds of any launch.  So the design is one block of one
// launch, with every host scalar a kernel argument and no host read.
//
//   drift_test_kernel: one block; thread i handles members i, i + THREADS,
//     ... (T from the caller, any T >= 1).  For each member, in
//     core/forest.py's order and rounding (kernels/drift_test.py's
//     drift_test_plain): live, frac, alpha, the ewma, the reference
//     window's sample standard deviation (core/stats.py::variance), signal,
//     the decay (powf when frac < 1), the decayed window observed with the
//     member's error (stats.observe), frozen where signal holds.  The
//     member's window, ewma and resets are written, and its signal parked
//     in drift[i].  A block reduction then finds worst, the first index of
//     the largest ewma among signalling members (torch.argmax's rule: a
//     larger value wins, a tie goes to the lower index, NaN counts as the
//     largest), -inf for the others.  Each thread then sets drift[i] =
//     signal && i == worst and, where it holds, zeroes the member's window
//     and ewma and adds one to its resets; thread 0 writes flags[0] =
//     drift.any() (which is signal[worst]).
//   Every float operation is explicitly rounded (__fadd_rn, __fmul_rn,
//   __fdiv_rn, __fsqrt_rn: nothing contracts into an FMA).  A tensor over a
//   host scalar on the card is a multiply by the scalar's float reciprocal,
//   so the caller passes 1 / max(B, 1) rounded to float (inv_b); clamps keep
//   NaN as PyTorch's do.  So the result equals the composition run on the
//   card bit for bit.
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// torch.clamp(v, min=lo) and (v, max=hi): NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return is_nan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return is_nan(v) ? v : fminf(v, hi);
}

// torch.argmax's combine: does (a, ia) win over (b, ib)?
__device__ __forceinline__ bool wins(float a, int ia, float b, int ib) {
  if (is_nan(a)) return is_nan(b) ? ia < ib : true;
  if (is_nan(b)) return false;
  return a == b ? ia < ib : a > b;
}

}  // namespace

__global__ void __launch_bounds__(THREADS)
drift_test_kernel(const float* __restrict__ member_mse,
                  const float* __restrict__ wraw,
                  const float* __restrict__ wsum,
                  const float* __restrict__ win_n,
                  const float* __restrict__ win_mean,
                  const float* __restrict__ win_m2,
                  const float* __restrict__ ewma_in,
                  const int* __restrict__ resets_in,
                  float* __restrict__ out_n, float* __restrict__ out_mean,
                  float* __restrict__ out_m2, float* __restrict__ out_ewma,
                  int* __restrict__ out_resets,
                  unsigned char* __restrict__ drift,
                  unsigned char* __restrict__ flags, int T, float inv_b,
                  float drift_alpha, float drift_decay, float drift_kappa,
                  float min_batches) {
  __shared__ float best_v[THREADS];
  __shared__ int best_i[THREADS];
  const int tid = threadIdx.x;
  const float neg_inf = -INFINITY;

  // the batch's share of real rows: where(live, clamp(wsum / B, max=1), 0)
  const bool live = *wraw > 0.f;
  const float frac = live ? clamp_max(__fmul_rn(*wsum, inv_b), 1.f) : 0.f;
  const float alpha = __fmul_rn(frac, drift_alpha);
  const float keep = __fsub_rn(1.f, alpha);
  const float decay = frac >= 1.f ? drift_decay : powf(drift_decay, frac);

  float bv = neg_inf;
  int bi = 0x7fffffff;
  for (int i = tid; i < T; i += THREADS) {
    const float mse = member_mse[i];
    const float n = win_n[i], mean = win_mean[i], m2 = win_m2[i];
    const bool first = n < 0.5f && live;
    const float ewma = first ? mse
        : __fadd_rn(__fmul_rn(keep, ewma_in[i]), __fmul_rn(alpha, mse));
    // stats.variance (ddof 1), clamped at 1e-12, its root
    const float denom = __fsub_rn(n, 1.f);
    const float var = denom > 0.f ? __fdiv_rn(m2, denom) : 0.f;
    const float sd = __fsqrt_rn(clamp_min(var, static_cast<float>(1e-12)));
    const bool signal = n >= min_batches
        && ewma > __fadd_rn(mean, __fmul_rn(sd, drift_kappa));
    const float masked = signal ? ewma : neg_inf;
    if (wins(masked, i, bv, bi)) {
      bv = masked;
      bi = i;
    }
    // stats.observe of the decayed window, weight frac; frozen on a signal
    if (signal) {
      out_n[i] = n;
      out_mean[i] = mean;
      out_m2[i] = m2;
    } else {
      const float on = __fadd_rn(__fmul_rn(decay, n), frac);
      const float safe = on > 0.f ? on : 1.f;
      const float d_pre = __fsub_rn(mse, mean);
      const float wd = __fmul_rn(frac, d_pre);
      const float om = __fadd_rn(mean, __fdiv_rn(wd, safe));
      out_n[i] = on;
      out_mean[i] = om;
      out_m2[i] = __fadd_rn(__fmul_rn(decay, m2),
                            __fmul_rn(wd, __fsub_rn(mse, om)));
    }
    out_ewma[i] = ewma;
    out_resets[i] = resets_in[i];
    drift[i] = signal;
  }

  best_v[tid] = bv;
  best_i[tid] = bi;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (tid < half && wins(best_v[tid + half], best_i[tid + half],
                           best_v[tid], best_i[tid])) {
      best_v[tid] = best_v[tid + half];
      best_i[tid] = best_i[tid + half];
    }
    __syncthreads();
  }
  // no member signals: every entry is -inf and worst is 0, as torch.argmax
  const int worst = best_i[0] < T ? best_i[0] : 0;

  for (int i = tid; i < T; i += THREADS) {
    const bool d = drift[i] && i == worst;
    drift[i] = d;
    if (d) {
      out_n[i] = 0.f;
      out_mean[i] = 0.f;
      out_m2[i] = 0.f;
      out_ewma[i] = 0.f;
      out_resets[i] = resets_in[i] + 1;
    }
  }
  if (tid == (worst % THREADS)) flags[0] = drift[worst];
}

extern "C" int drift_test_launch(
    const void* member_mse, const void* wraw, const void* wsum,
    const void* win_n, const void* win_mean, const void* win_m2,
    const void* ewma, const void* resets, void* out_n, void* out_mean,
    void* out_m2, void* out_ewma, void* out_resets, void* drift, void* flags,
    int T, float inv_b, float drift_alpha, float drift_decay,
    float drift_kappa, float min_batches, void* stream) {
  drift_test_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)member_mse, (const float*)wraw, (const float*)wsum,
      (const float*)win_n, (const float*)win_mean, (const float*)win_m2,
      (const float*)ewma, (const int*)resets, (float*)out_n,
      (float*)out_mean, (float*)out_m2, (float*)out_ewma, (int*)out_resets,
      (unsigned char*)drift, (unsigned char*)flags, T, inv_b, drift_alpha,
      drift_decay, drift_kappa, min_batches);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
