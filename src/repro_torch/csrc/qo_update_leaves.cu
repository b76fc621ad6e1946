// QO absorb: fold a routed batch into every (leaf, feature) table, in place.
//
// Replaces the TPU kernel
// src/repro/kernels/qo_update_leaves.py::qo_update_leaves_pallas.  The TPU
// kernel walks a grid of (feature, leaf tile, batch tile), builds one-hot
// (row, leaf) and (row, bin) matrices and contracts them on the MXU, then
// Chan-merges each 256-row tile into the running tables kept in VMEM.
// Here the batch is pre-sorted by folded leaf id (a stable torch.sort in
// the wrapper; layout preparation like pack_forest on the TPU side), so
// one CTA owns one (folded leaf, feature) table and walks that leaf's rows
// in row order:
//
//   pass 1  each thread owns one bin and sums w, w*y, w*x of the rows that
//           quantize into it (rows are staged through shared memory one
//           chunk at a time, every thread scans the chunk in order);
//   pass 2  the same walk sums w * (y - bin mean)^2, the two-pass M2;
//   merge   one Chan merge (Eqs. 4-5) of the batch's bin stats into the
//           running (n, mean, M2), and sum_x += the batch's sum of w*x.
//
// Every sum runs in a fixed order (row order within a bin), so the result
// is bitwise the same from run to run: no float atomics.  The tables are
// updated in place: at T=16, M=1023, F=16, C=64 the four planes hold
// 268 MB, and an out-of-place copy would double that.  A leaf with no rows
// this batch exits at once and its tables stay untouched.
//
// What bounds it on the H100: the bytes of the touched tables (read and
// written once, 16 B per bin and plane pair) plus the batch; the per-row
// work is a handful of flops.  The redundancy (every bin thread reads every
// staged row of its leaf) costs C shared-memory broadcast reads per row,
// which is what a later version removes with per-warp histograms.
//
// Bin ids follow the reference bit for bit (ROADMAP C1): floor((x-o)/r)
// with IEEE division, a saturating float->int32 cast that sends NaN to 0
// (__float2int_rd), the +C/2 done in unsigned arithmetic so it wraps like
// XLA's int32 add, then the clip into [0, C).
#include <cuda_runtime.h>

__device__ __forceinline__ int bin_id(float x, float o, float r, int C) {
  int h = __float2int_rd((x - o) / r);
  h = (int)((unsigned)h + (unsigned)(C / 2));
  return h < 0 ? 0 : (h > C - 1 ? C - 1 : h);
}

__global__ void qo_update_leaves_kernel(
    const int* __restrict__ order, const int* __restrict__ offsets,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ radius,
    const float* __restrict__ origin, float* __restrict__ tab_n,
    float* __restrict__ tab_mean, float* __restrict__ tab_m2,
    float* __restrict__ tab_sx, int B, int F, int C) {
  extern __shared__ float smem[];
  const int chunk = blockDim.x;
  int* s_bin = (int*)smem;
  float* s_w = smem + chunk;
  float* s_y = s_w + chunk;
  float* s_x = s_y + chunk;

  const int leaf = blockIdx.x;  // folded leaf id t*M + j
  const int f = blockIdx.y;
  const int start = offsets[leaf];
  const int end = offsets[leaf + 1];
  if (start == end) return;     // no rows: the tables stay untouched

  const long long tab = (long long)leaf * F + f;
  const float r = radius[tab];
  const float o = origin[tab];
  const int c = threadIdx.x;    // this thread's bin (idle when c >= C)

  float n_b = 0.f, sy_b = 0.f, sx_b = 0.f;
  for (int base = start; base < end; base += chunk) {
    int k = base + threadIdx.x;
    if (k < end) {
      int row = order[k];       // folded row t*B + b
      int b = row % B;
      float xv = x[(long long)b * F + f];
      s_bin[threadIdx.x] = bin_id(xv, o, r, C);
      s_w[threadIdx.x] = w[row];
      s_y[threadIdx.x] = y[b];
      s_x[threadIdx.x] = xv;
    }
    __syncthreads();
    int m = min(chunk, end - base);
    for (int j = 0; j < m; ++j) {
      if (s_bin[j] == c) {
        float wj = s_w[j];
        n_b += wj;
        sy_b += wj * s_y[j];
        sx_b += wj * s_x[j];
      }
    }
    __syncthreads();
  }
  const float mean_b = n_b > 0.f ? sy_b / n_b : 0.f;

  float m2_b = 0.f;
  for (int base = start; base < end; base += chunk) {
    int k = base + threadIdx.x;
    if (k < end) {
      int row = order[k];
      int b = row % B;
      float xv = x[(long long)b * F + f];
      s_bin[threadIdx.x] = bin_id(xv, o, r, C);
      s_w[threadIdx.x] = w[row];
      s_y[threadIdx.x] = y[b];
    }
    __syncthreads();
    int m = min(chunk, end - base);
    for (int j = 0; j < m; ++j) {
      if (s_bin[j] == c) {
        float d = s_y[j] - mean_b;
        m2_b += s_w[j] * (d * d);
      }
    }
    __syncthreads();
  }

  if (c < C) {
    const long long i = tab * C + c;
    const float n0 = tab_n[i], mean0 = tab_mean[i], m20 = tab_m2[i];
    const float n = n0 + n_b;
    const float safe_n = n > 0.f ? n : 1.f;
    const float delta = mean_b - mean0;
    const float mean = (n0 * mean0 + n_b * mean_b) / safe_n;
    const float m2 = m20 + m2_b + delta * delta * (n0 * n_b) / safe_n;
    tab_n[i] = n;
    tab_mean[i] = n > 0.f ? mean : 0.f;
    tab_m2[i] = n > 0.f ? m2 : 0.f;
    tab_sx[i] = tab_sx[i] + sx_b;
  }
}

extern "C" int qo_update_leaves_launch(
    const void* order, const void* offsets, const void* x, const void* y,
    const void* w, const void* radius, const void* origin, void* tab_n,
    void* tab_mean, void* tab_m2, void* tab_sx, int n_leaves, int B, int F,
    int C, void* stream) {
  if (n_leaves == 0 || F == 0) return 0;
  int threads = ((C + 31) / 32) * 32;
  if (threads < 64) threads = 64;
  size_t shmem = (size_t)threads * 4 * sizeof(float);
  dim3 grid((unsigned)n_leaves, (unsigned)F);
  qo_update_leaves_kernel<<<grid, threads, shmem, (cudaStream_t)stream>>>(
      (const int*)order, (const int*)offsets, (const float*)x,
      (const float*)y, (const float*)w, (const float*)radius,
      (const float*)origin, (float*)tab_n, (float*)tab_mean, (float*)tab_m2,
      (float*)tab_sx, B, F, C);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
