// Single-table QO absorb (paper Algorithm 1): fold N weighted rows into one
// table of C bins, out of place.
//
// Replaces the TPU kernel src/repro/kernels/qo_update.py::qo_update_pallas.
// The TPU kernel streams 1024-row tiles through VMEM in a sequential grid,
// expands each tile to a one-hot (tile, C) matrix, reduces it on the MXU
// and Chan-merges tile after tile into a table that stays resident across
// grid steps.  GPU blocks run in no order and float atomics would make the
// result differ from run to run, so here the rows are grouped by bin and
// each bin is reduced by one block in a fixed order:
//
//   qo_update_bins_kernel    the bin id of every row (the reference's
//                            integer semantics, ROADMAP C1) and an integer
//                            histogram of the bins (per-block shared-memory
//                            counts, then one global add a bin and block;
//                            integer atomics, so the counts do not depend
//                            on order);
//   (wrapper)                a stable radix sort of the bin ids on the card
//                            (torch.sort) and the exclusive prefix of the
//                            counts: each bin's rows form one run, in row
//                            order;
//   qo_update_reduce_kernel  one block per bin: pass 1 sums w, w*y, w*x over
//                            the bin's run (a fixed per-thread stride, then
//                            a fixed shuffle-and-shared-memory tree), pass 2
//                            sums w * (y - batch bin mean)^2 -- the two-pass
//                            M2, not a sum of squares -- and one thread
//                            Chan-merges (Eqs. 4-5) the batch into the
//                            running (n, mean, M2) and adds the w*x sum.
//
// Every bin is merged, also one that received no row, as the reference
// merges its zero tile (so an empty bin's mean takes the same (n*mean)/n
// rounding).  The result is bitwise repeatable: no float atomics.
//
// What bounds it on the H100: bytes -- x, y, w read once (12 B a row) and
// the four planes of C floats read and written once; the arithmetic is a
// dozen flops a row.  Every row is read twice more (gathered through the
// sort order, in pass 1 and pass 2) and one block reduces a whole bin, so
// a narrow distribution that puts most rows into a few bins runs on a few
// SMs: what a later version balances by splitting long runs across blocks.
#include <cuda_runtime.h>

__device__ __forceinline__ int bin_id(float x, float o, float r, int C) {
  int h = __float2int_rd((x - o) / r);  // saturating, NaN -> 0 (C1)
  h = (int)((unsigned)h + (unsigned)(C / 2));  // int32 wraparound, as XLA
  return h < 0 ? 0 : (h > C - 1 ? C - 1 : h);
}

// Bin ids and their histogram.  A stream crowds a few bins, so every row
// adding to a global counter serializes on those few addresses: each
// block counts its grid-stride share of the rows in shared memory and adds
// one count a bin to the global histogram.
__global__ void qo_update_bins_kernel(const float* __restrict__ x,
                                      const float* __restrict__ radius,
                                      const float* __restrict__ origin,
                                      int* __restrict__ bins,
                                      int* __restrict__ counts, long long N,
                                      int C) {
  extern __shared__ int s_hist[];  // C counts
  for (int c = threadIdx.x; c < C; c += blockDim.x) s_hist[c] = 0;
  __syncthreads();
  const float o = origin[0], r = radius[0];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < N; i += stride) {
    int b = bin_id(x[i], o, r, C);
    bins[i] = b;
    atomicAdd(&s_hist[b], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    if (s_hist[c]) atomicAdd(&counts[c], s_hist[c]);
}

// Sum of v over the block, in a fixed order: a butterfly within each warp,
// then warp 0 over the per-warp sums.  Every thread gets the result.
__device__ float block_sum(float v, float* s_warp) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();              // s_warp may still be read from a last call
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = lane < n_warps ? s_warp[lane] : 0.f;
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__global__ void qo_update_reduce_kernel(
    const int* __restrict__ order, const int* __restrict__ offsets,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ tab_n,
    const float* __restrict__ tab_mean, const float* __restrict__ tab_m2,
    const float* __restrict__ tab_sx, float* __restrict__ out_n,
    float* __restrict__ out_mean, float* __restrict__ out_m2,
    float* __restrict__ out_sx) {
  __shared__ float s_warp[32];
  const int c = blockIdx.x;
  const int start = offsets[c], end = offsets[c + 1];

  float n_b = 0.f, sy_b = 0.f, sx_b = 0.f;
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    int r = order[i];
    float wv = w[r];
    n_b += wv;
    sy_b += wv * y[r];
    sx_b += wv * x[r];
  }
  n_b = block_sum(n_b, s_warp);
  sy_b = block_sum(sy_b, s_warp);
  sx_b = block_sum(sx_b, s_warp);
  const float mean_b = n_b > 0.f ? sy_b / n_b : 0.f;

  float m2_b = 0.f;
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    int r = order[i];
    float d = y[r] - mean_b;
    m2_b += w[r] * (d * d);
  }
  m2_b = block_sum(m2_b, s_warp);

  if (threadIdx.x == 0) {
    const float n0 = tab_n[c], mean0 = tab_mean[c], m20 = tab_m2[c];
    const float n = n0 + n_b;
    const float safe_n = n > 0.f ? n : 1.f;
    const float delta = mean_b - mean0;
    const float mean = (n0 * mean0 + n_b * mean_b) / safe_n;
    const float m2 = m20 + m2_b + delta * delta * (n0 * n_b) / safe_n;
    out_n[c] = n;
    out_mean[c] = n > 0.f ? mean : 0.f;
    out_m2[c] = n > 0.f ? m2 : 0.f;
    out_sx[c] = tab_sx[c] + sx_b;
  }
}

extern "C" int qo_update_bins_launch(const void* x, const void* radius,
                                     const void* origin, void* bins,
                                     void* counts, long long N, int C,
                                     void* stream) {
  if (N == 0) return 0;
  const int threads = 256;
  long long blocks = (N + threads - 1) / threads;
  if (blocks > 1056) blocks = 1056;  // 8 resident blocks on each of 132 SMs
  size_t shmem = (size_t)C * sizeof(int);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        qo_update_bins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  qo_update_bins_kernel<<<(unsigned)blocks, threads, shmem,
                          (cudaStream_t)stream>>>(
      (const float*)x, (const float*)radius, (const float*)origin,
      (int*)bins, (int*)counts, N, C);
  return (int)cudaGetLastError();
}

extern "C" int qo_update_reduce_launch(
    const void* order, const void* offsets, const void* x, const void* y,
    const void* w, const void* tab_n, const void* tab_mean,
    const void* tab_m2, const void* tab_sx, void* out_n, void* out_mean,
    void* out_m2, void* out_sx, int C, void* stream) {
  if (C == 0) return 0;
  // 1024 threads: a crowded bin's run (~10^5 rows) is one block's work
  qo_update_reduce_kernel<<<(unsigned)C, 1024, 0, (cudaStream_t)stream>>>(
      (const int*)order, (const int*)offsets, (const float*)x,
      (const float*)y, (const float*)w, (const float*)tab_n,
      (const float*)tab_mean, (const float*)tab_m2, (const float*)tab_sx,
      (float*)out_n, (float*)out_mean, (float*)out_m2, (float*)out_sx);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
