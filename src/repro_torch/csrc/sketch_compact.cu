// Sketch compaction: reduce each row's J prototype-sorted centroids into K
// rank buckets with the exact grouped two-pass (n, mean, M2) form.
//
// Replaces the TPU kernel
// src/repro/kernels/sketch_compact.py::sketch_compact_pallas.  The TPU
// kernel packs rows into (5, tile_r, 128-lane) blocks and, for every bucket
// k in a static loop, masks the lanes of bucket k and reduces each row
// across lanes.  Here the wrapper has sorted each row's centroids by
// prototype and assigned the buckets (PyTorch, as the reference keeps them
// in jnp), so a row's bucket ids are non-decreasing along J and each bucket
// is one run.  One warp owns one row; lane j holds centroid c*32 + j of
// chunk c (J > 32 loops over chunks):
//
//   pass 1  a segmented inclusive warp scan (5 shuffle steps, a lane adds
//           its neighbour d lanes back when both hold the same bucket) of
//           n, n*mean and sum_x; the last lane of each run adds the run's
//           sum to the warp's bucket accumulators in shared memory -- one
//           lane per bucket per chunk, chunks in order;
//   mean    the bucket means n*mean / n (0 where empty);
//   pass 2  the same scan of M2 + n * (mean - bucket mean)^2;
//   write   lane k writes bucket k's n, mean, M2 (0 where empty), sum_x.
//
// The shuffle order is fixed, so the result is bitwise repeatable.  A row
// whose ids are not non-decreasing (never on the wrapper's inputs) is
// reduced by its lane 0 centroid by centroid instead, so any ids in [0, K)
// give the grouped sums; ids outside [0, K) contribute nothing.
//
// What bounds it on the H100: bytes -- five (R, J) planes read once and
// four (R, K) planes written once (235 MB at R = 261,888, J = 32, K = 16,
// 0.07 ms at 3.35 TB/s); a row's 32 centroids are one 128 B line per
// plane, read by one warp with neighbouring lanes on neighbouring floats.
#include <cuda_runtime.h>
#include <climits>

#define FULL 0xffffffffu

// Inclusive segmented scan of v over runs of equal key b within the warp.
__device__ __forceinline__ float seg_scan(float v, int b, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    float o = __shfl_up_sync(FULL, v, d);
    int ob = __shfl_up_sync(FULL, b, d);
    if (lane >= d && ob == b) v += o;
  }
  return v;
}

__global__ void sketch_compact_kernel(
    const float* __restrict__ n, const float* __restrict__ mean,
    const float* __restrict__ m2, const float* __restrict__ sx,
    const int* __restrict__ bucket, float* __restrict__ out_n,
    float* __restrict__ out_mean, float* __restrict__ out_m2,
    float* __restrict__ out_sx, long long R, int J, int K) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= R) return;         // the whole warp leaves together
  float* acc_n = smem + (size_t)warp * 4 * K;
  float* acc_sy = acc_n + K;    // sum of n*mean, then the bucket mean
  float* acc_sx = acc_sy + K;
  float* acc_m2 = acc_sx + K;
  for (int k = lane; k < K; k += 32) {
    acc_n[k] = 0.f; acc_sy[k] = 0.f; acc_sx[k] = 0.f; acc_m2[k] = 0.f;
  }
  const long long base = row * J;

  bool ok = true;
  for (int j = lane; j < J; j += 32)
    if (j > 0 && bucket[base + j] < bucket[base + j - 1]) ok = false;
  const bool sorted = __all_sync(FULL, ok);
  __syncwarp();

  if (sorted) {
    for (int c = 0; c < J; c += 32) {
      const int j = c + lane;
      const bool valid = j < J;
      const int b = valid ? bucket[base + j] : INT_MAX;
      const float nv = valid ? n[base + j] : 0.f;
      float s_n = seg_scan(nv, b, lane);
      float s_sy = seg_scan(valid ? nv * mean[base + j] : 0.f, b, lane);
      float s_sx = seg_scan(valid ? sx[base + j] : 0.f, b, lane);
      const int nb = __shfl_down_sync(FULL, b, 1);
      const bool run_end = lane == 31 || nb != b;
      if (valid && run_end && b >= 0 && b < K) {
        acc_n[b] += s_n; acc_sy[b] += s_sy; acc_sx[b] += s_sx;
      }
      __syncwarp();
    }
  } else if (lane == 0) {
    for (int j = 0; j < J; ++j) {
      const int b = bucket[base + j];
      if (b < 0 || b >= K) continue;
      acc_n[b] += n[base + j];
      acc_sy[b] += n[base + j] * mean[base + j];
      acc_sx[b] += sx[base + j];
    }
  }
  __syncwarp();
  for (int k = lane; k < K; k += 32)
    acc_sy[k] = acc_n[k] > 0.f ? acc_sy[k] / acc_n[k] : 0.f;
  __syncwarp();

  if (sorted) {
    for (int c = 0; c < J; c += 32) {
      const int j = c + lane;
      const bool valid = j < J;
      const int b = valid ? bucket[base + j] : INT_MAX;
      float r = 0.f;
      if (valid && b >= 0 && b < K) {
        const float d = mean[base + j] - acc_sy[b];
        r = m2[base + j] + n[base + j] * (d * d);
      }
      r = seg_scan(r, b, lane);
      const int nb = __shfl_down_sync(FULL, b, 1);
      const bool run_end = lane == 31 || nb != b;
      if (valid && run_end && b >= 0 && b < K) acc_m2[b] += r;
      __syncwarp();
    }
  } else if (lane == 0) {
    for (int j = 0; j < J; ++j) {
      const int b = bucket[base + j];
      if (b < 0 || b >= K) continue;
      const float d = mean[base + j] - acc_sy[b];
      acc_m2[b] += m2[base + j] + n[base + j] * (d * d);
    }
  }
  __syncwarp();

  const long long ob = row * K;
  for (int k = lane; k < K; k += 32) {
    const bool occ = acc_n[k] > 0.f;
    out_n[ob + k] = acc_n[k];
    out_mean[ob + k] = acc_sy[k];
    out_m2[ob + k] = occ ? acc_m2[k] : 0.f;
    out_sx[ob + k] = acc_sx[k];
  }
}

extern "C" int sketch_compact_launch(const void* n, const void* mean,
                                     const void* m2, const void* sx,
                                     const void* bucket, void* out_n,
                                     void* out_mean, void* out_m2,
                                     void* out_sx, long long R, int J, int K,
                                     void* stream) {
  if (R == 0) return 0;
  const int warps = 8;
  unsigned blocks = (unsigned)((R + warps - 1) / warps);
  size_t shmem = (size_t)warps * 4 * K * sizeof(float);
  sketch_compact_kernel<<<blocks, warps * 32, shmem, (cudaStream_t)stream>>>(
      (const float*)n, (const float*)mean, (const float*)m2, (const float*)sx,
      (const int*)bucket, (float*)out_n, (float*)out_mean, (float*)out_m2,
      (float*)out_sx, R, J, K);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
