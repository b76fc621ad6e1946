// Latency probes for the E-BST kernels' bounds (csrc/ebst.cu): one thread
// runs a dependent chain, and chip_smoke.py times a launch with CUDA events
// (ns a step = elapsed / steps).
//   chase_launch         follows next[i] through a single random cycle in
//                        global memory (every hop a random cache line): a
//                        level of a walk below the insert's shared-memory
//                        top, at buffer sizes matching the trees it walks;
//   chase_shared_launch  the same cycle copied into shared memory first: a
//                        level of the insert's walk through its cached top;
//   observe_chain_launch N dependent observes (stats.observe): the insert's
//                        longest fold, total's;
//   merge_chain_launch   N dependent merges (stats.merge): a level of the
//                        query's context forest.
// The last two use the kernels' own arithmetic (csrc/ebst_stats.cuh).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//        -o chase.so tools_torch/chase.cu
#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/ebst_stats.cuh"

namespace {

__global__ void chase_kernel(const int* __restrict__ next, long long steps,
                             int* __restrict__ out) {
  int i = 0;
  for (long long s = 0; s < steps; ++s) i = next[i];
  *out = i;
}

__global__ void chase_shared_kernel(const int* __restrict__ next, int n,
                                    long long steps, int* __restrict__ out) {
  extern __shared__ int sh[];
  for (int j = threadIdx.x; j < n; j += blockDim.x) sh[j] = next[j];
  __syncthreads();
  if (threadIdx.x != 0) return;
  int i = 0;
  for (long long s = 0; s < steps; ++s) i = sh[i];
  *out = i;
}

__global__ void observe_chain_kernel(const float* __restrict__ ys,
                                     long long n, float* __restrict__ out) {
  ebst::Stats s = {0.f, 0.f, 0.f};
  for (long long i = 0; i < n; ++i) s = ebst::observe(s, ys[i]);
  out[0] = s.n; out[1] = s.mean; out[2] = s.m2;
}

__global__ void merge_chain_kernel(const float* __restrict__ n_,
                                   const float* __restrict__ mean,
                                   const float* __restrict__ m2, long long n,
                                   float* __restrict__ out) {
  ebst::Stats s = {0.f, 0.f, 0.f};
  for (long long i = 0; i < n; ++i)
    s = ebst::merge(s, ebst::Stats{n_[i], mean[i], m2[i]});
  out[0] = s.n; out[1] = s.mean; out[2] = s.m2;
}

}  // namespace

extern "C" int chase_launch(const void* next, long long steps, void* out,
                            void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, steps,
                                                   (int*)out);
  return (int)cudaGetLastError();
}

// n ints (at most 58,112: 227 KB) of the cycle in shared memory.
extern "C" int chase_shared_launch(const void* next, int n, long long steps,
                                   void* out, void* stream) {
  const size_t bytes = (size_t)n * sizeof(int);
  const cudaError_t e = cudaFuncSetAttribute(
      chase_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  chase_shared_kernel<<<1, 256, bytes, (cudaStream_t)stream>>>(
      (const int*)next, n, steps, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int observe_chain_launch(const void* ys, long long n, void* out,
                                    void* stream) {
  observe_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const float*)ys,
                                                           n, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int merge_chain_launch(const void* n_, const void* mean,
                                  const void* m2, long long n, void* out,
                                  void* stream) {
  merge_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const float*)n_, (const float*)mean, (const float*)m2, n,
      (float*)out);
  return (int)cudaGetLastError();
}
