// Dependent-load latency probe: one thread follows next[i] through a
// single random cycle (every hop a random cache line of the buffer), the
// chain that bounds csrc/ebst.cu's serial tree walk.  chip_smoke.py builds
// it beside the port's kernels and times a launch with CUDA events: ns a
// hop = elapsed / steps, at buffer sizes matching the trees it walks.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//        -o chase.so tools_torch/chase.cu
#include <cuda_runtime.h>

__global__ void chase_kernel(const int* __restrict__ next, long long steps,
                             int* __restrict__ out) {
  int i = 0;
  for (long long s = 0; s < steps; ++s) i = next[i];
  *out = i;
}

extern "C" int chase_launch(const void* next, long long steps, void* out,
                            void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, steps,
                                                   (int*)out);
  return (int)cudaGetLastError();
}
