// Level-synchronous routing of B rows through T trees at once.
//
// Replaces the TPU kernel src/repro/kernels/qo_route.py::qo_route_pallas
// (body _qo_route_kernel).  The TPU kernel advances a (tile_b,) slice of
// row states per grid step with a one-hot (tile_b, Np) @ (Np, 128) MXU
// contraction per ply, because a TPU has no cheap gather.  Here each
// (tree, row) pair is one thread that gathers its node's feature,
// threshold and children directly: the folded node arrays (T*M entries,
// 16 B each, 262 KB at T=16, M=1023) stay resident in L2 and the X row in
// L1, so there is no one-hot work at all.
//
// What bounds it on the H100: memory latency of the dependent gathers,
// one chain of `plies` loads per thread, not bandwidth (the bytes it must
// move -- X once, the node arrays once, the (T, B) ids once -- take a few
// microseconds at 3.35 TB/s).  The design answers with occupancy: T*B
// independent chains in flight (65,536 at the slice's shapes), and a
// thread stops as soon as it reaches a leaf (leaves self-loop, left ==
// right == self), so shallow rows do not pay for the deepest tree.
//
// Semantics: node' = x[feature] <= threshold ? left : right.  A NaN
// compares false and goes right, as in the reference.  Output is the
// local leaf id (global id minus t*M).
#include <cuda_runtime.h>

__global__ void qo_route_kernel(const int* __restrict__ feature,
                                const float* __restrict__ threshold,
                                const int* __restrict__ left,
                                const int* __restrict__ right,
                                const float* __restrict__ x,
                                int* __restrict__ out,
                                int T, int M, int B, int F, int plies) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)T * B) return;
  int t = (int)(i / B);
  int b = (int)(i - (long long)t * B);
  int root = t * M;
  int node = root;
  const float* xr = x + (long long)b * F;
  for (int p = 0; p < plies; ++p) {
    int l = left[node];
    if (l == node) break;  // a leaf: every further ply is a self-loop
    float v = xr[feature[node]];
    node = (v <= threshold[node]) ? l : right[node];
  }
  out[i] = node - root;
}

extern "C" int qo_route_launch(const void* feature, const void* threshold,
                               const void* left, const void* right,
                               const void* x, void* out, int T, int M, int B,
                               int F, int plies, void* stream) {
  long long n = (long long)T * B;
  if (n == 0) return 0;
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  qo_route_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)feature, (const float*)threshold, (const int*)left,
      (const int*)right, (const float*)x, (int*)out, T, M, B, F, plies);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
