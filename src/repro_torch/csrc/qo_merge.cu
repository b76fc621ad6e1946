// Elementwise Chan merge of two QO table sets: the reduce of the
// data-parallel sync collective.
//
// Replaces the TPU kernel src/repro/kernels/qo_merge.py::qo_merge_pallas
// (body _qo_merge_kernel).  The TPU kernel packs the (N, F, C) planes into
// (4, Rp, Cp) stacks, rows padded to a row tile and bins to 128 lanes
// (pack_merge_planes), and merges one (4, tile_r, Cp) block a grid step.
// Here the eight input planes and the four outputs stay in their natural
// flat (N*F*C,) layout: no padding, no tiles, one grid-stride pass.  Per
// element, in the order of repro_torch/core/stats.py::merge:
//
//   n    = n_a + n_b
//   mean = (n_a*mean_a + n_b*mean_b) / n             (0 where !(n > 0))
//   M2   = (M2_a + M2_b) + ((d*d) * (n_a*n_b)) / n   (0 where !(n > 0)),
//          d = mean_b - mean_a
//   sx   = sx_a + sx_b
//
// Every operation is an explicitly rounded intrinsic (__fadd_rn,
// __fsub_rn, __fmul_rn, __fdiv_rn), so nvcc's default --fmad=true cannot
// contract a product and a sum into an FMA: the result is bitwise equal to
// the plain PyTorch version, whose operations are each rounded on their
// own.
//
// What bounds it on the H100: bytes -- eight planes read once and four
// written once, 48 B an element (1.609 GB at the first reduce level of the
// full-width D = 4 sync, 33,521,664 elements: 0.480 ms at 3.35 TB/s), for
// about 14 flops an element.  The design moves 16 B a load (float4) with
// neighbouring threads on neighbouring addresses, when every pointer is
// 16-byte aligned; the last N % 4 elements (or all of them, unaligned)
// take a scalar path.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void chan(float na, float ma, float qa, float sa,
                                     float nb, float mb, float qb, float sb,
                                     float& n, float& m, float& q, float& s) {
  n = __fadd_rn(na, nb);
  const bool live = n > 0.f;
  const float safe = live ? n : 1.f;
  const float d = __fsub_rn(mb, ma);
  const float mean = __fdiv_rn(__fadd_rn(__fmul_rn(na, ma), __fmul_rn(nb, mb)),
                               safe);
  const float m2 = __fadd_rn(
      __fadd_rn(qa, qb),
      __fdiv_rn(__fmul_rn(__fmul_rn(d, d), __fmul_rn(na, nb)), safe));
  m = live ? mean : 0.f;
  q = live ? m2 : 0.f;
  s = __fadd_rn(sa, sb);
}

__global__ void qo_merge_vec_kernel(
    const float4* __restrict__ na, const float4* __restrict__ ma,
    const float4* __restrict__ qa, const float4* __restrict__ sa,
    const float4* __restrict__ nb, const float4* __restrict__ mb,
    const float4* __restrict__ qb, const float4* __restrict__ sb,
    float4* __restrict__ on, float4* __restrict__ om,
    float4* __restrict__ oq, float4* __restrict__ os, long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 a0 = na[i], a1 = ma[i], a2 = qa[i], a3 = sa[i];
    const float4 b0 = nb[i], b1 = mb[i], b2 = qb[i], b3 = sb[i];
    float4 r0, r1, r2, r3;
    chan(a0.x, a1.x, a2.x, a3.x, b0.x, b1.x, b2.x, b3.x, r0.x, r1.x, r2.x, r3.x);
    chan(a0.y, a1.y, a2.y, a3.y, b0.y, b1.y, b2.y, b3.y, r0.y, r1.y, r2.y, r3.y);
    chan(a0.z, a1.z, a2.z, a3.z, b0.z, b1.z, b2.z, b3.z, r0.z, r1.z, r2.z, r3.z);
    chan(a0.w, a1.w, a2.w, a3.w, b0.w, b1.w, b2.w, b3.w, r0.w, r1.w, r2.w, r3.w);
    on[i] = r0; om[i] = r1; oq[i] = r2; os[i] = r3;
  }
}

__global__ void qo_merge_scalar_kernel(
    const float* __restrict__ na, const float* __restrict__ ma,
    const float* __restrict__ qa, const float* __restrict__ sa,
    const float* __restrict__ nb, const float* __restrict__ mb,
    const float* __restrict__ qb, const float* __restrict__ sb,
    float* __restrict__ on, float* __restrict__ om,
    float* __restrict__ oq, float* __restrict__ os, long long begin,
    long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = begin + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    chan(na[i], ma[i], qa[i], sa[i], nb[i], mb[i], qb[i], sb[i],
         on[i], om[i], oq[i], os[i]);
}

namespace {

// A grid-stride grid: at most the blocks of THREADS that the SMs hold at
// once (2,048 threads an SM: 8 blocks of 256).
template <int THREADS>
unsigned grid_for(long long work) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = (long long)sms * (2048 / THREADS);
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

template <int THREADS>
int launch(const void* const* p, long long n, cudaStream_t st) {
  bool aligned = true;
  for (int i = 0; i < 12; ++i)
    aligned = aligned && ((uintptr_t)p[i] % 16 == 0);
  long long done = 0;
  if (aligned && n >= 4) {
    const long long n4 = n / 4;
    qo_merge_vec_kernel<<<grid_for<THREADS>(n4), THREADS, 0, st>>>(
        (const float4*)p[0], (const float4*)p[1], (const float4*)p[2],
        (const float4*)p[3], (const float4*)p[4], (const float4*)p[5],
        (const float4*)p[6], (const float4*)p[7], (float4*)p[8],
        (float4*)p[9], (float4*)p[10], (float4*)p[11], n4);
    done = n4 * 4;
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  if (done < n) {
    qo_merge_scalar_kernel<<<grid_for<THREADS>(n - done), THREADS, 0, st>>>(
        (const float*)p[0], (const float*)p[1], (const float*)p[2],
        (const float*)p[3], (const float*)p[4], (const float*)p[5],
        (const float*)p[6], (const float*)p[7], (float*)p[8], (float*)p[9],
        (float*)p[10], (float*)p[11], done, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs: a's n, mean, m2, sum_x, then b's; outputs: n, mean, m2, sum_x;
// every plane holds n floats.  threads: threads a block, 128, 256, 512 or
// 1024 (anything else is refused); each element is merged by one thread
// on its own, so every choice gives the same bits.
extern "C" int qo_merge_launch(const void* na, const void* ma, const void* qa,
                               const void* sa, const void* nb, const void* mb,
                               const void* qb, const void* sb, void* on,
                               void* om, void* oq, void* os, long long n,
                               int threads, void* stream) {
  if (threads != 128 && threads != 256 && threads != 512 && threads != 1024)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const void* ptrs[12] = {na, ma, qa, sa, nb, mb, qb, sb, on, om, oq, os};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (threads) {
    case 128: return launch<128>(ptrs, n, st);
    case 512: return launch<512>(ptrs, n, st);
    case 1024: return launch<1024>(ptrs, n, st);
    default: return launch<256>(ptrs, n, st);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
