// Level-synchronous routing of B rows through T trees at once.
//
// Replaces the TPU kernel src/repro/kernels/qo_route.py::qo_route_pallas
// (body _qo_route_kernel).  The TPU kernel advances a (tile_b,) slice of
// row states per grid step with a one-hot (tile_b, Np) @ (Np, 128) MXU
// contraction per ply over tables folded and self-looped on the host,
// because a TPU has no cheap gather.  Here the kernel reads the tree
// arrays as the caller holds them -- feature (T, M) i32, threshold (T, M)
// f32, child (T, M, 2) i32 with -1 at leaves, is_leaf (T, M) bool -- so a
// route is one launch and no other device op.
//
// One block owns one tree and a tile of ROWS rows, one thread a row (ROWS
// is the launch's schedule: 128, 256 or 512, one template instantiation
// each, kernels/qo_route.py::ROWS_CHOICES; 256 unless the caller picks
// another; every choice gives the same ids):
//
//   1. the block packs its tree's M nodes into shared memory as 16-byte
//      records {feature, threshold bits, left, right}, a leaf self-looped
//      (left = right = itself);
//   2. each thread walks its row down: per ply one 16-byte shared load of
//      the node and one 4-byte load of x (the block's rows of X stay in
//      L1 after their first ply), and it stops at the first self-looped
//      node, a leaf (an inner node's children differ from it).
//
// A tree whose records do not fit in the block's shared memory (M * 16 B
// past the opt-in limit, M > 14,000 or so) is read from the global arrays
// instead, the same record assembled per ply: a template variant of the
// same kernel, chosen by the launcher from M.
//
// What bounds it on the H100: latency, not bytes.  The bytes it must move
// -- 17 a node the trees have allocated, B*F*4 of X, T*B*4 of ids -- take
// about a fifth of a microsecond at 3.35 TB/s.  The parent design (a
// thread a (tree, row), both loads of a ply dependent round trips to L2)
// spent ~8.7 us; here a ply's node load stays in shared memory, its x load
// hits L1 after the row's first ply, and the block's fill is one round of
// independent, coalesced loads.
//
// Semantics: node' = x[feature] <= threshold ? left : right.  A NaN
// compares false and goes right, as in the reference.  Output is the
// (T, B) local leaf id after at most `plies` plies.
#include <cuda_runtime.h>

namespace {

// The 16-byte record of node j of one tree (arrays offset to the tree).
__device__ __forceinline__ int4 node_record(const int* __restrict__ feature,
                                            const float* __restrict__ thr,
                                            const int* __restrict__ child,
                                            const bool* __restrict__ is_leaf,
                                            int j) {
  const bool leaf = is_leaf[j];
  const int f = feature[j];
  const float th = thr[j];
  const int l = child[2 * j], r = child[2 * j + 1];
  return leaf ? make_int4(0, 0, j, j) : make_int4(f, __float_as_int(th), l, r);
}

}  // namespace

template <int ROWS, bool NODES_SMEM>
__global__ void __launch_bounds__(ROWS) qo_route_kernel(
    const int* __restrict__ feature, const float* __restrict__ threshold,
    const int* __restrict__ child, const bool* __restrict__ is_leaf,
    const float* __restrict__ x, int* __restrict__ out, int M, int B, int F,
    int plies) {
  extern __shared__ int4 smem[];
  const int t = blockIdx.y;
  const int r0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, B - r0);
  const long long base = (long long)t * M;
  const int* tf = feature + base;
  const float* tt = threshold + base;
  const int* tc = child + 2 * base;
  const bool* tl = is_leaf + base;
  int4* nodes = smem;

  if constexpr (NODES_SMEM) {
    for (int j = threadIdx.x; j < M; j += ROWS)
      nodes[j] = node_record(tf, tt, tc, tl, j);
    __syncthreads();
  }

  const int i = threadIdx.x;
  if (i >= rows) return;
  const float* xr = x + (long long)(r0 + i) * F;
  int node = 0;
  for (int p = 0; p < plies; ++p) {
    const int4 rec = NODES_SMEM ? nodes[node]
                                : node_record(tf, tt, tc, tl, node);
    if (rec.z == node) break;  // a leaf: every further ply is a self-loop
    const float v = xr[rec.x];
    node = v <= __int_as_float(rec.y) ? rec.z : rec.w;
  }
  out[(long long)t * B + r0 + i] = node;
}

namespace {

template <int ROWS, bool NODES_SMEM>
int launch(const int* feature, const float* threshold, const int* child,
           const bool* is_leaf, const float* x, int* out, int T, int M, int B,
           int F, int plies, size_t shmem, cudaStream_t st) {
  auto kernel = qo_route_kernel<ROWS, NODES_SMEM>;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + ROWS - 1) / ROWS, T);
  kernel<<<grid, ROWS, shmem, st>>>(feature, threshold, child, is_leaf, x,
                                    out, M, B, F, plies);
  return (int)cudaGetLastError();
}

template <int ROWS>
int launch_rows(const int* feature, const float* threshold, const int* child,
                const bool* is_leaf, const float* x, int* out, int T, int M,
                int B, int F, int plies, size_t node_bytes, int optin,
                cudaStream_t st) {
  if (node_bytes <= (size_t)optin)
    return launch<ROWS, true>(feature, threshold, child, is_leaf, x, out, T,
                              M, B, F, plies, node_bytes, st);
  return launch<ROWS, false>(feature, threshold, child, is_leaf, x, out, T,
                             M, B, F, plies, 0, st);
}

}  // namespace

// rows: rows a block, 128, 256 or 512 (anything else is refused).
extern "C" int qo_route_launch(const void* feature, const void* threshold,
                               const void* child, const void* is_leaf,
                               const void* x, void* out, int T, int M, int B,
                               int F, int plies, int rows, void* stream) {
  if (rows != 128 && rows != 256 && rows != 512)
    return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0) return 0;
  if (T > 65535) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t node_bytes = (size_t)M * sizeof(int4);
  const auto* f = (const int*)feature;
  const auto* th = (const float*)threshold;
  const auto* c = (const int*)child;
  const auto* l = (const bool*)is_leaf;
  const auto* xx = (const float*)x;
  auto* o = (int*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (rows) {
    case 128:
      return launch_rows<128>(f, th, c, l, xx, o, T, M, B, F, plies,
                              node_bytes, optin, st);
    case 512:
      return launch_rows<512>(f, th, c, l, xx, o, T, M, B, F, plies,
                              node_bytes, optin, st);
    default:
      return launch_rows<256>(f, th, c, l, xx, o, T, M, B, F, plies,
                              node_bytes, optin, st);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
