// Single-table QO absorb (paper Algorithm 1): fold N weighted rows into one
// table of C bins, out of place.
//
// Replaces the TPU kernel src/repro/kernels/qo_update.py::qo_update_pallas.
// The TPU kernel streams 1024-row tiles through VMEM in a sequential grid,
// expands each tile to a one-hot (tile, C) matrix, reduces it on the MXU
// and Chan-merges tile after tile into a table that stays resident across
// grid steps.
//
// What bounds it on the H100: bytes -- x, y, w read once (12 B a row) and
// the four planes of C floats read and written once; the arithmetic is a
// dozen flops a row.  The rows are read in row order, with no sort and no
// gather, and every SM works from the first row to the last:
//
//   qo_update_pieces_kernel: the rows are cut into G contiguous pieces of
//     equal length (the wrapper's G = 264, two blocks on each of 132 SMs,
//     fewer when pieces would hold under 1024 rows); block (g, t) owns
//     piece g and bin range t.  Each warp walks its own 128-row steps of
//     the piece (16-byte loads of x, y, w; bin ids with the reference's
//     integer semantics, ROADMAP C1) into its own (n, sum wy, sum wx)
//     table in shared memory: for 32 rows at a time __match_any_sync
//     groups the lanes of one bin and the lowest lane sums its group in
//     lane order, so every sum runs in a fixed order without atomics, and
//     each row is touched by one warp.  The warps' tables are summed in
//     warp order into the piece's; a second walk over the piece (its rows
//     now in L2) sums w * (y - piece bin mean)^2, the two-pass M2, the
//     same way.  The piece's (n, mean, M2, sum wx) go to scratch.  Bin
//     ranges of at most 1024 bins keep the warps' tables in shared memory
//     (108 KB a block, two blocks an SM) for every C up to MAX_BINS.
//   qo_update_merge_kernel: one warp a bin merges the G partials in piece
//     order -- lane l Chan-merges (Eqs. 4-5) a run of consecutive pieces,
//     then neighbouring runs merge pairwise, the earlier run always on the
//     left -- and merges that into the running table, out of place.  Every
//     bin is merged, also one that received no row, as the reference
//     merges its zero tile (so an empty bin's mean takes the same
//     (n*mean)/n rounding).  This mirrors the TPU kernel, which merges its
//     1024-row tiles in order.
//
// The result is bitwise repeatable: no float atomics.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STEP = 128;                 // rows of a warp step, 4 a lane
constexpr int TILE_BINS = 1024;           // bins a block owns at most
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int bin_id(float x, float o, float r, int C) {
  int h = __float2int_rd((x - o) / r);  // saturating, NaN -> 0 (C1)
  h = (int)((unsigned)h + (unsigned)(C / 2));  // int32 wraparound, as XLA
  return h < 0 ? 0 : (h > C - 1 ? C - 1 : h);
}

// Chan merge (Eqs. 4-5) of (nb, mb, m2b) into (n0, m0, m20), empty-safe,
// with one IEEE reciprocal for both quotients (ROADMAP C11).
__device__ __forceinline__ void chan(float& n0, float& m0, float& m20,
                                     float nb, float mb, float m2b) {
  const float n = n0 + nb;
  const float inv = __frcp_rn(n > 0.f ? n : 1.f);
  const float delta = mb - m0;
  const float mean = (n0 * m0 + nb * mb) * inv;
  const float m2 = m20 + m2b + delta * delta * (n0 * nb) * inv;
  n0 = n;
  m0 = n > 0.f ? mean : 0.f;
  m20 = n > 0.f ? m2 : 0.f;
}

// Rows i..i+3 (those below hi) of x, y, w; zeros past hi.
__device__ __forceinline__ void load4(const float* __restrict__ x,
                                      const float* __restrict__ y,
                                      const float* __restrict__ w,
                                      long long i, long long hi, int vec,
                                      float4& xv, float4& yv, float4& wv) {
  if (vec && i + 3 < hi) {
    xv = *reinterpret_cast<const float4*>(x + i);
    yv = *reinterpret_cast<const float4*>(y + i);
    wv = *reinterpret_cast<const float4*>(w + i);
    return;
  }
  float xs[4] = {0.f, 0.f, 0.f, 0.f}, ys[4] = {0.f, 0.f, 0.f, 0.f};
  float ws[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i + k < hi) { xs[k] = x[i + k]; ys[k] = y[i + k]; ws[k] = w[i + k]; }
  xv = make_float4(xs[0], xs[1], xs[2], xs[3]);
  yv = make_float4(ys[0], ys[1], ys[2], ys[3]);
  wv = make_float4(ws[0], ws[1], ws[2], ws[3]);
}

}  // namespace

// partial: (G, 4, C) floats -- n, mean, M2, sum wx of each piece.
__global__ void __launch_bounds__(THREADS) qo_update_pieces_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ radius,
    const float* __restrict__ origin, float* __restrict__ partial,
    long long N, long long piece_rows, int C, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int c0 = blockIdx.y * TILE_BINS;
  const int Ct = min(TILE_BINS, C - c0);
  const int Cp = (Ct + 3) & ~3;             // plane stride, 16-B aligned
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // warp k's planes: n, sum wy, sum wx at smem + (3k + plane) * Cp
  float* wt = smem + warp * 3 * Cp;
  // the warp's staged step: x, y, w of 128 rows
  float4* st = reinterpret_cast<float4*>(smem + WARPS * 3 * Cp) + warp * 96;
  const float* st_x = reinterpret_cast<const float*>(st);
  const float* st_y = st_x + STEP;
  const float* st_w = st_y + STEP;
  // the block's table after the first pass: warp 0's planes, as n, mean,
  // sum wx; the warps' M2 tables reuse free planes
  float* b_n = smem;
  float* b_mean = smem + Cp;
  float* b_sx = smem + 2 * Cp;
  float* m2t = warp == 0 ? smem + 4 * Cp : wt;

  const long long start = (long long)blockIdx.x * piece_rows;
  const long long end = min(N, start + piece_rows);
  const float o = origin[0], r = radius[0];
  for (int c = t; c < WARPS * 3 * Cp; c += THREADS) smem[c] = 0.f;
  __syncthreads();

  for (int pass = 0; pass < 2; ++pass) {
    float* cn = pass == 0 ? wt : m2t;
    for (long long lo = start + (long long)warp * STEP; lo < end;
         lo += (long long)WARPS * STEP) {
      float4 xv, yv, wv;
      load4(x, y, w, lo + 4 * lane, end, vec, xv, yv, wv);
      st[lane] = xv;
      st[32 + lane] = yv;
      st[64 + lane] = wv;
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
      int bins[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        bins[k] = lo + 4 * lane + k < end ? bin_id(xs[k], o, r, C) - c0 : -1;
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 4; ++k) {         // rows lo + 4l + k, l ascending
        const int bin = bins[k];
        const bool act = bin >= 0 && bin < Ct;
        const unsigned live = __ballot_sync(FULL, act);
        if (act) {
          const unsigned peers = __match_any_sync(live, bin);
          if ((peers & ((1u << lane) - 1u)) == 0u) {   // lowest lane leads
            if (pass == 0) {
              float n = 0.f, sy = 0.f, sx = 0.f;
              for (unsigned m = peers; m; m &= m - 1u) {
                const int q = 4 * (__ffs(m) - 1) + k;
                const float wq = st_w[q];
                n += wq;
                sy += wq * st_y[q];
                sx += wq * st_x[q];
              }
              cn[bin] += n;
              cn[Cp + bin] += sy;
              cn[2 * Cp + bin] += sx;
            } else {
              const float mean = b_mean[bin];
              float m2 = 0.f;
              for (unsigned m = peers; m; m &= m - 1u) {
                const int q = 4 * (__ffs(m) - 1) + k;
                const float d = st_y[q] - mean;
                m2 += st_w[q] * (d * d);
              }
              cn[bin] += m2;
            }
          }
        }
        __syncwarp();          // the next round's leader sees this one's sums
      }
    }
    __syncthreads();
    for (int c = t; c < Ct; c += THREADS) {
      if (pass == 0) {
        // the warps' tables summed in warp order; the planes that the
        // second pass writes are cleared
        float n = 0.f, sy = 0.f, sx = 0.f;
        for (int k = 0; k < WARPS; ++k) {
          const float* u = smem + k * 3 * Cp;
          n += u[c];
          sy += u[Cp + c];
          sx += u[2 * Cp + c];
        }
        b_n[c] = n;
        b_mean[c] = n > 0.f ? sy / n : 0.f;     // the piece's bin mean
        b_sx[c] = sx;
        smem[4 * Cp + c] = 0.f;
        for (int k = 1; k < WARPS; ++k) smem[k * 3 * Cp + c] = 0.f;
      } else {
        float m2 = smem[4 * Cp + c];
        for (int k = 1; k < WARPS; ++k) m2 += smem[k * 3 * Cp + c];
        float* out = partial + (long long)blockIdx.x * 4 * C + c0 + c;
        out[0] = b_n[c];
        out[C] = b_mean[c];
        out[2 * (long long)C] = m2;
        out[3 * (long long)C] = b_sx[c];
      }
    }
    __syncthreads();
  }
}

// One warp a bin: the G partials in piece order, then into the table.
__global__ void __launch_bounds__(THREADS) qo_update_merge_kernel(
    const float* __restrict__ partial, const float* __restrict__ tab_n,
    const float* __restrict__ tab_mean, const float* __restrict__ tab_m2,
    const float* __restrict__ tab_sx, float* __restrict__ out_n,
    float* __restrict__ out_mean, float* __restrict__ out_m2,
    float* __restrict__ out_sx, int G, int C) {
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= C) return;                       // whole warps leave together
  const long long CC = C;
  const int run = (G + 31) / 32;            // consecutive pieces a lane
  const int g0 = lane * run, g1 = min(G, g0 + run);
  float n = 0.f, mean = 0.f, m2 = 0.f, sx = 0.f;
  if (g0 < g1) {
    const float* s = partial + (long long)g0 * 4 * CC + c;
    n = s[0];
    mean = s[CC];
    m2 = s[2 * CC];
    sx = s[3 * CC];
#pragma unroll 4
    for (int g = g0 + 1; g < g1; ++g) {
      const float* u = partial + (long long)g * 4 * CC + c;
      chan(n, mean, m2, u[0], u[CC], u[2 * CC]);
      sx += u[3 * CC];
    }
  }
  for (int d = 1; d < 32; d <<= 1) {        // run l merges run l + d
    const float n2 = __shfl_down_sync(FULL, n, d);
    const float mean2 = __shfl_down_sync(FULL, mean, d);
    const float m22 = __shfl_down_sync(FULL, m2, d);
    const float sx2 = __shfl_down_sync(FULL, sx, d);
    if ((lane & (2 * d - 1)) == 0 && (lane + d) * run < G) {
      chan(n, mean, m2, n2, mean2, m22);
      sx += sx2;
    }
  }
  if (lane == 0) {
    float n0 = tab_n[c], m0 = tab_mean[c], q0 = tab_m2[c];
    chan(n0, m0, q0, n, mean, m2);
    out_n[c] = n0;
    out_mean[c] = m0;
    out_m2[c] = q0;
    out_sx[c] = tab_sx[c] + sx;
  }
}

// G pieces of piece_rows rows (the last may be shorter); partial holds
// G * 4 * C floats.
extern "C" int qo_update_launch(
    const void* x, const void* y, const void* w, const void* radius,
    const void* origin, const void* tab_n, const void* tab_mean,
    const void* tab_m2, const void* tab_sx, void* partial, void* out_n,
    void* out_mean, void* out_m2, void* out_sx, long long N,
    long long piece_rows, int G, int C, void* stream) {
  if (C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (G > 0) {
    const int Ct = C < TILE_BINS ? C : TILE_BINS;
    const int Cp = (Ct + 3) & ~3;
    const size_t shmem =
        (size_t)(WARPS * 3 * Cp + WARPS * 3 * STEP) * sizeof(float);
    if (shmem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          qo_update_pieces_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)shmem);
      if (e != cudaSuccess) return (int)e;
    }
    const int vec = (((size_t)x | (size_t)y | (size_t)w) & 15u) == 0;
    const dim3 grid((unsigned)G, (unsigned)((C + TILE_BINS - 1) / TILE_BINS));
    qo_update_pieces_kernel<<<grid, THREADS, shmem, s>>>(
        (const float*)x, (const float*)y, (const float*)w,
        (const float*)radius, (const float*)origin, (float*)partial, N,
        piece_rows, C, vec);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  qo_update_merge_kernel<<<(unsigned)((C + WARPS - 1) / WARPS), THREADS, 0,
                           s>>>(
      (const float*)partial, (const float*)tab_n, (const float*)tab_mean,
      (const float*)tab_m2, (const float*)tab_sx, (float*)out_n,
      (float*)out_mean, (float*)out_m2, (float*)out_sx, G, C);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
