// QO split query over the K attempting (leaf, feature) tables, argmax fused.
//
// Replaces the TPU kernel
// src/repro/kernels/qo_query_batched.py::qo_query_batched_pallas plus the
// per-table argmax epilogue of src/repro/kernels/ops.py::_query_full.  The
// TPU kernel lays a (tile_m, 128) slab of tables across vector lanes and
// runs a Hillis-Steele prefix Chan merge over the bins of every table of
// the slab, skipping slabs with no attempting leaf.  Here the wrapper has
// already compacted the attempting leaves (torch.nonzero on the attempt
// mask), so the grid covers exactly the K*F tables that are queried, and
// one thread owns one table:
//
//   pass 1  the total (n, mean, M2) of the table, by sequential Chan merges
//           of its occupied bins;
//   pass 2  the inclusive prefix merge bin by bin; at each occupied bin the
//           right-hand complement by the paper's subtraction (Eqs. 6-7) and
//           the variance reduction VR; the candidate threshold is the
//           midpoint of this bin's prototype (sum_x / n) and the next
//           occupied bin's, so a boundary counts once that bin is found;
//   argmax  the best boundary as jnp.argmax picks it: a NaN wins, else the
//           first maximum.  Writes merit and threshold, (K, F) each;
//           -inf / 0 where the table has no valid boundary.
//
// An empty bin changes neither the prefix nor the neighbouring prototypes,
// so boundaries at empty bins repeat the previous occupied boundary's VR
// and threshold and can never be a first maximum: skipping them leaves the
// argmax unchanged.
//
// What bounds it on the H100: the bytes of the K*F queried tables (four
// planes of C floats each, read once) -- about 1 us per 1,000 tables at
// C=64.  One thread per table reads its bins with a stride of C floats
// between neighbouring threads, which wastes most of each 32 B sector;
// the warp-per-table layout with shuffle scans is a later PR's work.
#include <cuda_runtime.h>

__device__ __forceinline__ float var_of(float n, float m2) {
  float d = n - 1.f;
  return d > 0.f ? m2 / d : 0.f;
}

__global__ void qo_query_batched_kernel(
    const int* __restrict__ rows, const float* __restrict__ tab_n,
    const float* __restrict__ tab_mean, const float* __restrict__ tab_m2,
    const float* __restrict__ tab_sx, float* __restrict__ merit,
    float* __restrict__ thr, int K, int F, int C) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)K * F) return;
  int k = (int)(i / F);
  int f = (int)(i - (long long)k * F);
  const long long base = ((long long)rows[k] * F + f) * C;
  const float* n = tab_n + base;
  const float* mu = tab_mean + base;
  const float* m2 = tab_m2 + base;
  const float* sx = tab_sx + base;

  // pass 1: table total by sequential Chan merges (Eqs. 4-5)
  float tn = 0.f, tmean = 0.f, tm2 = 0.f;
  for (int c = 0; c < C; ++c) {
    float bn = n[c];
    if (!(bn > 0.f)) continue;
    float bmean = mu[c];
    float s = tn + bn;
    float delta = bmean - tmean;
    tmean = (tn * tmean + bn * bmean) / s;
    tm2 = tm2 + m2[c] + delta * delta * (tn * bn) / s;
    tn = s;
  }
  const float s2_d = var_of(tn, tm2);
  const float n_tot = fmaxf(tn, 1.f);
  const float safe_tot = tn > 0.f ? tn : 1.f;

  // pass 2: prefix, complement, VR, neighbouring-prototype thresholds
  float pn = 0.f, pmean = 0.f, pm2 = 0.f;
  bool pending = false;          // an occupied bin waiting for its neighbour
  float pend_vr = 0.f, pend_proto = 0.f;
  float best = __int_as_float(0xff800000), best_thr = 0.f;  // -inf
  bool best_nan = false;
  for (int c = 0; c < C; ++c) {
    float bn = n[c];
    if (!(bn > 0.f)) continue;
    float proto = sx[c] / bn;
    if (pending && !best_nan) {
      if (pend_vr != pend_vr) {  // NaN (no fast-math: compares are IEEE)
        best = pend_vr;
        best_thr = 0.5f * (pend_proto + proto);
        best_nan = true;
      } else if (pend_vr > best) {
        best = pend_vr;
        best_thr = 0.5f * (pend_proto + proto);
      }
    }
    float bmean = mu[c];
    float s = pn + bn;
    float delta = bmean - pmean;
    pmean = (pn * pmean + bn * bmean) / s;
    pm2 = pm2 + m2[c] + delta * delta * (pn * bn) / s;
    pn = s;

    float rn = tn - pn;
    float rmean = rn > 0.f ? (tn * tmean - pn * pmean) / rn : 0.f;
    float d = pmean - rmean;
    float rm2 = tm2 - pm2 - d * d * (rn * pn) / safe_tot;
    rm2 = rn > 0.f ? fmaxf(rm2, 0.f) : 0.f;
    pend_vr = s2_d - (pn / n_tot) * var_of(pn, pm2)
              - (rn / n_tot) * var_of(rn, rm2);
    pend_proto = proto;
    pending = true;
  }
  merit[i] = best;
  thr[i] = best_thr;
}

extern "C" int qo_query_batched_launch(const void* rows, const void* tab_n,
                                       const void* tab_mean,
                                       const void* tab_m2, const void* tab_sx,
                                       void* merit, void* thr, int K, int F,
                                       int C, void* stream) {
  long long n = (long long)K * F;
  if (n == 0) return 0;
  const int threads = 128;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  qo_query_batched_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)rows, (const float*)tab_n, (const float*)tab_mean,
      (const float*)tab_m2, (const float*)tab_sx, (float*)merit, (float*)thr,
      K, F, C);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
