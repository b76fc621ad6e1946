// Single-table QO split query (paper Algorithm 2), argmax fused.
//
// Replaces the TPU kernel src/repro/kernels/qo_query.py::qo_query_pallas
// and the argmax epilogue of src/repro/kernels/ops.py::qo_best_split.  The
// TPU kernel lays the C bins across vector lanes and runs log2(C)
// Hillis-Steele shift-and-merge steps over them, then gathers prototypes
// with one-hot sums.  Here one block of T threads (T a power of two, at
// most 1024) owns the table; thread t owns the E = ceil(C / T) contiguous
// bins [t*E, (t+1)*E):
//
//   1. each thread Chan-merges its own occupied bins in order (an empty bin
//      is the merge's identity) and finds its first and last occupied bin;
//      prototypes sum_x / n go to shared memory;
//   2. block scans over the T thread aggregates in shared memory: an
//      inclusive Hillis-Steele Chan-merge scan (the thread's exclusive
//      prefix is its left neighbour's inclusive one, the table total the
//      last thread's), a max-scan of the last occupied bin and a reverse
//      min-scan of the first occupied bin;
//   3. each thread walks its bins backward for the next occupied bin after
//      each one, then forward for the inclusive prefix, the right-hand
//      complement by the paper's subtraction (Eqs. 6-7), the variance
//      reduction VR, and the candidate threshold at the midpoint of the
//      neighbouring occupied prototypes; it writes the (C,) score row (-inf
//      where no occupied bin lies on one side) and threshold row;
//   4. a block reduction picks the best boundary as jnp.argmax does (the
//      first NaN, else the first maximum) and writes [threshold, merit,
//      valid]: merit 0 and valid 0 where the best score is not finite.
//
// What bounds it on the H100: nothing a table of C = 1024 bins could
// fill -- 16 KB read and 8 KB written, a few hundred flops a bin; one
// block on one SM, so the time is launch latency plus the 3 log2(T)
// barrier-separated scan steps.
#include <cuda_runtime.h>
#include <climits>

__device__ __forceinline__ float var_of(float n, float m2) {
  float d = n - 1.f;
  return d > 0.f ? m2 / d : 0.f;
}

// Chan merge (Eqs. 4-5) of (an, am, a2) on the left with (bn, bm, b2).
__device__ __forceinline__ void chan(float an, float am, float a2, float& bn,
                                     float& bm, float& b2) {
  float n = an + bn;
  float safe = n > 0.f ? n : 1.f;
  float delta = bm - am;
  float mean = (an * am + bn * bm) / safe;
  float m2 = a2 + b2 + delta * delta * (an * bn) / safe;
  bn = n;
  bm = n > 0.f ? mean : 0.f;
  b2 = n > 0.f ? m2 : 0.f;
}

struct Best {
  float v;
  int i;     // INT_MAX: nothing seen yet
  float cd;  // the candidate threshold at bin i
};

// jnp.argmax order: a NaN beats every number, the lower index wins a tie.
__device__ __forceinline__ Best better(Best a, Best b) {
  if (a.i == INT_MAX) return b;
  if (b.i == INT_MAX) return a;
  bool an = a.v != a.v, bn = b.v != b.v;
  if (an || bn) {
    if (an && bn) return a.i < b.i ? a : b;
    return an ? a : b;
  }
  if (a.v != b.v) return a.v > b.v ? a : b;
  return a.i < b.i ? a : b;
}

__global__ void qo_query_kernel(const float* __restrict__ tab_n,
                                const float* __restrict__ tab_mean,
                                const float* __restrict__ tab_m2,
                                const float* __restrict__ tab_sx,
                                float* __restrict__ score,
                                float* __restrict__ cand,
                                float* __restrict__ result, int C, int E) {
  extern __shared__ float smem[];
  const int T = blockDim.x, t = threadIdx.x;
  float* s_proto = smem;                       // C
  int* s_nxt = (int*)(s_proto + C);            // C
  float* s_a = (float*)(s_nxt + C);            // T each
  float* s_b = s_a + T;
  float* s_c = s_b + T;
  int* s_i = (int*)(s_c + T);
  int* s_j = s_i + T;

  const int lo = min(t * E, C), hi = min(lo + E, C);

  // 1. own aggregate, own first/last occupied bin, prototypes
  float an = 0.f, am = 0.f, a2 = 0.f;
  int first = INT_MAX, last = -1;
  for (int c = lo; c < hi; ++c) {
    float bn = tab_n[c];
    bool occ = bn > 0.f;
    s_proto[c] = occ ? tab_sx[c] / bn : 0.f;
    if (!occ) continue;
    float bm = tab_mean[c], b2 = tab_m2[c];
    chan(an, am, a2, bn, bm, b2);
    an = bn; am = bm; a2 = b2;
    if (first == INT_MAX) first = c;
    last = c;
  }

  // 2. block scans
  s_a[t] = an; s_b[t] = am; s_c[t] = a2; s_i[t] = last; s_j[t] = first;
  __syncthreads();
  for (int d = 1; d < T; d <<= 1) {
    float xn = 0.f, xm = 0.f, x2 = 0.f;
    int xl = -1, xf = INT_MAX;
    if (t >= d) { xn = s_a[t - d]; xm = s_b[t - d]; x2 = s_c[t - d];
                  xl = s_i[t - d]; }
    if (t + d < T) xf = s_j[t + d];
    __syncthreads();
    if (t >= d) {
      float cn = s_a[t], cm = s_b[t], c2 = s_c[t];
      chan(xn, xm, x2, cn, cm, c2);
      s_a[t] = cn; s_b[t] = cm; s_c[t] = c2;
      s_i[t] = max(s_i[t], xl);
    }
    if (t + d < T) s_j[t] = min(s_j[t], xf);
    __syncthreads();
  }
  const float tn = s_a[T - 1], tmean = s_b[T - 1], tm2 = s_c[T - 1];
  float pn = 0.f, pmean = 0.f, pm2 = 0.f;
  int run_last = -1;
  if (t > 0) { pn = s_a[t - 1]; pmean = s_b[t - 1]; pm2 = s_c[t - 1];
               run_last = s_i[t - 1]; }
  int run_next = t + 1 < T ? s_j[t + 1] : INT_MAX;

  // 3a. next occupied bin strictly after each own bin (C: none)
  for (int c = hi - 1; c >= lo; --c) {
    s_nxt[c] = run_next == INT_MAX ? C : run_next;
    if (tab_n[c] > 0.f) run_next = c;
  }
  __syncthreads();

  // 3b. prefix, complement, VR, candidate threshold, own best
  const float s2_d = var_of(tn, tm2);
  const float n_tot = fmaxf(tn, 1.f);
  const float safe_tot = tn > 0.f ? tn : 1.f;
  Best best = {0.f, INT_MAX, 0.f};
  for (int c = lo; c < hi; ++c) {
    float bn = tab_n[c];
    if (bn > 0.f) {
      float bm = tab_mean[c], b2 = tab_m2[c];
      chan(pn, pmean, pm2, bn, bm, b2);
      pn = bn; pmean = bm; pm2 = b2;
      run_last = c;
    }
    float rn = tn - pn;
    float rmean = rn > 0.f ? (tn * tmean - pn * pmean) / rn : 0.f;
    float d = pmean - rmean;
    float rm2 = tm2 - pm2 - d * d * (rn * pn) / safe_tot;
    rm2 = rn > 0.f ? fmaxf(rm2, 0.f) : 0.f;
    float vr = s2_d - (pn / n_tot) * var_of(pn, pm2)
               - (rn / n_tot) * var_of(rn, rm2);
    int nxt = s_nxt[c];
    bool ok = run_last >= 0 && nxt < C;
    float sc = ok ? vr : __int_as_float(0xff800000);  // -inf
    float cd = 0.5f * (s_proto[max(run_last, 0)] + s_proto[min(nxt, C - 1)]);
    score[c] = sc;
    cand[c] = cd;
    best = better(best, Best{sc, c, cd});
  }

  // 4. block argmax
  __syncthreads();
  s_a[t] = best.v;
  s_i[t] = best.i;
  s_b[t] = best.cd;
  __syncthreads();
  for (int s = T >> 1; s > 0; s >>= 1) {
    if (t < s) {
      Best o = better(Best{s_a[t], s_i[t], s_b[t]},
                      Best{s_a[t + s], s_i[t + s], s_b[t + s]});
      s_a[t] = o.v;
      s_i[t] = o.i;
      s_b[t] = o.cd;
    }
    __syncthreads();
  }
  if (t == 0) {
    float v = s_a[0];
    bool finite = isfinite(v);
    result[0] = s_b[0];
    result[1] = finite ? v : 0.f;
    result[2] = finite ? 1.f : 0.f;
  }
}

extern "C" int qo_query_launch(const void* tab_n, const void* tab_mean,
                               const void* tab_m2, const void* tab_sx,
                               void* score, void* cand, void* result, int C,
                               void* stream) {
  if (C <= 0) return 0;
  int T = 32;
  while (T < C && T < 1024) T <<= 1;
  int E = (C + T - 1) / T;
  size_t shmem = (size_t)C * 8 + (size_t)T * 20;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        qo_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  qo_query_kernel<<<1, T, shmem, (cudaStream_t)stream>>>(
      (const float*)tab_n, (const float*)tab_mean, (const float*)tab_m2,
      (const float*)tab_sx, (float*)score, (float*)cand, (float*)result, C,
      E);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
