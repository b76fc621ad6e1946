// Single-table QO split query (paper Algorithm 2), argmax fused.
//
// Replaces the TPU kernel src/repro/kernels/qo_query.py::qo_query_pallas
// and the argmax epilogue of src/repro/kernels/ops.py::qo_best_split.  The
// TPU kernel lays the C bins across vector lanes and runs log2(C)
// Hillis-Steele shift-and-merge steps over them, then gathers prototypes
// with one-hot sums.  Here one block owns the table and one warp a chunk
// of 32 bins (at most 32 warps; past 1,024 bins each warp takes every
// 32nd chunk), in the batched query's order (qo_query_common.cuh):
//
//   1. each warp: a Kogge-Stone prefix Chan merge over its chunk, the
//      chunk's occupancy ballot, and into shared memory the chunk's total
//      and its first and last occupied prototype;
//   2. one thread folds the chunk totals left to right into each chunk's
//      entry aggregate and the table total (C = 1,024: 32 dependent
//      merges); meanwhile another carries the last occupied prototype
//      before each chunk and the first one after it;
//   3. each warp merges its chunk's entry in on the left of its prefix,
//      takes the complement by subtraction (one reciprocal of the total's
//      count a table) and the VR of every boundary, the occupied
//      neighbours of each bin from the ballot (else the carried ones), and
//      writes the (C,) score row (-inf where no occupied bin lies on one
//      side) and the candidate threshold row (the midpoint of the
//      neighbouring prototypes, as the plain version defines it at every
//      bin); each lane keeps its best bin;
//   4. the argmax as one 64-bit key (ordered score bits, then the bin
//      inverted: a NaN first, then the larger score, then the lower bin,
//      jnp.argmax's pick): a butterfly inside each warp, then across the
//      warps; result = [threshold, merit, valid], merit 0 and valid 0
//      where the best score is not finite.
//
// Three block barriers in all.  Every operation is explicitly rounded, so
// a rerun is bitwise equal and so is the float32 model of this order
// (tests/test_torch_kernels.py::model_scores, which the batched query
// shares).
//
// What bounds it on the H100: latency.  A table of C = 1,024 bins is 16 KB
// read and 8 KB written (7 ns at 3.35 TB/s); the time is the launch, two
// dependent global round trips (load, store) and the chain of merges: 5
// Kogge-Stone merges in steps 1 and 3 each, and the fold's C / 32.
#include "qo_query_common.cuh"

namespace {

constexpr int MAX_WARPS = 32;

// step 1's record of a chunk
struct ChunkSum {
  Stat s;           // the chunk's total
  unsigned occ;     // its occupancy ballot
  float first, last;  // its first and last occupied prototype
};

// step 2's record of a chunk
struct ChunkEntry {
  Stat carry;       // the merge of every earlier chunk
  int l_has, n_has;  // an occupied bin before / after the chunk
  float l_val, n_val;  // the last before it / the first after it
};

}  // namespace

// RESIDENT: at most 32 chunks, one a warp, held in registers from step 1
// to step 3; otherwise each warp loads and scans its chunks again in
// step 3 (the same order, so the same values).
template <bool RESIDENT>
__global__ void __launch_bounds__(MAX_WARPS * 32) qo_query_kernel(
    const float* __restrict__ tab_n, const float* __restrict__ tab_mean,
    const float* __restrict__ tab_m2, const float* __restrict__ tab_sx,
    float* __restrict__ score, float* __restrict__ cand,
    float* __restrict__ result, int C, int nch) {
  extern __shared__ uint64_t smem_u64[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  uint64_t* w_key = smem_u64;                              // warps
  float* w_best = reinterpret_cast<float*>(w_key + MAX_WARPS);
  float* w_cand = w_best + MAX_WARPS;
  Stat* total = reinterpret_cast<Stat*>(w_cand + MAX_WARPS);
  ChunkSum* sums = reinterpret_cast<ChunkSum*>(total + 1);  // nch
  ChunkEntry* entries = reinterpret_cast<ChunkEntry*>(sums + nch);  // nch

  // 1. chunk prefixes and chunk records
  Chunk b_res;
  Stat p_res;
  for (int ch = warp; ch < nch; ch += warps) {
    const int c = ch * 32 + lane;
    const Chunk b = load(tab_n, tab_mean, tab_m2, tab_sx, 0, c, c < C);
    const Stat p = prefix_scan<32>(b.s, lane);
    const unsigned om = occupied<32>(b.occ, lane);
    const float first = chunk_first<32>(om, b.proto);
    const float last = chunk_last<32>(om, b.proto);
    if (lane == 31) sums[ch] = ChunkSum{p, om, first, last};
    if constexpr (RESIDENT) {
      b_res = b;
      p_res = p;
    }
  }
  __syncthreads();

  // 2. the fold over the chunk totals (thread 0), and the neighbour
  // carries (the second warp's first thread, where there is one)
  if (threadIdx.x == 0) {
    Stat carry{0.f, 0.f, 0.f};
#pragma unroll 4
    for (int ch = 0; ch < nch; ++ch) {
      entries[ch].carry = carry;
      carry = chan(carry, sums[ch].s);
    }
    *total = carry;
  }
  if (threadIdx.x == (warps > 1 ? 32 : 0)) {
    int has = 0;
    float val = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      entries[ch].l_has = has;
      entries[ch].l_val = val;
      if (sums[ch].occ) { has = 1; val = sums[ch].last; }
    }
    has = 0;
    val = 0.f;
    for (int ch = nch - 1; ch >= 0; --ch) {
      entries[ch].n_has = has;
      entries[ch].n_val = val;
      if (sums[ch].occ) { has = 1; val = sums[ch].first; }
    }
  }
  __syncthreads();

  // 3. per bin: prefix, VR, neighbours, candidate; each lane's best
  const Total tot = total_of(*total);
  float best = __int_as_float(0xff800000), best_cand = 0.f;  // -inf
  int best_bin = INT_MAX;
  for (int ch = warp; ch < nch; ch += warps) {
    const int c = ch * 32 + lane;
    Chunk b;
    Stat local;
    if constexpr (RESIDENT) {
      b = b_res;
      local = p_res;
    } else {
      b = load(tab_n, tab_mean, tab_m2, tab_sx, 0, c, c < C);
      local = prefix_scan<32>(b.s, lane);
    }
    const ChunkEntry e = entries[ch];
    const Stat p = chan(e.carry, local);
    const unsigned om = occupied<32>(b.occ, lane);
    Near nb = near_in_chunk<32>(om, b.proto, lane);
    if (!nb.l_has) { nb.l_has = e.l_has; nb.l_val = e.l_val; }
    // none after: the plain version's clamp reads bin C - 1's prototype
    // (0 unless this is bin C - 1 itself)
    if (!nb.n_has) {
      nb.n_has = e.n_has;
      nb.n_val = e.n_has ? e.n_val : (c == C - 1 ? b.proto : 0.f);
    }
    if (c < C) {
      const float sc = nb.l_has && nb.n_has ? boundary_vr(p, tot)
                                            : __int_as_float(0xff800000);
      const float cd = midpoint(nb.l_val, nb.n_val);
      score[c] = sc;
      cand[c] = cd;
      if (better(sc, c, best, best_bin)) {
        best = sc;
        best_bin = c;
        best_cand = cd;
      }
    }
  }

  // 4. argmax: inside the warp, then across the warps
  uint64_t key = max_key<32>(pick_key(best, best_bin));
  int src = key_bin(key) & 31;
  best = __shfl_sync(FULL, best, src);
  best_cand = __shfl_sync(FULL, best_cand, src);
  if (lane == 0) {
    w_key[warp] = key;
    w_best[warp] = best;
    w_cand[warp] = best_cand;
  }
  __syncthreads();
  if (warp == 0) {
    key = max_key<32>(lane < warps ? w_key[lane] : 0ull);
    src = (key_bin(key) >> 5) % warps;  // the warp that owns its chunk
    if (lane == 0) {
      const float v = w_best[src];
      const bool finite = isfinite(v);
      result[0] = w_cand[src];
      result[1] = finite ? v : 0.f;
      result[2] = finite ? 1.f : 0.f;
    }
  }
}

extern "C" int qo_query_launch(const void* tab_n, const void* tab_mean,
                               const void* tab_m2, const void* tab_sx,
                               void* score, void* cand, void* result, int C,
                               void* stream) {
  if (C <= 0) return 0;
  const int nch = (C + 31) / 32;
  const int warps = nch < MAX_WARPS ? nch : MAX_WARPS;
  const size_t shmem = MAX_WARPS * (sizeof(uint64_t) + 2 * sizeof(float))
      + sizeof(Stat) + (size_t)nch * (sizeof(ChunkSum) + sizeof(ChunkEntry));
  if (shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const auto *n = (const float*)tab_n, *mu = (const float*)tab_mean,
             *m2 = (const float*)tab_m2, *sx = (const float*)tab_sx;
  auto *sc = (float*)score, *cd = (float*)cand, *r = (float*)result;
  const cudaStream_t st = (cudaStream_t)stream;
  if (nch <= MAX_WARPS)
    qo_query_kernel<true><<<1, warps * 32, shmem, st>>>(n, mu, m2, sx, sc, cd,
                                                         r, C, nch);
  else
    qo_query_kernel<false><<<1, warps * 32, shmem, st>>>(n, mu, m2, sx, sc,
                                                          cd, r, C, nch);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
