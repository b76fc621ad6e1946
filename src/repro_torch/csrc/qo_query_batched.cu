// QO split query over the K attempting (leaf, feature) tables, argmax fused.
//
// Replaces the TPU kernel
// src/repro/kernels/qo_query_batched.py::qo_query_batched_pallas plus the
// per-table argmax epilogue of src/repro/kernels/ops.py::_query_full.  The
// TPU kernel lays a (tile_m, 128) slab of tables across vector lanes and
// runs a Hillis-Steele prefix Chan merge over the bins of every table of
// the slab.  Here the wrapper has compacted the attempting leaves
// (torch.nonzero on the attempt mask), so the grid covers exactly the K*F
// queried tables, and one warp owns one table with its lanes on
// consecutive bins -- each plane of a 32-bin chunk is one coalesced 128 B
// load.  Tables of C <= 16 bins (the sketch's K slots) go two to a warp,
// 16 lanes each, with segmented shuffles (``width`` = 16).
//
// Per table, over chunks of W = 32 (or 16) bins:
//
//   prefix   a Kogge-Stone shuffle scan of the Chan merge (paper Eqs.
//            4-5, one reciprocal a merge), the TPU kernel's own order
//            within a chunk; the running aggregate of the earlier chunks
//            is merged in on the left.  An empty operand is an exact
//            identity on either side, so an empty bin never moves a mean
//            by an ulp;
//   total    the last lane's prefix after the last chunk.  Up to 4 chunks
//            (C <= 128, the forest's C = 64 among them) stay in registers:
//            every load is issued at once and the chunks' scans are
//            independent.  Past that a first pass carries the prefix to
//            the total and keeps each chunk's entry aggregate in shared
//            memory, and a second pass recomputes each chunk's prefix;
//   per bin  the complement by the paper's subtraction (Eqs. 6-7) and the
//            variance reduction VR; the last occupied prototype at or
//            before the bin and the first strictly after it, found from
//            the chunk's occupancy ballot (the highest set bit at or below
//            the lane, the lowest above it; one shuffle fetches each) and
//            otherwise carried from the nearest occupied chunk -- the same
//            selection as a max-scan up and a min-scan down of the bin
//            index, without their 20 shuffles a chunk; the candidate is
//            their midpoint, valid where both exist;
//   argmax   each lane keeps its best bin, then a butterfly max over the
//            lanes of one 64-bit key (the score's ordered bits, then the
//            bin inverted): a NaN wins, then the larger score, then the
//            lower bin -- jnp.argmax's pick, in any order of comparison.
//            The winner's lane reports merit and threshold (-inf / 0
//            where the table has no valid boundary).
//
// Every operation is an explicitly rounded intrinsic (no contraction into
// FMAs; reciprocals and divisions IEEE, __frcp_rn / __fdiv_rn) and the
// shuffle order is fixed, so a rerun is bitwise equal, and so is a
// float32 model of the same order (tests/test_torch_kernels.py).  The
// device code it shares with the single-table query (csrc/qo_query.cu)
// is in qo_query_common.cuh.
//
// What bounds it on the H100: the bytes of the K*F queried tables (four
// planes of C floats each, read once) -- about 0.3 us per 1,000 tables at
// C = 64.  The kernel is held instead by the issue of its dependent
// chains (each Kogge-Stone step a shuffle and a Chan merge with an IEEE
// reciprocal; PERF.md has the time a table); the ballots in place of
// neighbour scans and a compile-time width are what brought it there.
#include "qo_query_common.cuh"

namespace {

// The VR of the boundary after lane's bin c (prefix p) where it is valid,
// and the lane's running best with its candidate threshold.
__device__ __forceinline__ void score_bin(Stat p, const Total& T, bool valid,
                                          float l_val, float n_val, int c,
                                          float& best, int& best_bin,
                                          float& best_cand) {
  const float score = valid ? boundary_vr(p, T) : __int_as_float(0xff800000);
  if (better(score, c, best, best_bin)) {
    best = score;
    best_bin = c;
    best_cand = midpoint(l_val, n_val);
  }
}

}  // namespace

// NCH > 0: the table's NCH chunks (C <= NCH * W) held in registers, all
// loads in flight at once and the chunks' scans independent; NCH == 0:
// any C, two passes over the chunks with each chunk's entry aggregate in
// shared memory.  MAX_WARPS: the most warps a block (the launch's
// schedule: 1, 2, 4 or 8, one instantiation each,
// kernels/qo_query_batched.py::WARPS_CHOICES; 4 unless the caller picks
// another, since 4 rather than 8 evened out the last wave of blocks over
// the SMs at the forest's shapes); fewer when C is large.  A warp owns its
// table(s) alone, so every choice gives the same bits.
template <int W, int NCH, int MAX_WARPS>
__global__ void __launch_bounds__(MAX_WARPS * 32) qo_query_batched_kernel(
    const int* __restrict__ rows, const float* __restrict__ tab_n,
    const float* __restrict__ tab_mean, const float* __restrict__ tab_m2,
    const float* __restrict__ tab_sx, float* __restrict__ merit,
    float* __restrict__ thr, int K, int F, int C, int nch) {
  extern __shared__ float smem[];  // NCH == 0: 5 floats a chunk a table
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = 32 / W;
  const int sl = lane & (W - 1);
  const int first = (blockIdx.x * (blockDim.x >> 5) + warp) * per_warp;
  const int tables = K * F;
  if (first >= tables) return;  // the whole warp leaves together
  const int s = first + lane / W;
  const bool active = s < tables;
  long long base = 0;
  if (active) {
    const int k = s / F, f = s - k * F;
    base = ((long long)rows[k] * F + f) * C;
  }
  float best = __int_as_float(0xff800000), best_cand = 0.f;  // -inf
  int best_bin = INT_MAX;

  if constexpr (NCH > 0) {
    Chunk b[NCH];
    Stat p[NCH];
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int c = ch * W + sl;
      b[ch] = load(tab_n, tab_mean, tab_m2, tab_sx, base, c, active && c < C);
    }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) p[ch] = prefix_scan<W>(b[ch].s, sl);
    Stat carry = bcast<W>(p[0], W - 1);
#pragma unroll
    for (int ch = 1; ch < NCH; ++ch) {
      p[ch] = chan(carry, p[ch]);
      carry = bcast<W>(p[ch], W - 1);
    }
    const Total tot = total_of(carry);

    // occupied prototypes around each bin: within its chunk from the
    // chunk's occupancy mask, else from the nearest occupied chunk
    Near nb[NCH];
    unsigned om[NCH];
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      om[ch] = occupied<W>(b[ch].occ, lane);
      nb[ch] = near_in_chunk<W>(om[ch], b[ch].proto, sl);
    }
    int c_has = 0;
    float c_val = 0.f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {  // the last before the chunk
      if (!nb[ch].l_has) { nb[ch].l_has = c_has; nb[ch].l_val = c_val; }
      const float last = chunk_last<W>(om[ch], b[ch].proto);
      if (om[ch]) { c_has = 1; c_val = last; }
    }
    c_has = 0;
#pragma unroll
    for (int ch = NCH - 1; ch >= 0; --ch) {  // the first after the chunk
      if (!nb[ch].n_has) { nb[ch].n_has = c_has; nb[ch].n_val = c_val; }
      const float first = chunk_first<W>(om[ch], b[ch].proto);
      if (om[ch]) { c_has = 1; c_val = first; }
    }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int c = ch * W + sl;
      score_bin(p[ch], tot, active && c < C && nb[ch].l_has && nb[ch].n_has,
                nb[ch].l_val, nb[ch].n_val, c, best, best_bin, best_cand);
    }
  } else {
    float* entry = smem + (size_t)(warp * per_warp + lane / W) * nch * 5;
    // pass 1: carry the prefix and the last occupied prototype to each
    // chunk's entry (n, mean, m2, has, value), the prefix on to the total
    Stat carry{0.f, 0.f, 0.f};
    int c_has = 0;
    float c_val = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int c = ch * W + sl;
      const Chunk b = load(tab_n, tab_mean, tab_m2, tab_sx, base, c,
                           active && c < C);
      if (sl == 0) {
        float* e = entry + ch * 5;
        e[0] = carry.n; e[1] = carry.mean; e[2] = carry.m2;
        e[3] = __int_as_float(c_has); e[4] = c_val;
      }
      carry = bcast<W>(chan(carry, prefix_scan<W>(b.s, sl)), W - 1);
      const unsigned om = occupied<W>(b.occ, lane);
      const float last = chunk_last<W>(om, b.proto);
      if (om) { c_has = 1; c_val = last; }
    }
    __syncwarp();
    const Total tot = total_of(carry);
    // pass 2, chunks last to first
    c_has = 0;
    c_val = 0.f;
    for (int ch = nch - 1; ch >= 0; --ch) {
      const int c = ch * W + sl;
      const Chunk b = load(tab_n, tab_mean, tab_m2, tab_sx, base, c,
                           active && c < C);
      const float* e = entry + ch * 5;
      const Stat p = chan(Stat{e[0], e[1], e[2]}, prefix_scan<W>(b.s, sl));
      const unsigned om = occupied<W>(b.occ, lane);
      Near nb = near_in_chunk<W>(om, b.proto, sl);
      if (!nb.l_has) { nb.l_has = __float_as_int(e[3]); nb.l_val = e[4]; }
      if (!nb.n_has) { nb.n_has = c_has; nb.n_val = c_val; }
      const float first = chunk_first<W>(om, b.proto);
      if (om) { c_has = 1; c_val = first; }
      score_bin(p, tot, active && c < C && nb.l_has && nb.n_has, nb.l_val,
                nb.n_val, c, best, best_bin, best_cand);
    }
  }

  // argmax across the segment's lanes, then the winner's lane reports
  const uint64_t key = max_key<W>(pick_key(best, best_bin));
  const int src = key_bin(key) & (W - 1);
  best = __shfl_sync(FULL, best, src, W);
  best_cand = __shfl_sync(FULL, best_cand, src, W);
  if (active && sl == 0) {
    merit[s] = best;
    thr[s] = best == __int_as_float(0xff800000) ? 0.f : best_cand;
  }
}

namespace {

template <int MAX_WARPS>
int launch(const int* r, const float* n, const float* mu, const float* m2,
           const float* sx, float* me, float* th, int K, int F, int C,
           cudaStream_t st) {
  const long long tables = (long long)K * F;
  const int W = C <= 16 ? 16 : 32;
  const int nch = (C + W - 1) / W;
  const int per_warp = 32 / W;
  int warps = MAX_WARPS;
  const size_t entry = nch > 4 ? (size_t)nch * 5 * sizeof(float) : 0;
  while (warps > 1 && (size_t)warps * per_warp * entry > 48 * 1024)
    warps >>= 1;
  const long long per_block = (long long)warps * per_warp;
  const unsigned blocks = (unsigned)((tables + per_block - 1) / per_block);
  const size_t shmem = (size_t)per_block * entry;
  const dim3 grid(blocks), block(warps * 32);
  if (W == 16)
    qo_query_batched_kernel<16, 1, MAX_WARPS><<<grid, block, 0, st>>>(
        r, n, mu, m2, sx, me, th, K, F, C, nch);
  else if (nch == 1)
    qo_query_batched_kernel<32, 1, MAX_WARPS><<<grid, block, 0, st>>>(
        r, n, mu, m2, sx, me, th, K, F, C, nch);
  else if (nch == 2)
    qo_query_batched_kernel<32, 2, MAX_WARPS><<<grid, block, 0, st>>>(
        r, n, mu, m2, sx, me, th, K, F, C, nch);
  else if (nch <= 4)
    qo_query_batched_kernel<32, 4, MAX_WARPS><<<grid, block, 0, st>>>(
        r, n, mu, m2, sx, me, th, K, F, C, nch);
  else
    qo_query_batched_kernel<32, 0, MAX_WARPS><<<grid, block, shmem, st>>>(
        r, n, mu, m2, sx, me, th, K, F, C, nch);
  return (int)cudaGetLastError();
}

}  // namespace

// C up to 65,536 (kernels/qo_query_batched.py::MAX_BINS): a one-warp
// block's chunk entries then stay within 48 KB of shared memory.
// max_warps: 1, 2, 4 or 8 (anything else is refused); the 48 KB cap on a
// block's chunk entries still halves it where C is large.
extern "C" int qo_query_batched_launch(const void* rows, const void* tab_n,
                                       const void* tab_mean,
                                       const void* tab_m2, const void* tab_sx,
                                       void* merit, void* thr, int K, int F,
                                       int C, int max_warps, void* stream) {
  if (max_warps != 1 && max_warps != 2 && max_warps != 4 && max_warps != 8)
    return (int)cudaErrorInvalidValue;
  const long long tables = (long long)K * F;
  if (tables == 0) return 0;
  if (tables > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* r = (const int*)rows;
  const auto *n = (const float*)tab_n, *mu = (const float*)tab_mean,
             *m2 = (const float*)tab_m2, *sx = (const float*)tab_sx;
  auto *me = (float*)merit, *th = (float*)thr;
  switch (max_warps) {
    case 1: return launch<1>(r, n, mu, m2, sx, me, th, K, F, C, st);
    case 2: return launch<2>(r, n, mu, m2, sx, me, th, K, F, C, st);
    case 8: return launch<8>(r, n, mu, m2, sx, me, th, K, F, C, st);
    default: return launch<4>(r, n, mu, m2, sx, me, th, K, F, C, st);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
