// Sketch compaction: sort, rank and reduce each row's centroids in one
// kernel -- J = Ja + Jb centroids (n, mean, M2, sum_x) of two plane sets
// compacted into K rank buckets.
//
// Replaces the TPU kernel
// src/repro/kernels/sketch_compact.py::sketch_compact_pallas together with
// the jnp stages around it (src/repro/core/sketch.py::sort_planes,
// ::_bucket_ids, and the concatenation of merge_planes).  The TPU kernel
// only reduces (a masked lane reduction per bucket); sorting and ranking
// stayed in jnp there.  On the H100 a row of 32 centroids fits in the
// registers of 8 lanes, so the whole stage is one launch and no PyTorch op
// runs around it.  Each
// row reads its centroids straight from the two plane sets: no
// concatenation.
//
// Per row, in this order (the fast kernel, J <= 32 and K <= 32: a row on
// 8 lanes, 4 consecutive centroids a lane, 4 rows a warp):
//
//   key      p = n > 0 ? sum_x / n : +inf, then p + 0.0 (-0.0 -> +0.0),
//            mapped to an ordered uint32 (every NaN above +inf) and packed
//            with the centroid's index j as (ord << 32) | j: distinct keys
//            whose ascending order is exactly torch.sort(p, stable=True)'s
//            permutation (ties by index, empties last, NaN after them);
//   sort     the 32-wide bitonic network on those keys: the 9 steps whose
//            pairs share a lane compare in registers, the other 6 swap
//            across the row's lanes with __shfl_xor_sync.  Only the index
//            travels; the four payload values, staged in shared memory at
//            load, are fetched once in sorted order;
//   rank     cumw by an in-lane scan and a shuffle scan of the lanes'
//            sums; tot = max(cumw[J-1], 1e-30), mid = cumw - 0.5 n,
//            id = clamp(cvt.rzi(mid * (K / tot)), 0, K-1) -- the
//            reference's operation order, IEEE-rounded intrinsics (no
//            contraction), XLA's cast (saturating, NaN -> 0);
//   reduce   the ids are non-decreasing, so each bucket is one run; run
//            sums in the lane in order, then the runs' tails across lanes
//            by a segmented shuffle scan (a ballot of the lanes holding a
//            run start gives each lane its segment), for n, n*mean and
//            sum_x (pass 1); each run's end writes its bucket to shared
//            slots (zero where no centroid landed), the bucket mean among
//            them; pass 2 sums M2 + n (mean - mean_k)^2 the same way;
//   write    the row's K slots, one contiguous segment per plane.
//
// Why 4 centroids a lane: one a lane (a warp a row) spends about 70 warp
// shuffles and 350 instructions a row, 30 shuffles of them in the sort;
// with 4 a lane the in-lane steps need no shuffle and each scan runs over
// 8 lanes.  Where both halves have a multiple of 4 centroids and aligned
// planes, a lane loads its 4 with one 16-byte load per plane.
//
// J > 32 or K > 32 (up to J = 512, K = 256) takes the general kernel: one
// warp a row sorts the same 64-bit keys in shared memory (a bitonic
// network over the next power of two), then walks the sorted order in
// chunks of 32 -- a scan for cumw carried across chunks, then the two
// segmented passes, run sums added to per-bucket accumulators in shared
// memory in chunk order.
//
// Every row is compacted, including rows whose tables saw nothing (a
// compaction is not the identity, ROADMAP C8).  The order of every sum is
// fixed, so a rerun is bitwise equal.  With integer weights below 2^24
// every cumulative weight is exact in any order, so the ids and the
// bucket n equal the plain version's (sort_planes -> bucket_ids ->
// bucket_reduce_plain) bit for bit: both divide K / tot once.
//
// What bounds it on the H100: bytes -- four (R, J) planes read once and
// four (R, K) planes written once (201 MB at R = 261,888, J = 32, K = 16:
// 0.060 ms at 3.35 TB/s); the instructions of the sort and the scans
// come close to that at this R (0.104-0.107 ms a launch on an H100 SXM,
// PERF.md).
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <initializer_list>

#define FULL 0xffffffffu

namespace {

// p + 0.0 as an ordered uint32: +0.0 and -0.0 coincide, every NaN sorts
// above +inf, and unsigned order is float order.
__device__ __forceinline__ uint32_t ordered(float p) {
  p = __fadd_rn(p, 0.0f);
  if (p != p) return 0xffffffffu;
  uint32_t u = __float_as_uint(p);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint64_t sort_key(float n, float sx, int j) {
  const float p = n > 0.f ? __fdiv_rn(sx, n) : __int_as_float(0x7f800000);
  return ((uint64_t)ordered(p) << 32) | (uint32_t)j;
}

// XLA's f32 -> int32 (truncation, saturation, NaN -> 0), clipped to [0, K).
__device__ __forceinline__ int bucket_of(float cumw, float n, float scale,
                                         int K) {
  const float mid = __fsub_rn(cumw, __fmul_rn(0.5f, n));
  const int id = __float2int_rz(__fmul_rn(mid, scale));
  return min(max(id, 0), K - 1);
}

// Inclusive scan of v over the lanes [start, lane] of the lane's run.
__device__ __forceinline__ float seg_scan(float v, int lane, int start) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(FULL, v, d);
    if (lane - d >= start) v = __fadd_rn(v, o);
  }
  return v;
}

__device__ __forceinline__ float scan_add(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = __fadd_rn(v, o);
  }
  return v;
}

// The first and the last lane of each lane's run of equal ids within the
// 32 lanes (a run cut by the chunk's edge ends at lane 31 or starts at
// lane 0: its parts are summed chunk by chunk).
struct Runs {
  int start, end;
  bool is_end;
};

__device__ __forceinline__ Runs runs_of(int id, int lane) {
  const int before = __shfl_up_sync(FULL, id, 1);
  const unsigned starts = __ballot_sync(FULL, lane == 0 || id != before);
  Runs r;
  r.start = 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
  const unsigned above = lane == 31 ? 0u : (starts >> (lane + 1));
  r.end = above ? lane + __ffs(above) - 1 : 31;
  r.is_end = r.end == lane;
  return r;
}

struct Planes {
  const float *n, *mean, *m2, *sx;
};

}  // namespace

// Shared floats a warp of the general kernel uses: Jp 64-bit keys, J
// cumulative weights (then ids), 4 K accumulators; even, so that every
// warp's keys stay 8-byte aligned.
__host__ __device__ inline size_t smem_floats(int Jp, int J, int K) {
  return ((size_t)Jp * 2 + J + (size_t)4 * K + 1) & ~(size_t)1;
}

__device__ __forceinline__ void load_centroid(const Planes& a,
                                              const Planes& b, long long row,
                                              int Ja, int Jb, int j, float& n,
                                              float& mean, float& m2,
                                              float& sx) {
  if (j < Ja) {
    const long long i = row * Ja + j;
    n = a.n[i]; mean = a.mean[i]; m2 = a.m2[i]; sx = a.sx[i];
  } else {
    const long long i = row * Jb + (j - Ja);
    n = b.n[i]; mean = b.mean[i]; m2 = b.m2[i]; sx = b.sx[i];
  }
}

// ---------------------------------------------------------------------------
// J <= 32 and K <= 32: a row on L = 32 / E lanes, E = 4 consecutive
// centroids a lane, E rows a warp.
// ---------------------------------------------------------------------------
constexpr int ROW_E = 4;      // centroids a lane (so 8 lanes a row)
constexpr int ROW_PAY = 128;  // shared floats a row: the 4 x 32 payload

struct RowRuns {
  int start_lane;  // the last lane at or before this one holding a run start
  bool head_cont;  // the lane's first run began on an earlier lane
};

// Inclusive sums of v over the runs of equal ids (non-decreasing along
// the row; E per lane): within the lane in order, then the runs' tails
// across lanes by a segmented shuffle scan, then each lane's head run
// gets its earlier lanes' part.
__device__ __forceinline__ void run_sums(float (&v)[ROW_E],
                                         const int (&id)[ROW_E],
                                         const RowRuns& r, int sl) {
  constexpr int E = ROW_E, L = 32 / E;
#pragma unroll
  for (int s = 1; s < E; ++s)
    if (id[s] == id[s - 1]) v[s] = __fadd_rn(v[s], v[s - 1]);
  float t = v[E - 1];
#pragma unroll
  for (int d = 1; d < L; d <<= 1) {
    const float o = __shfl_up_sync(FULL, t, d, L);
    if (sl - d >= r.start_lane) t = __fadd_rn(t, o);
  }
  const float h = __shfl_up_sync(FULL, t, 1, L);
  if (r.head_cont) {
#pragma unroll
    for (int s = 0; s < E; ++s)
      if (id[s] == id[0]) v[s] = __fadd_rn(v[s], h);
  }
}

// WARPS: warps a block (the launch's schedule: 4, 8 or 16, one
// instantiation each, kernels/sketch_compact.py::WARPS_CHOICES; 8 unless
// the caller picks another).  A row lives in one warp, so every choice
// gives the same bits.
template <int WARPS, bool VEC>
__global__ void __launch_bounds__(WARPS * 32) sketch_compact_rows_kernel(
    Planes a, Planes b, float* __restrict__ out_n,
    float* __restrict__ out_mean, float* __restrict__ out_m2,
    float* __restrict__ out_sx, long long R, int Ja, int Jb, int K) {
  constexpr int E = ROW_E, L = 32 / E;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = lane / L, sl = lane % L;
  const long long first = ((long long)blockIdx.x * WARPS + warp) * E;
  if (first >= R) return;  // the whole warp leaves together
  const long long row = first + seg;
  const bool live = row < R;
  const int J = Ja + Jb;
  float* pay = smem + (size_t)(warp * E + seg) * (ROW_PAY + 4 * K);
  float* slot = pay + ROW_PAY;  // n, mean, m2, sum_x of the K buckets

  // load: centroid e = sl * E + s (a's first, then b's), staged in shared
  // memory for the fetch after the sort; the sort keys in registers
  uint64_t key[E];
  if constexpr (VEC) {
    // Ja, Jb multiples of 4 and every plane 16-byte aligned: a lane's 4
    // centroids are one float4 of one set
    static_assert(E == 4, "16-byte loads take 4 centroids a lane");
    const int e0 = sl * 4;
#pragma unroll
    for (int s = 0; s < 4; ++s) key[s] = ~0ull;
    if (live && e0 < J) {
      const bool in_a = e0 < Ja;
      const Planes& P = in_a ? a : b;
      const long long i = in_a ? row * Ja + e0 : row * Jb + (e0 - Ja);
      const float4 vn = *reinterpret_cast<const float4*>(P.n + i);
      const float4 vsx = *reinterpret_cast<const float4*>(P.sx + i);
      *reinterpret_cast<float4*>(pay + e0) = vn;
      *reinterpret_cast<float4*>(pay + 32 + e0) =
          *reinterpret_cast<const float4*>(P.mean + i);
      *reinterpret_cast<float4*>(pay + 64 + e0) =
          *reinterpret_cast<const float4*>(P.m2 + i);
      *reinterpret_cast<float4*>(pay + 96 + e0) = vsx;
      key[0] = sort_key(vn.x, vsx.x, e0);
      key[1] = sort_key(vn.y, vsx.y, e0 + 1);
      key[2] = sort_key(vn.z, vsx.z, e0 + 2);
      key[3] = sort_key(vn.w, vsx.w, e0 + 3);
    }
  } else {
#pragma unroll
    for (int s = 0; s < E; ++s) {
      const int e = sl * E + s;
      key[s] = ~0ull;
      if (live && e < J) {
        float n, mean, m2, sx;
        load_centroid(a, b, row, Ja, Jb, e, n, mean, m2, sx);
        pay[e] = n; pay[32 + e] = mean; pay[64 + e] = m2; pay[96 + e] = sx;
        key[s] = sort_key(n, sx, e);
      }
    }
  }
  for (int k = sl; k < K; k += L) {
    slot[k] = 0.f; slot[K + k] = 0.f; slot[2 * K + k] = 0.f;
    slot[3 * K + k] = 0.f;
  }

  // sort: the 32-wide bitonic network; pairs within a lane compare in
  // registers, the others across lanes (the row's L lanes)
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < E) {
#pragma unroll
        for (int s = 0; s < E; ++s) {
          if (s & j) continue;
          const bool up = (((sl * E + s) & k) == 0);
          const uint64_t x = key[s], y = key[s | j];
          if ((x > y) == up) { key[s] = y; key[s | j] = x; }
        }
      } else {
#pragma unroll
        for (int s = 0; s < E; ++s) {
          const int e = sl * E + s;
          const uint64_t o = __shfl_xor_sync(FULL, key[s], j / E, L);
          const bool keep_min = ((e & j) == 0) == ((e & k) == 0);
          key[s] = keep_min ? (o < key[s] ? o : key[s])
                            : (o > key[s] ? o : key[s]);
        }
      }
    }
  }
  __syncwarp();

  // fetch the payload in sorted order; rank: cumw by a scan of the lanes'
  // sums, ids in the reference's operation order
  bool valid[E];
  float n[E], mean[E], m2[E], sx[E], cw[E];
#pragma unroll
  for (int s = 0; s < E; ++s) {
    valid[s] = live && sl * E + s < J;
    const int src = valid[s] ? (int)(uint32_t)key[s] : 0;
    n[s] = valid[s] ? pay[src] : 0.f;
    mean[s] = valid[s] ? pay[32 + src] : 0.f;
    m2[s] = valid[s] ? pay[64 + src] : 0.f;
    sx[s] = valid[s] ? pay[96 + src] : 0.f;
    cw[s] = s ? __fadd_rn(cw[s - 1], n[s]) : n[s];
  }
  float incl = cw[E - 1];
#pragma unroll
  for (int d = 1; d < L; d <<= 1) {
    const float o = __shfl_up_sync(FULL, incl, d, L);
    if (sl >= d) incl = __fadd_rn(incl, o);
  }
  const float before = __shfl_up_sync(FULL, incl, 1, L);
  const float tot = fmaxf(__shfl_sync(FULL, incl, L - 1, L), 1e-30f);
  const float scale = __fdiv_rn((float)K, tot);
  int id[E];
#pragma unroll
  for (int s = 0; s < E; ++s) {
    if (sl) cw[s] = __fadd_rn(before, cw[s]);
    id[s] = valid[s] ? bucket_of(cw[s], n[s], scale, K) : INT_MAX;
  }

  // runs of equal ids: lanes holding a run start, and each run's end
  const int prev = __shfl_up_sync(FULL, id[E - 1], 1, L);
  const int next = __shfl_down_sync(FULL, id[0], 1, L);
  bool start_in = sl == 0 || id[0] != prev;
#pragma unroll
  for (int s = 1; s < E; ++s) start_in |= id[s] != id[s - 1];
  const unsigned mask = L == 32 ? 0xffffffffu : ((1u << L) - 1u);
  const unsigned starts =
      (__ballot_sync(FULL, start_in) >> (seg * L)) & mask;
  RowRuns r;
  r.start_lane = 31 - __clz(starts & (0xffffffffu >> (31 - sl)));
  r.head_cont = sl > 0 && id[0] == prev;
  bool end[E];
#pragma unroll
  for (int s = 0; s < E; ++s)
    end[s] = valid[s] &&
             (s < E - 1 ? id[s + 1] != id[s] : (sl == L - 1 || next != id[s]));

  // reduce, pass 1: n, n*mean, sum_x; the bucket means to the slots
  float sn[E], sy[E], ssx[E];
#pragma unroll
  for (int s = 0; s < E; ++s) {
    sn[s] = n[s];
    sy[s] = valid[s] ? __fmul_rn(n[s], mean[s]) : 0.f;
    ssx[s] = sx[s];
  }
  run_sums(sn, id, r, sl);
  run_sums(sy, id, r, sl);
  run_sums(ssx, id, r, sl);
#pragma unroll
  for (int s = 0; s < E; ++s) {
    if (end[s]) {
      slot[id[s]] = sn[s];
      slot[K + id[s]] = sn[s] > 0.f ? __fdiv_rn(sy[s], sn[s]) : 0.f;
      slot[3 * K + id[s]] = ssx[s];
    }
  }
  __syncwarp();
  // pass 2: M2 + n (mean - mean_k)^2
  float q[E];
#pragma unroll
  for (int s = 0; s < E; ++s) {
    q[s] = 0.f;
    if (valid[s]) {
      const float d = __fsub_rn(mean[s], slot[K + id[s]]);
      q[s] = __fadd_rn(m2[s], __fmul_rn(n[s], __fmul_rn(d, d)));
    }
  }
  run_sums(q, id, r, sl);
#pragma unroll
  for (int s = 0; s < E; ++s)
    if (end[s]) slot[2 * K + id[s]] = sn[s] > 0.f ? q[s] : 0.f;
  __syncwarp();

  // write: the row's K buckets, one contiguous segment per plane
  if (live) {
    const long long ob = row * K;
    for (int k = sl; k < K; k += L) {
      out_n[ob + k] = slot[k];
      out_mean[ob + k] = slot[K + k];
      out_m2[ob + k] = slot[2 * K + k];
      out_sx[ob + k] = slot[3 * K + k];
    }
  }
}

// ---------------------------------------------------------------------------
// J > 32: one warp a row, the keys sorted in shared memory.
// ---------------------------------------------------------------------------
// GEN_WARPS: rows (warps) a block (2, 4 or 8,
// kernels/sketch_compact.py::GEN_WARPS_CHOICES; 4 unless the caller picks
// another).
template <int GEN_WARPS>
__global__ void __launch_bounds__(GEN_WARPS * 32) sketch_compact_smem_kernel(
    Planes a, Planes b, float* __restrict__ out_n,
    float* __restrict__ out_mean, float* __restrict__ out_m2,
    float* __restrict__ out_sx, long long R, int Ja, int Jb, int Jp, int K) {
  extern __shared__ uint64_t smem64[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * GEN_WARPS + warp;
  if (row >= R) return;
  const int J = Ja + Jb;
  const size_t per_warp = smem_floats(Jp, J, K);
  float* base = reinterpret_cast<float*>(smem64) + warp * per_warp;
  uint64_t* keys = reinterpret_cast<uint64_t*>(base);     // Jp keys
  float* cum = base + 2 * Jp;                             // J: cumw, then ids
  float* acc_n = cum + J;                                 // K each
  float* acc_sy = acc_n + K;                              // n*mean, then mean
  float* acc_sx = acc_sy + K;
  float* acc_m2 = acc_sx + K;

  for (int j = lane; j < Jp; j += 32) {
    uint64_t key = ~0ull;
    if (j < J) {
      float n, mean, m2, sx;
      load_centroid(a, b, row, Ja, Jb, j, n, mean, m2, sx);
      key = sort_key(n, sx, j);
    }
    keys[j] = key;
  }
  for (int k = lane; k < K; k += 32) {
    acc_n[k] = 0.f; acc_sy[k] = 0.f; acc_sx[k] = 0.f; acc_m2[k] = 0.f;
  }
  __syncwarp();
  for (int k = 2; k <= Jp; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < Jp / 2; i += 32) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const uint64_t x = keys[lo], y = keys[hi];
        if ((x > y) == ((lo & k) == 0)) { keys[lo] = y; keys[hi] = x; }
      }
      __syncwarp();
    }
  }

  // cumw over the sorted order, carried across chunks
  float carry = 0.f;
  for (int c = 0; c < J; c += 32) {
    const int pos = c + lane;
    float n = 0.f, mean, m2, sx;
    if (pos < J)
      load_centroid(a, b, row, Ja, Jb, (int)(uint32_t)keys[pos], n, mean,
                    m2, sx);
    const float cw = __fadd_rn(carry, scan_add(n, lane));
    if (pos < J) cum[pos] = cw;
    carry = __shfl_sync(FULL, cw, 31);
  }
  __syncwarp();
  const float tot = fmaxf(cum[J - 1], 1e-30f);
  const float scale = __fdiv_rn((float)K, tot);

  // pass 1: run sums of n, n*mean, sum_x into the bucket accumulators
  for (int c = 0; c < J; c += 32) {
    const int pos = c + lane;
    const bool valid = pos < J;
    float n = 0.f, mean = 0.f, m2, sx = 0.f;
    int id = INT_MAX;
    if (valid) {
      load_centroid(a, b, row, Ja, Jb, (int)(uint32_t)keys[pos], n, mean,
                    m2, sx);
      id = bucket_of(cum[pos], n, scale, K);
    }
    const Runs run = runs_of(id, lane);
    const float s_n = seg_scan(n, lane, run.start);
    const float s_sy = seg_scan(valid ? __fmul_rn(n, mean) : 0.f, lane,
                                run.start);
    const float s_sx = seg_scan(sx, lane, run.start);
    if (valid) cum[pos] = __int_as_float(id);
    if (valid && run.is_end) {
      acc_n[id] = __fadd_rn(acc_n[id], s_n);
      acc_sy[id] = __fadd_rn(acc_sy[id], s_sy);
      acc_sx[id] = __fadd_rn(acc_sx[id], s_sx);
    }
    __syncwarp();
  }
  for (int k = lane; k < K; k += 32)
    acc_sy[k] = acc_n[k] > 0.f ? __fdiv_rn(acc_sy[k], acc_n[k]) : 0.f;
  __syncwarp();

  // pass 2: run sums of M2 + n (mean - mean_k)^2
  for (int c = 0; c < J; c += 32) {
    const int pos = c + lane;
    const bool valid = pos < J;
    float r = 0.f;
    int id = INT_MAX;
    if (valid) {
      float n, mean, m2, sx;
      load_centroid(a, b, row, Ja, Jb, (int)(uint32_t)keys[pos], n, mean,
                    m2, sx);
      id = __float_as_int(cum[pos]);
      const float d = __fsub_rn(mean, acc_sy[id]);
      r = __fadd_rn(m2, __fmul_rn(n, __fmul_rn(d, d)));
    }
    const Runs run = runs_of(id, lane);
    const float s_m2 = seg_scan(r, lane, run.start);
    if (valid && run.is_end)
      acc_m2[id] = __fadd_rn(acc_m2[id], s_m2);
    __syncwarp();
  }

  const long long ob = row * K;
  for (int k = lane; k < K; k += 32) {
    out_n[ob + k] = acc_n[k];
    out_mean[ob + k] = acc_sy[k];
    out_m2[ob + k] = acc_n[k] > 0.f ? acc_m2[k] : 0.f;
    out_sx[ob + k] = acc_sx[k];
  }
}

namespace {

// Dynamic shared memory past the default 48 KB needs the kernel's opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t shmem) {
  if (shmem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)shmem);
}

template <int WARPS>
int launch_rows(const Planes& a, const Planes& b, float* on, float* om,
                float* oq, float* os, long long R, int Ja, int Jb, int K,
                bool vec, cudaStream_t st) {
  constexpr int rows_a_block = WARPS * ROW_E;
  const unsigned blocks = (unsigned)((R + rows_a_block - 1) / rows_a_block);
  const size_t shmem =
      (size_t)rows_a_block * (ROW_PAY + 4 * K) * sizeof(float);
  auto kernel = vec ? sketch_compact_rows_kernel<WARPS, true>
                    : sketch_compact_rows_kernel<WARPS, false>;
  const cudaError_t e = allow_smem(kernel, shmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, WARPS * 32, shmem, st>>>(a, b, on, om, oq, os, R, Ja, Jb,
                                            K);
  return (int)cudaGetLastError();
}

template <int GEN_WARPS>
int launch_smem(const Planes& a, const Planes& b, float* on, float* om,
                float* oq, float* os, long long R, int Ja, int Jb, int K,
                cudaStream_t st) {
  const int J = Ja + Jb;
  int Jp = 32;
  while (Jp < J) Jp <<= 1;
  const unsigned blocks = (unsigned)((R + GEN_WARPS - 1) / GEN_WARPS);
  const size_t shmem = GEN_WARPS * smem_floats(Jp, J, K) * sizeof(float);
  auto kernel = sketch_compact_smem_kernel<GEN_WARPS>;
  const cudaError_t e = allow_smem(kernel, shmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, GEN_WARPS * 32, shmem, st>>>(a, b, on, om, oq, os, R, Ja,
                                                Jb, Jp, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Compact R rows of Ja + Jb centroids (planes of set a: (R, Ja); of set b:
// (R, Jb), Jb may be 0 and its pointers null) into (R, K) planes.
// 1 <= Ja + Jb <= 512, 1 <= K <= 256 (the wrapper checks).  warps: the
// fast kernel's warps a block, 4, 8 or 16; gen_warps: the general
// kernel's, 2, 4 or 8 (anything else is refused).  At 16 warps and K > 16
// the fast kernel's block takes more than 48 KB of shared memory (64 KB at
// K = 32), as does the general kernel's at 8 warps and large J and K:
// both opt in.
extern "C" int sketch_compact_launch(
    const void* a_n, const void* a_mean, const void* a_m2, const void* a_sx,
    const void* b_n, const void* b_mean, const void* b_m2, const void* b_sx,
    void* out_n, void* out_mean, void* out_m2, void* out_sx, long long R,
    int Ja, int Jb, int K, int warps, int gen_warps, void* stream) {
  if ((warps != 4 && warps != 8 && warps != 16) ||
      (gen_warps != 2 && gen_warps != 4 && gen_warps != 8))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const Planes a{(const float*)a_n, (const float*)a_mean, (const float*)a_m2,
                 (const float*)a_sx};
  const Planes b{(const float*)b_n, (const float*)b_mean, (const float*)b_m2,
                 (const float*)b_sx};
  auto *on = (float*)out_n, *om = (float*)out_mean, *oq = (float*)out_m2,
       *os = (float*)out_sx;
  const cudaStream_t st = (cudaStream_t)stream;
  if (Ja + Jb <= 32 && K <= 32) {
    const auto aligned = [](const void* p) {
      return ((uintptr_t)p & 15u) == 0;
    };
    bool vec = Ja % 4 == 0 && Jb % 4 == 0;
    for (const void* p : {a_n, a_mean, a_m2, a_sx, b_n, b_mean, b_m2, b_sx})
      vec = vec && aligned(p);  // an absent b (null) counts as aligned
    switch (warps) {
      case 4: return launch_rows<4>(a, b, on, om, oq, os, R, Ja, Jb, K, vec,
                                    st);
      case 16: return launch_rows<16>(a, b, on, om, oq, os, R, Ja, Jb, K,
                                      vec, st);
      default: return launch_rows<8>(a, b, on, om, oq, os, R, Ja, Jb, K, vec,
                                     st);
    }
  }
  switch (gen_warps) {
    case 2: return launch_smem<2>(a, b, on, om, oq, os, R, Ja, Jb, K, st);
    case 8: return launch_smem<8>(a, b, on, om, oq, os, R, Ja, Jb, K, st);
    default: return launch_smem<4>(a, b, on, om, oq, os, R, Ja, Jb, K, st);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
