// QO absorb: fold a routed batch into every (leaf, feature) table, in place.
//
// Replaces the TPU kernel
// src/repro/kernels/qo_update_leaves.py::qo_update_leaves_pallas.  The TPU
// kernel walks a sequential grid of (feature, leaf tile, 256-row batch
// tile), contracts one-hot (row, leaf) and (row, bin) matrices on the MXU
// and Chan-merges each tile into tables kept in VMEM.
//
// What bounds it on the H100: bytes.  Only the tables of leaves that hold
// rows are read and written (16 B a bin and plane pair, ~42 MB at T=16,
// M=1023, F=16, C=64 with ~1,250 touched leaves), plus the batch; a row
// costs a handful of flops a feature.  So the design spends no block on a
// leaf without rows, reads each row once, and touches each table once.
// What keeps it above that bound is each piece's chain of memory
// latencies (ticket, rows, x, tables) and the one-block plan.
//
//   The batch arrives sorted by folded leaf id (order, offsets: the sort the
//   step's segment statistics already did).  Each leaf's run is cut into
//   pieces of at most PIECE_ROWS rows.
//
//   qo_update_leaves_plan_kernel: one block scans the per-leaf piece counts
//     into a piece list (piece -> leaf, rows, scratch slot), with the
//     pieces of long leaves first so that the longest work starts first:
//     no host read.
//   qo_update_leaves_pieces_kernel: as many blocks as the card holds at
//     once, each claiming the next piece from a ticket counter until the
//     plan's count is reached.  (A grid sized from the host's bound,
//     ceil(T*B/R) + min(T*M, T*B) pieces, spends its tail on blocks that
//     only read the count and exit.)  The tickets only hand out work; no
//     statistic goes through an atomic.  A
//     block takes all F features of its piece (or a feature group when F*C
//     outgrows shared memory).  The piece's rows are staged once: y, w and
//     the F x values of a row as one 16-byte-vector row read, its F bin
//     ids computed once.  Warp w owns features w, w+8, ..: for 32 rows at
//     a time __match_any_sync groups the lanes of one bin, and the lowest
//     lane sums its group in lane order into the warp's own (n, sum wy,
//     sum wx) cells, so every sum runs in a fixed order.  Then the
//     two-pass M2 against the piece's bin means, from the staged rows and
//     the same groups.  A leaf of one piece (the common case) Chan-merges
//     (Eqs. 4-5) into its tables in place, with 16-byte accesses over its
//     F*C contiguous floats of each plane.  A piece of a longer leaf writes
//     (n, mean, M2, sum wx) to scratch and counts itself in (an integer
//     atomic); the block that completes the leaf merges its pieces in piece
//     order, then into the tables -- as the TPU kernel does with its tiles:
//     a two-pass M2 per tile of rows, the tiles merged in order.
//
// PIECE_ROWS = 128.  Past the first batches most touched leaves hold far
// fewer rows than a piece, so a piece is bound by its latencies, not by
// its rows, and what counts is how many pieces an SM holds at once:
// 128-row staging keeps a block at 34 KB of shared memory and 256
// threads, four blocks an SM.  A leaf holding a whole tree's batch (every
// root on a forest's first batch: 4,096 rows) spreads over 32 blocks
// instead of serializing one.  A leaf without rows is never visited: its
// tables stay untouched (ROADMAP C5).  The result is bitwise the same from
// run to run.
//
// Bin ids follow the reference bit for bit (ROADMAP C1): floor((x-o)/r)
// with IEEE division, a saturating float->int32 cast that sends NaN to 0
// (__float2int_rd), the +C/2 done in unsigned arithmetic so it wraps like
// XLA's int32 add, then the clip into [0, C).
#include <cuda_runtime.h>

namespace {

constexpr int PIECE_ROWS = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PLAN_THREADS = 1024;
constexpr int PLAN_PER_THREAD = 16;      // leaves a plan thread takes a tile
constexpr int PLAN_TILE = PLAN_THREADS * PLAN_PER_THREAD;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int bin_id(float x, float o, float r, int C) {
  int h = __float2int_rd((x - o) / r);
  h = (int)((unsigned)h + (unsigned)(C / 2));
  return h < 0 ? 0 : (h > C - 1 ? C - 1 : h);
}

// Chan merge (Eqs. 4-5) of (nb, mb, m2b) into (n0, m0, m20), empty-safe.
// One IEEE reciprocal serves both quotients (the division is the costly
// part of a merge; the result moves by at most an ulp, ROADMAP C11).
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

// Position of tile entry i in the plan's padded shared-memory array.
__device__ __forceinline__ int pad(int i) { return i + i / PLAN_PER_THREAD; }

// Exclusive prefix of v over the block; *total receives the block's sum.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    int u = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += u;
  }
  __syncthreads();              // s_warp may still be read from a last call
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int t = lane < n_warps ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      int u = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t += u;
    }
    s_warp[lane] = t;
  }
  __syncthreads();
  *total = s_warp[n_warps - 1];
  return (warp > 0 ? s_warp[warp - 1] : 0) + inc - v;
}

}  // namespace

// Pieces: int4 (leaf, first sorted row, rows + 256 * index in the leaf,
// scratch slot or -1).  The pieces of leaves of several pieces come first,
// each at the index of its scratch slot; the leaves of one piece fill the
// list from its end backwards: the longest pieces start first.  done[first
// slot of a leaf of several pieces] is zeroed for the pieces launch.
// counts: [0] pieces of leaves of several pieces, [1] leaves of one piece,
// [2] the pieces launch's ticket.  Offsets are staged a tile at a time with
// coalesced 16-byte loads, each thread takes PLAN_PER_THREAD consecutive
// leaves of the tile, and the running totals carry over tiles.
__global__ void __launch_bounds__(PLAN_THREADS)
qo_update_leaves_plan_kernel(const int* __restrict__ offsets, int n_leaves,
                             int max_pieces, int vec,
                             int4* __restrict__ pieces,
                             int* __restrict__ done,
                             int* __restrict__ counts) {
  // the tile's offsets, one pad word after every PLAN_PER_THREAD, so
  // that thread t's run starts in bank 17t mod 32: no bank conflicts
  extern __shared__ int s_off[];
  __shared__ int s_warp[32];
  int carry_s = 0, carry_1 = 0;
  for (int t0 = 0; t0 < n_leaves; t0 += PLAN_TILE) {
    const int nt = min(PLAN_TILE, n_leaves - t0);
    __syncthreads();                      // the last tile is consumed
#pragma unroll 4
    for (int i = 4 * threadIdx.x; i <= nt; i += 4 * PLAN_THREADS) {
      int v[4];
      if (vec && i + 3 <= nt) {
        const int4 q = *reinterpret_cast<const int4*>(offsets + t0 + i);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
        for (int k = 0; k < 4; ++k)
          v[k] = i + k <= nt ? offsets[t0 + i + k] : 0;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k <= nt) s_off[pad(i + k)] = v[k];
    }
    __syncthreads();
    const int l0 = (int)threadIdx.x * PLAN_PER_THREAD;
    int start[PLAN_PER_THREAD + 1];
#pragma unroll
    for (int i = 0; i <= PLAN_PER_THREAD; ++i)
      start[i] = l0 + i <= nt ? s_off[pad(l0 + i)] : 0;
    int ns = 0, n1 = 0;
#pragma unroll
    for (int i = 0; i < PLAN_PER_THREAD; ++i) {
      if (l0 + i >= nt) break;
      const int p = (start[i + 1] - start[i] + PIECE_ROWS - 1) / PIECE_ROWS;
      if (p == 1) n1 += 1;
      if (p > 1) ns += p;
    }
    int ts, t1;
    int bs = carry_s + block_exclusive_scan(ns, s_warp, &ts);
    int b1 = carry_1 + block_exclusive_scan(n1, s_warp, &t1);
#pragma unroll
    for (int i = 0; i < PLAN_PER_THREAD; ++i) {
      if (l0 + i >= nt) break;
      const int leaf = t0 + l0 + i, a = start[i], end = start[i + 1];
      const int p = (end - a + PIECE_ROWS - 1) / PIECE_ROWS;
      if (p == 1) {
        pieces[max_pieces - 1 - b1++] = make_int4(leaf, a, end - a, -1);
      } else if (p > 1) {
        for (int k = 0; k < p; ++k) {
          const int r0 = a + k * PIECE_ROWS;
          pieces[bs + k] = make_int4(
              leaf, r0, min(PIECE_ROWS, end - r0) + 256 * k, bs + k);
        }
        done[bs] = 0;
        bs += p;
      }
    }
    carry_s += ts;
    carry_1 += t1;
  }
  if (threadIdx.x == 0) {
    counts[0] = carry_s;
    counts[1] = carry_1;
    counts[2] = 0;
  }
}

// The (piece, feature group) that ticket q names, or leaf -1 past the end.
__device__ __forceinline__ int4 piece_of(const int4* __restrict__ pieces,
                                         const int* __restrict__ counts,
                                         int q, int groups, int max_pieces) {
  const int k = q / groups, n_long = counts[0];
  if (k >= n_long + counts[1]) return make_int4(-1, 0, 0, 0);
  return pieces[k < n_long ? k : max_pieces - 1 - (k - n_long)];
}

__global__ void __launch_bounds__(THREADS, 4) qo_update_leaves_pieces_kernel(
    const int* __restrict__ order, const int* __restrict__ offsets,
    const int4* __restrict__ pieces, const int* __restrict__ counts,
    int* __restrict__ ticket, int* __restrict__ done,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ radius,
    const float* __restrict__ origin, float* __restrict__ tab_n,
    float* __restrict__ tab_mean, float* __restrict__ tab_m2,
    float* __restrict__ tab_sx, float* __restrict__ scratch, int max_pieces,
    int B, int F, int C, int Fg, int vec_x, int vec_tab) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int FgC = Fg * C;
  // the piece's statistics, Fg*C each: n, sum wy -> mean, sum wx, M2
  float* s_n = smem;
  float* s_sy = s_n + FgC;
  float* s_sx = s_sy + FgC;
  float* s_m2 = s_sx + FgC;
  // feature-major (Fg x PIECE_ROWS): a round of 32 rows reads 32 banks.
  // s_x holds x in the first pass and the leaders' peer masks after it.
  float* s_x = s_m2 + FgC;
  int* s_bin = reinterpret_cast<int*>(s_x + PIECE_ROWS * Fg);
  float* s_y = reinterpret_cast<float*>(s_bin + PIECE_ROWS * Fg);
  float* s_w = s_y + PIECE_ROWS;
  int* s_b = reinterpret_cast<int*>(s_w + PIECE_ROWS);
  float* s_r = reinterpret_cast<float*>(s_b + PIECE_ROWS);
  float* s_o = s_r + Fg;
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_x);
  __shared__ int s_q, s_last;
  __shared__ int4 s_piece;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int groups = (F + Fg - 1) / Fg;
  const long long FC = (long long)F * C;
  for (;;) {
    if (t == 0) {                             // the next (piece, group)
      s_q = atomicAdd(ticket, 1);
      s_piece = piece_of(pieces, counts, s_q, groups, max_pieces);
    }
    __syncthreads();
    const int4 piece = s_piece;
    if (piece.x < 0) return;                  // the batch's pieces are done
    const int leaf = piece.x, start = piece.y, rows = piece.z & 255;
    const int k = piece.z >> 8, slot = piece.w;   // slot -1: one piece
    const int f0 = (s_q % groups) * Fg;
    const int nf = min(Fg, F - f0);
    const int cells = nf * C;                 // contiguous in the tables
    const long long base = ((long long)leaf * F + f0) * C;

    if (t < rows) {
      const int row = order[start + t];       // folded row t*B + b
      const int b = row % B;
      s_b[t] = b;
      s_w[t] = w[row];
      s_y[t] = y[b];
    }
    if (t < nf) {
      const long long i = (long long)leaf * F + f0 + t;
      s_r[t] = radius[i];
      s_o[t] = origin[i];
    }
    for (int i = t; i < 4 * FgC; i += THREADS) smem[i] = 0.f;
    __syncthreads();
    // x rows: nf contiguous floats at x[b*F + f0], bin ids computed once
    if (vec_x) {
      const int q = nf >> 2;
      for (int i = t; i < rows * q; i += THREADS) {
        const int j = i / q, u = (i - j * q) << 2;
        const float4 v = *reinterpret_cast<const float4*>(
            x + (long long)s_b[j] * F + f0 + u);
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s_x[(u + e) * PIECE_ROWS + j] = vs[e];
          s_bin[(u + e) * PIECE_ROWS + j] =
              bin_id(vs[e], s_o[u + e], s_r[u + e], C);
        }
      }
    } else {
      for (int i = t; i < rows * nf; i += THREADS) {
        const int j = i / nf, f = i - j * nf;
        const float v = x[(long long)s_b[j] * F + f0 + f];
        s_x[f * PIECE_ROWS + j] = v;
        s_bin[f * PIECE_ROWS + j] = bin_id(v, s_o[f], s_r[f], C);
      }
    }
    __syncthreads();

    // warp-owned features: each (feature, bin) cell has one writer
    for (int f = warp; f < nf; f += WARPS) {
      float* cn = s_n + f * C;
      float* cy = s_sy + f * C;
      float* cx = s_sx + f * C;
      float* cm = s_m2 + f * C;
      const int* fb = s_bin + f * PIECE_ROWS;
      const float* fx = s_x + f * PIECE_ROWS;
      unsigned* fm = s_mask + f * PIECE_ROWS;
      for (int r0 = 0; r0 < rows; r0 += 32) {
        const int j = r0 + lane;
        const bool act = j < rows;
        const unsigned live = __ballot_sync(FULL, act);
        unsigned lead = 0u;
        if (act) {
          const int bin = fb[j];
          const unsigned peers = __match_any_sync(live, bin);
          if ((peers & ((1u << lane) - 1u)) == 0u) {   // lowest lane leads
            lead = peers;
            float n = 0.f, sy = 0.f, sx = 0.f;
            for (unsigned m = peers; m; m &= m - 1u) {
              const int r = r0 + __ffs(m) - 1;
              const float wv = s_w[r];
              n += wv;
              sy += wv * s_y[r];
              sx += wv * fx[r];
            }
            cn[bin] += n;
            cy[bin] += sy;
            cx[bin] += sx;
          }
        }
        __syncwarp();                 // this round's x reads are done
        if (act) fm[j] = lead;        // the second pass reuses the groups
      }
      __syncwarp();
      for (int c = lane; c < C; c += 32) {
        const float n = cn[c];
        cy[c] = n > 0.f ? cy[c] / n : 0.f;      // the piece's bin mean
      }
      __syncwarp();
      for (int r0 = 0; r0 < rows; r0 += 32) {
        const int j = r0 + lane;
        const unsigned peers = j < rows ? fm[j] : 0u;
        if (peers) {
          const float mean = cy[fb[j]];
          float m2 = 0.f;
          for (unsigned m = peers; m; m &= m - 1u) {
            const int r = r0 + __ffs(m) - 1;
            const float d = s_y[r] - mean;
            m2 += s_w[r] * (d * d);
          }
          cm[fb[j]] += m2;
        }
        __syncwarp();
      }
    }
    __syncthreads();

    if (slot < 0 && vec_tab) {
      // one piece: Chan-merge straight into the tables, in place
      for (int i = 4 * t; i < cells; i += 4 * THREADS) {
        float4 n0 = *reinterpret_cast<const float4*>(tab_n + base + i);
        float4 m0 = *reinterpret_cast<const float4*>(tab_mean + base + i);
        float4 q0 = *reinterpret_cast<const float4*>(tab_m2 + base + i);
        float4 x0 = *reinterpret_cast<const float4*>(tab_sx + base + i);
        chan(n0.x, m0.x, q0.x, s_n[i], s_sy[i], s_m2[i]);
        chan(n0.y, m0.y, q0.y, s_n[i + 1], s_sy[i + 1], s_m2[i + 1]);
        chan(n0.z, m0.z, q0.z, s_n[i + 2], s_sy[i + 2], s_m2[i + 2]);
        chan(n0.w, m0.w, q0.w, s_n[i + 3], s_sy[i + 3], s_m2[i + 3]);
        x0.x += s_sx[i];
        x0.y += s_sx[i + 1];
        x0.z += s_sx[i + 2];
        x0.w += s_sx[i + 3];
        *reinterpret_cast<float4*>(tab_n + base + i) = n0;
        *reinterpret_cast<float4*>(tab_mean + base + i) = m0;
        *reinterpret_cast<float4*>(tab_m2 + base + i) = q0;
        *reinterpret_cast<float4*>(tab_sx + base + i) = x0;
      }
    } else if (slot < 0) {
      for (int i = t; i < cells; i += THREADS) {
        float n0 = tab_n[base + i], m0 = tab_mean[base + i];
        float q0 = tab_m2[base + i];
        chan(n0, m0, q0, s_n[i], s_sy[i], s_m2[i]);
        tab_n[base + i] = n0;
        tab_mean[base + i] = m0;
        tab_m2[base + i] = q0;
        tab_sx[base + i] += s_sx[i];
      }
    } else {
      // a piece of a longer leaf: its partial to scratch; the block that
      // completes the leaf's last (piece, group) merges them all in piece
      // order, then into the tables
      float* out = scratch + (long long)slot * 4 * FC + (long long)f0 * C;
      for (int i = t; i < cells; i += THREADS) {
        out[i] = s_n[i];
        out[FC + i] = s_sy[i];
        out[2 * FC + i] = s_m2[i];
        out[3 * FC + i] = s_sx[i];
      }
      const int first = slot - k;
      const int np = (offsets[leaf + 1] - offsets[leaf] + PIECE_ROWS - 1)
                     / PIECE_ROWS;
      __threadfence();                        // the partial is visible
      __syncthreads();
      if (t == 0)
        s_last = atomicAdd(done + first, 1) == np * groups - 1;
      __syncthreads();
      if (s_last) {
        __threadfence();
        const float* part = scratch + (long long)first * 4 * FC;
        const long long lb = (long long)leaf * FC;
        for (long long i = t; i < FC; i += THREADS) {
          const float* u = part + i;
          float n = __ldcg(u), mean = __ldcg(u + FC);
          float m2 = __ldcg(u + 2 * FC), sx = __ldcg(u + 3 * FC);
          for (int g = 1; g < np; ++g) {
            u += 4 * FC;
            chan(n, mean, m2, __ldcg(u), __ldcg(u + FC), __ldcg(u + 2 * FC));
            sx += __ldcg(u + 3 * FC);
          }
          float n0 = tab_n[lb + i], m0 = tab_mean[lb + i];
          float q0 = tab_m2[lb + i];
          chan(n0, m0, q0, n, mean, m2);
          tab_n[lb + i] = n0;
          tab_mean[lb + i] = m0;
          tab_m2[lb + i] = q0;
          tab_sx[lb + i] += sx;
        }
      }
    }
    __syncthreads();                          // s_q, s_piece, staging free
  }
}

namespace {

// Shared memory of a pieces block for a group of Fg features.
size_t pieces_smem(int Fg, int C) {
  return (size_t)(4 * Fg * C + 2 * PIECE_ROWS * Fg + 3 * PIECE_ROWS + 2 * Fg)
         * sizeof(float);
}

bool aligned16(const void* p) { return ((size_t)p & 15u) == 0; }

}  // namespace

extern "C" int qo_update_leaves_piece_rows() { return PIECE_ROWS; }

// Features a block can take at once (0 when even one does not fit).
extern "C" int qo_update_leaves_feature_group(int F, int C) {
  const size_t limit = 227 * 1024;
  int fg = F;
  while (fg > 0 && pieces_smem(fg, C) > limit) --fg;
  return fg;
}

// plan: int32 scratch of 4*max_pieces (the piece list) + max_slots (the
// leaves' arrival counts) + 3 (counts and the ticket), with the bounds
// computed below; scratch: 4*F*C floats a slot, max_slots slots.
extern "C" int qo_update_leaves_launch(
    const void* order, const void* offsets, const void* x, const void* y,
    const void* w, const void* radius, const void* origin, void* tab_n,
    void* tab_mean, void* tab_m2, void* tab_sx, void* plan, void* scratch,
    int n_leaves, int n_rows, int B, int F, int C, int Fg, void* stream) {
  if (n_rows == 0 || F == 0 || n_leaves == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int max_pieces = (n_rows + PIECE_ROWS - 1) / PIECE_ROWS
                         + (n_leaves < n_rows ? n_leaves : n_rows);
  // a leaf of p > 1 pieces holds more than (p - 1) * R rows: p < 2c/R
  const int max_slots = n_rows > PIECE_ROWS
                        ? 2 * ((n_rows + PIECE_ROWS - 1) / PIECE_ROWS) : 0;
  int4* pieces = (int4*)plan;
  int* done = (int*)(pieces + max_pieces);
  int* counts = done + max_slots;

  const size_t shmem = pieces_smem(Fg, C);
  const size_t plan_shmem =
      (PLAN_TILE + PLAN_TILE / PLAN_PER_THREAD + 2) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      qo_update_leaves_plan_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan_shmem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(qo_update_leaves_pieces_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)shmem);
  if (e != cudaSuccess) return (int)e;
  // resident blocks at this shared-memory size (cached: the occupancy
  // query costs a runtime call); they claim (piece, feature group) tickets
  static size_t cached_shmem = 0;
  static int resident = 0;
  if (shmem != cached_shmem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, qo_update_leaves_pieces_kernel, THREADS, shmem);
    if (e != cudaSuccess) return (int)e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    cached_shmem = shmem;
  }

  qo_update_leaves_plan_kernel<<<1, PLAN_THREADS, plan_shmem, s>>>(
      (const int*)offsets, n_leaves, max_pieces, aligned16(offsets), pieces,
      done, counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long tickets = (long long)max_pieces * ((F + Fg - 1) / Fg);
  const int blocks = tickets < resident ? (int)tickets : resident;
  const int vec_x = (F % 4 == 0) && (Fg % 4 == 0) && aligned16(x);
  const int vec_tab = (C % 4 == 0) && aligned16(tab_n) &&
                      aligned16(tab_mean) && aligned16(tab_m2) &&
                      aligned16(tab_sx);
  qo_update_leaves_pieces_kernel<<<blocks, THREADS, shmem, s>>>(
      (const int*)order, (const int*)offsets, pieces, counts, counts + 2,
      done, (const float*)x, (const float*)y, (const float*)w,
      (const float*)radius, (const float*)origin, (float*)tab_n,
      (float*)tab_mean, (float*)tab_m2, (float*)tab_sx, (float*)scratch,
      max_pieces, B, F, C, Fg, vec_x, vec_tab);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
