// E-BST and TE-BST attribute observers: the insert and the split query.
//
// No TPU kernel exists for these.  The reference (src/repro/core/ebst.py)
// lowers the insert to a lax.scan over rows of a lax.while_loop down the
// tree (_insert_one, ebst.py:60) and the query to a lax.while_loop over an
// explicit stack (best_split, ebst.py:135): one device program each.
//
// State, structure-of-arrays as the reference keeps it, all on the card
// (the wrapper never reads it to the host):
//   key (cap,) f32, left/right (cap,) i32 (-1 = nil), le as three (cap,)
//   f32 planes (n, mean, m2: the targets of every row with x <= key that
//   passed the node), size () i32, total as three f32 scalars, decimals
//   () i32 (>= 0: TE-BST, x rounded to that many decimals first).
//
// The insert runs _insert_one for every row, in order:
//   total observes y first; x <= key goes left and observes the node's le;
//   x == key stops after that update (a duplicate adds no node; -0.0 ==
//   0.0); a nil child becomes a node whose le is observe(empty, y); at
//   capacity a row only updates the statistics along its path; a NaN x
//   goes right at every node and becomes a node of its own.
//   TE-BST: rintf(x * scale) * inv, rintf rounding half to even as
//   jnp.round does, scale = 10^decimals by repeated f32 multiplication
//   (exact up to 10^10) and inv = 1 / scale rounded once.  The reference
//   writes round(x * scale) / scale, but XLA rewrites a division by
//   pow(10, d) into a product with pow(10, -d) (the correctly rounded
//   10^-d for d <= 11), and the port keeps the reference's keys.
// The query runs best_split: at node v with left context S (the left
//   statistics of v's nearest ancestor whose right subtree holds v; empty
//   if none), left = merge(S, le[v]), right = subtract(total, left), the
//   VR scored where both sides hold weight; the first strictly greater
//   score in in-order wins, a NaN score never wins.
//
// Every float operation is an explicitly rounded intrinsic in the order of
// repro_torch/core/stats.py (csrc/ebst_stats.cuh), so the results are
// bitwise equal to the plain PyTorch versions.
//
// ---- the insert (ebst_insert_kernel): one block, three roles -----------
// A row's path depends on the rows before it only through key, left, right
// and size; the walk never reads le or total.  So the walk is split from
// the statistics:
//   * warp 0 walks.  The lowest SHARED_NODES nodes (the top of the tree,
//     which every row passes) sit in shared memory as 16-byte records
//     {key, the children's record addresses}: a nil child points at a
//     sentinel record, a child below the cached top at a second one.  A
//     level there is a shared-memory load, a compare and a select; the
//     next record is loaded before the one branch that decides whether the
//     walk goes on.  Below the top, a level is three L2 loads issued
//     together (key, left, right).  For every node passed on the left, and for
//     every new node, the walker appends an event (node, y) to one of two
//     shared-memory buffers of RING events, and hands a full buffer over at
//     a named barrier.  All 32 lanes walk the same path (loads broadcast),
//     so the warp never diverges at the barrier and each lane reads its
//     own writes of the structure.
//   * CONSUMERS warps apply the events: node v belongs to warp
//     v % CONSUMERS, which applies a chunk of 32 events in rounds (the
//     k-th event of each node in round k, __match_any_sync), so each
//     node's observes run in row order.
//   * warp 1 folds total over every y in order, on its own: it shares no
//     data with the other two roles.
// What bounds it on the H100: latency.  The walk is one dependent step a
// level (the shared-memory chase for the cached top, the L2 probe below);
// the longest fold is total's N dependent observes.  chip_smoke.py
// measures both with tools_torch/chase.cu and reports the larger.
//
// ---- the query: one call, up to six launches -----------------------------
//   1. ebst_pack_kernel, a grid: each node's key, children and le packed
//      into one 32-byte record (one sector a node for the walks below).
//   2. A level-synchronous walk of the tree by depth.  A level's entries
//      (node, S, lo) sit in a queue in global scratch; each thread merges
//      its node's le into S, writes left(v) over its entry, and appends
//      (left child, S) and (right child, left(v)) to the next level (one
//      atomic a block on the tail).  The level order is a topological
//      order of the context forest (S of v is left(c(v)), c(v) an
//      ancestor).  By width:
//      * ebst_levels_kernel, one block, while a level holds at most WIDEST
//        entries (a barrier costs ~0.1 us there).  A level of one entry is
//        walked by one thread in registers down its run of single children,
//        the run's nodes taking the next slots, so a chain (a sorted
//        stream) costs one pass, not one barrier a node.  A tree of at
//        most WIDEST nodes ends here.
//      * ebst_wide_levels_kernel, a cooperative grid of one block an SM,
//        while a level holds more than one block's worth of entries: one
//        block's L2 sectors would pace those; a grid barrier (~3 us) parts
//        the levels.
//      * ebst_levels_kernel again, one block, for the narrow rest.
//      Each phase leaves the level it stopped at in the control block.
//   3. ebst_score_kernel, a grid over the queue: right = subtract(total,
//      left), the variances and the VR of every node, then the best
//      (score, in-order key) of each block.
//   4. ebst_pick_kernel, one block: the best of the blocks -> out.
// What bounds it on the H100: the levels' chain of merges (the context
// forest's depth x one merge's latency) against the bytes of one pass over
// the nodes.  What holds it: a barrier a level (a tree deep and narrow
// everywhere, as a sorted prefix under random rows, pays one a level) and
// the launches of a call.
// The in-order tie key: non-NaN keys are in in-order ascending (duplicates
// add no node, and -0.0 == 0.0).  A NaN key goes right at every node, so
// NaN nodes lie on the root's right spine, with no left child; one comes
// after every node outside its subtree and before the rest of it.  The
// nodes outside are exactly those whose key is <= lo, the largest
// non-NaN key among its ancestors (carried down the walk; none below
// every key).  So the order is (code(key), 0, v) for a non-NaN key and
// (code(lo), 1, v) for a NaN one, v breaking ties between NaN nodes (a
// deeper one was made later).  kernels/ebst.py::query_model is the plain
// PyTorch model of this algorithm.
//
// Single-thread versions of both walks, ebst_insert_serial_kernel and
// ebst_query_serial_kernel, stay as a card-side bitwise oracle for sizes
// where the plain versions take minutes.  The wrappers on core/ebst.py's path
// never call them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ebst_stats.cuh"

namespace {

using ebst::Stats;
using ebst::merge;
using ebst::observe;
using ebst::subtract;
using ebst::variance;

// ---- insert --------------------------------------------------------------

constexpr int SHARED_NODES = 13312;   // 208 KB of 16-byte records
constexpr int RING = 1024;            // events a buffer, two buffers
constexpr int CONSUMERS = 8;          // warps applying the events
constexpr int INSERT_THREADS = 32 * (2 + CONSUMERS);
constexpr int HANDOVER_THREADS = 32 * (1 + CONSUMERS);   // walker + consumers
constexpr int CREATE = -2147483647 - 1;   // event flag (bit 31): a new node

struct __align__(16) Node {
  float key;
  int left, right, pad;   // in shared memory: the children's addresses
};

struct __align__(8) Event {
  int node;   // | CREATE for a new node (its le starts empty)
  float y;
};

__device__ __forceinline__ void handover_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(HANDOVER_THREADS) : "memory");
}

// The walker's loads of the next record, issued before the branch that
// decides whether the walk goes on (volatile: not sunk past it).
__device__ __forceinline__ Node shared_node(unsigned a) {
  Node r;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=f"(r.key), "=r"(r.left), "=r"(r.right), "=r"(r.pad)
               : "r"(a)
               : "memory");
  return r;
}

__device__ __forceinline__ Node global_node(const float* key, const int* left,
                                            const int* right, unsigned i) {
  Node r;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(r.key) : "l"(key + i)
               : "memory");
  asm volatile("ld.global.b32 %0, [%1];" : "=r"(r.left) : "l"(left + i)
               : "memory");
  asm volatile("ld.global.b32 %0, [%1];" : "=r"(r.right) : "l"(right + i)
               : "memory");
  r.pad = 0;
  return r;
}

__global__ void __launch_bounds__(INSERT_THREADS, 1) ebst_insert_kernel(
    float* key, int* left, int* right, float* le_n, float* le_mean,
    float* le_m2, int* size_p, float* total,
    const int* __restrict__ decimals_p, const float* __restrict__ xs,
    const float* __restrict__ ys, long long N, int cap, int cached) {
  extern __shared__ __align__(16) unsigned char smem[];
  Node* nodes = reinterpret_cast<Node*>(smem);
  Event* ring =
      reinterpret_cast<Event*>(smem + (cached + 2) * sizeof(Node));
  int* ctl = reinterpret_cast<int*>(ring + 2 * RING);  // count[2], last[2]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a shared record links its children by their records' addresses: a
  // nil child to the record at `cached`, one below the cached top to the
  // record after it, so the next record can be loaded before the walk
  // knows whether it goes on
  const unsigned top = (unsigned)__cvta_generic_to_shared(nodes);
  const unsigned nil_at = top + cached * (unsigned)sizeof(Node);
  const unsigned below_at = nil_at + (unsigned)sizeof(Node);
  auto at = [&](int child) -> int {
    return (int)(child < 0 ? nil_at
                           : child < cached ? top + child * (unsigned)sizeof(Node)
                                            : below_at);
  };
  for (int i = threadIdx.x; i < cached + 2; i += blockDim.x)
    nodes[i] = i < cached ? Node{key[i], at(left[i]), at(right[i]), 0}
                          : Node{0.f, 0, 0, 0};
  __syncthreads();

  if (warp == 1) {   // total: N dependent observes, 32 ys loaded at a time
    Stats tot = {total[0], total[1], total[2]};
    float next = lane < N ? ys[lane] : 0.f;
    for (long long base = 0; base < N; base += 32) {
      const float cur = next;
      const long long ahead = base + 32 + lane;
      next = ahead < N ? ys[ahead] : 0.f;
      const int m = N - base < 32 ? (int)(N - base) : 32;
      for (int j = 0; j < m; ++j)
        tot = observe(tot, __shfl_sync(0xffffffffu, cur, j));
    }
    if (lane == 0) {
      total[0] = tot.n; total[1] = tot.mean; total[2] = tot.m2;
    }
    return;
  }

  if (warp >= 2) {   // consumers: node v belongs to warp v % CONSUMERS
    const int me = warp - 2;
    const unsigned below = (1u << lane) - 1u;
    for (int q = 0;; q ^= 1) {
      handover_barrier();
      const int n = ctl[q], last = ctl[2 + q];
      const Event* buf = ring + q * RING;
      for (int base = 0; base < n; base += 32) {
        const int t = base + lane;
        const Event ev = t < n ? buf[t] : Event{0, 0.f};
        const int v = ev.node & 0x7fffffff;
        const bool mine = t < n && v % CONSUMERS == me;
        // a node's events of this chunk, applied in buffer order: the
        // k-th of each node in round k, all nodes' at once
        const unsigned peers =
            __match_any_sync(0xffffffffu, mine ? v : -1 - lane);
        const int rank = __popc(peers & below);
        const int rounds = __reduce_max_sync(0xffffffffu, mine ? rank + 1 : 0);
        for (int k = 0; k < rounds; ++k) {
          if (mine && rank == k) {
            const Stats s = ev.node < 0 ? Stats{0.f, 0.f, 0.f}
                                        : Stats{le_n[v], le_mean[v], le_m2[v]};
            const Stats u = observe(s, ev.y);
            le_n[v] = u.n; le_mean[v] = u.mean; le_m2[v] = u.m2;
          }
          __syncwarp();
        }
      }
      if (last) return;
    }
  }

  // the walker (warp 0, every lane on the same path and writing the same
  // values to the same addresses)
  const int dec = *decimals_p;
  float scale = 1.f;
  for (int i = 0; i < dec; ++i) scale = __fmul_rn(scale, 10.f);
  const float inv = __fdiv_rn(1.f, scale);
  int size = *size_p;
  int p = 0, nev = 0;
  // an event is written at the next slot always and kept if take (no
  // branch on the walk's path); a full buffer is handed over
  auto emit = [&](bool take, int node, float y) {
    ring[p * RING + nev] = {node, y};
    nev += take;
    if (nev == RING) {
      ctl[p] = RING; ctl[2 + p] = 0;
      handover_barrier();
      p ^= 1;
      nev = 0;
    }
  };
  float xn = N > 0 ? xs[0] : 0.f, yn = N > 0 ? ys[0] : 0.f;
  for (long long r = 0; r < N; ++r) {
    float x = xn;
    const float y = yn;
    if (r + 1 < N) { xn = xs[r + 1]; yn = ys[r + 1]; }
    if (dec >= 0) x = __fmul_rn(rintf(__fmul_rn(x, scale)), inv);
    // a nil child of parent (on the left if gl) becomes node size
    auto create = [&](int parent, bool gl) {
      if (size >= cap) return;         // at capacity: stats only
      key[size] = x;
      if (size < cached) nodes[size].key = x;
      if (gl) {
        left[parent] = size;
        if (parent < cached) nodes[parent].left = at(size);
      } else {
        right[parent] = size;
        if (parent < cached) nodes[parent].right = at(size);
      }
      emit(true, size | CREATE, y);
      ++size;
    };
    if (size == 0) {
      key[0] = x;
      nodes[0].key = x;   // cached >= 1: cap >= 1
      emit(true, 0 | CREATE, y);
      size = 1;
      continue;
    }
    unsigned here = top;              // the cached top: one record a level
    Node rec = shared_node(here);
    bool gl;
    unsigned next;
#pragma unroll 2
    for (;;) {
      gl = x <= rec.key;
      next = (unsigned)(gl ? rec.left : rec.right);
      const Node nxt = shared_node(next);
      emit(gl, (int)((here - top) / sizeof(Node)), y);
      if (x == rec.key || next >= nil_at) break;
      here = next;
      rec = nxt;
    }
    int cur = (int)((here - top) / sizeof(Node));
    if (x == rec.key) continue;        // a duplicate adds no node
    if (next == nil_at) {
      create(cur, gl);
      continue;
    }
    cur = gl ? left[cur] : right[cur];   // the child below the cached top
    rec = global_node(key, left, right, cur);
    for (;;) {                         // below it, in global memory
      const bool g = x <= rec.key;
      const int child = g ? rec.left : rec.right;
      const Node nxt = global_node(key, left, right,
                                   min((unsigned)child, (unsigned)(cap - 1)));
      emit(g, cur, y);
      if (x == rec.key) break;
      if (child < 0) { create(cur, g); break; }
      cur = child;
      rec = nxt;
    }
  }
  ctl[p] = nev; ctl[2 + p] = 1;
  handover_barrier();
  if (lane == 0) *size_p = size;
}

// ---- query ---------------------------------------------------------------

constexpr int LEVEL_THREADS = 1024;
constexpr int WIDEST = 8 * LEVEL_THREADS;   // wider levels go to the grid
constexpr int SCORE_THREADS = 256;
constexpr int SCORE_BLOCKS = 1024;   // at most; grid-stride beyond
constexpr unsigned LO_NONE = 0u;     // below the code of every key

struct __align__(16) Record {   // a node packed into one 32-byte sector
  float key;
  int left, right;
  float n, mean, m2, pad0, pad1;
};

struct __align__(16) Entry {    // a queue slot: (node, S, lo); once the
  int node;                     // node is walked, (node, left(v), lo)
  float n, mean, m2;
  unsigned lo, pad0, pad1, pad2;
};

// The level walk's control block, zeroed by ebst_pack_kernel.
struct LevelCtl {
  unsigned arrived, generation;   // the grid barrier
  int tail, next_begin;           // slots taken; where the next level starts
  int begin, end;                 // the next level, published by the barrier
  int pad0, pad1;
};

struct __align__(16) Best {
  float score;
  unsigned pad;
  unsigned long long key;   // in-order tie key, smaller first
};

// total order code of a non-NaN float (-0.0 as +0.0): codes >= 0x007fffff
__device__ __forceinline__ unsigned order_code(float k) {
  const unsigned u = __float_as_uint(__fadd_rn(k, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long tie_key(float k, unsigned lo,
                                                      int v) {
  return isnan(k) ? ((unsigned long long)lo << 32) | 0x80000000ull |
                        (unsigned)v
                  : ((unsigned long long)order_code(k) << 32) | (unsigned)v;
}

// b before a: a greater score, or an equal one earlier in in-order
__device__ __forceinline__ bool beats(const Best& b, const Best& a) {
  return b.score > a.score || (b.score == a.score && b.key < a.key);
}

__device__ __forceinline__ Best best_of_block(Best b, Best* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    Best c = b;
    c.score = __shfl_down_sync(0xffffffffu, b.score, o);
    c.key = __shfl_down_sync(0xffffffffu, b.key, o);
    if (beats(c, b)) b = c;
  }
  if (lane == 0) sh[warp] = b;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      if (beats(sh[w], b)) b = sh[w];
  }
  return b;   // valid in thread 0
}

__global__ void __launch_bounds__(SCORE_THREADS) ebst_pack_kernel(
    const float* __restrict__ key, const int* __restrict__ left,
    const int* __restrict__ right, const float* __restrict__ le_n,
    const float* __restrict__ le_mean, const float* __restrict__ le_m2,
    const int* __restrict__ size_p, Record* __restrict__ rec,
    LevelCtl* __restrict__ ctl) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *ctl = {};
  const int size = *size_p;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < size;
       v += gridDim.x * blockDim.x)
    rec[v] = {key[v], left[v], right[v], le_n[v], le_mean[v], le_m2[v], 0.f,
              0.f};
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// All blocks of the (co-resident, cooperative) grid meet; the last to
// arrive publishes the next level [begin, end).  A barrier that waits
// longer than BARRIER_TIMEOUT_NS traps rather than hang the card.
constexpr long long BARRIER_TIMEOUT_NS = 20000000000ll;

__device__ void next_level(LevelCtl* c, unsigned& gen, int& begin,
                           int& end) {
  __shared__ int sb, se;
  __syncthreads();
  if (threadIdx.x == 0) {
    ++gen;
    __threadfence();
    if (atomicAdd(&c->arrived, 1u) == gridDim.x - 1) {
      c->arrived = 0;
      c->begin = *(volatile int*)&c->next_begin;
      c->end = *(volatile int*)&c->tail;
      __threadfence();
      atomicExch(&c->generation, gen);
    } else {
      const long long t0 = now_ns();
      while (load_acquire(&c->generation) != gen) {
        __nanosleep(64);
        if (now_ns() - t0 > BARRIER_TIMEOUT_NS) __trap();
      }
    }
    __threadfence();
    sb = *(volatile int*)&c->begin;
    se = *(volatile int*)&c->end;
  }
  __syncthreads();
  begin = sb;
  end = se;
}

// Entries are read around L1 (ld.global.cg) under the grid: another SM
// wrote them in the level before, and L1 is not coherent.
template <bool GRID>
__device__ __forceinline__ Entry read_entry(const Entry* p) {
  if (!GRID) return *p;
  const int4 a = __ldcg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldcg(reinterpret_cast<const int4*>(p) + 1);
  return {a.x, __int_as_float(a.y), __int_as_float(a.z), __int_as_float(a.w),
          (unsigned)b.x, 0u, 0u, 0u};
}

// One thread walks a level of one entry (slot i) down its run of single
// children in registers, the run's nodes taking the slots from t on.
// Returns the new tail; *next_begin is where the next level starts.
__device__ int walk_run(const Record* __restrict__ rec, Entry* q, int i,
                        int t, int* next_begin) {
  const Entry e = q[i];
  int v = e.node;
  Stats S = {e.n, e.mean, e.m2};
  unsigned lov = e.lo;
  Record r = rec[v];
  for (;;) {
    const int only = r.left >= 0 && r.right >= 0
                         ? -1
                         : (r.left >= 0 ? r.left : r.right);
    const Record r2 = rec[only >= 0 ? only : v];   // goes first
    const Stats L = merge(S, Stats{r.n, r.mean, r.m2});
    q[i] = {v, L.n, L.mean, L.m2, lov, 0u, 0u, 0u};
    const unsigned lor = isnan(r.key) ? lov : order_code(r.key);
    if (only < 0) {
      *next_begin = t;
      if (r.left >= 0) {               // two children: the next level
        q[t] = {r.left, S.n, S.mean, S.m2, lov, 0u, 0u, 0u};
        q[t + 1] = {r.right, L.n, L.mean, L.m2, lor, 0u, 0u, 0u};
        t += 2;
      }
      return t;
    }
    if (only == r.right) { S = L; lov = lor; }
    i = t++;
    v = only;
    r = r2;
  }
}

// A block walks slots from, from + stride, ... of a level ending at end:
// left(v) over each entry, the children appended at *tail (shared or
// global), one atomic a block.
template <bool GRID>
__device__ void walk_level(const Record* __restrict__ rec, Entry* q, int from,
                           int end, int stride, int* tail, int* warp_off,
                           int* block_base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = from; base < end; base += stride) {
    const int i = base + threadIdx.x;
    int lc = -1, rc = -1;
    Stats S = {0.f, 0.f, 0.f}, L = S;
    unsigned lov = 0u, lor = 0u;
    if (i < end) {
      const Entry e = read_entry<GRID>(q + i);
      const Record r = rec[e.node];
      lc = r.left; rc = r.right;
      lov = e.lo;
      S = {e.n, e.mean, e.m2};
      L = merge(S, Stats{r.n, r.mean, r.m2});
      q[i] = {e.node, L.n, L.mean, L.m2, lov, 0u, 0u, 0u};
      lor = isnan(r.key) ? lov : order_code(r.key);
    }
    const int mine = (lc >= 0) + (rc >= 0);
    int incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_off[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_off[lane];
      int wincl = w;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, wincl, o);
        if (lane >= o) wincl += t;
      }
      warp_off[lane] = wincl - w;
      if (lane == 31) *block_base = wincl > 0 ? atomicAdd(tail, wincl) : 0;
    }
    __syncthreads();
    int slot = *block_base + warp_off[warp] + incl - mine;
    if (lc >= 0) q[slot++] = {lc, S.n, S.mean, S.m2, lov, 0u, 0u, 0u};
    if (rc >= 0) q[slot] = {rc, L.n, L.mean, L.m2, lor, 0u, 0u, 0u};
    __syncthreads();                   // warp_off is reused
  }
}

// One block walks the levels, from the root (from_root) or from where the
// grid stopped, while a level holds at most `widest` entries; it leaves
// the level it stopped at in ctl.
__global__ void __launch_bounds__(LEVEL_THREADS, 1) ebst_levels_kernel(
    const Record* __restrict__ rec, const int* __restrict__ size_p, Entry* q,
    LevelCtl* ctl, int from_root, int widest) {
  __shared__ int tail, next_begin, warp_off[LEVEL_THREADS / 32], block_base;
  if (*size_p == 0) return;            // ctl stays begin = end = 0
  int begin = 0, end = 1;
  if (!from_root) { begin = ctl->begin; end = ctl->end; }
  if (threadIdx.x == 0) {
    if (from_root) q[0] = {0, 0.f, 0.f, 0.f, LO_NONE, 0u, 0u, 0u};
    tail = end;
  }
  __syncthreads();
  while (begin < end && end - begin <= widest) {
    if (end - begin == 1) {
      if (threadIdx.x == 0)
        tail = walk_run(rec, q, begin, end, &next_begin);
    } else {
      if (threadIdx.x == 0) next_begin = end;
      walk_level<false>(rec, q, begin, end, LEVEL_THREADS, &tail, warp_off,
                        &block_base);
    }
    __syncthreads();
    const int b = next_begin, e = tail;
    __syncthreads();
    begin = b;
    end = e;
  }
  if (threadIdx.x == 0) { ctl->begin = begin; ctl->end = end; ctl->tail = end; }
}

// The whole card walks the wide levels (more than one block's worth of
// entries), a grid barrier between levels; it stops at a narrow one.
__global__ void __launch_bounds__(LEVEL_THREADS, 1) ebst_wide_levels_kernel(
    const Record* __restrict__ rec, Entry* q, LevelCtl* ctl) {
  __shared__ int warp_off[LEVEL_THREADS / 32], block_base;
  int begin = ctl->begin, end = ctl->end;
  const bool first = blockIdx.x == 0 && threadIdx.x == 0;
  unsigned gen = 0;
  while (end - begin > LEVEL_THREADS) {
    if (first) ctl->next_begin = end;
    walk_level<true>(rec, q, begin + blockIdx.x * LEVEL_THREADS, end,
                     gridDim.x * LEVEL_THREADS, &ctl->tail, warp_off,
                     &block_base);
    next_level(ctl, gen, begin, end);
  }
}

__global__ void __launch_bounds__(SCORE_THREADS) ebst_score_kernel(
    const float* __restrict__ key, const int* __restrict__ size_p,
    const float* __restrict__ total, const Entry* __restrict__ q,
    Best* __restrict__ part) {
  __shared__ Best sh[SCORE_THREADS / 32];
  const int size = *size_p;
  const Stats tot = {total[0], total[1], total[2]};
  const float s2_d = variance(tot);
  const float n_tot = tot.n < 1.f ? 1.f : tot.n;   // jnp.maximum(n, 1)
  Best b = {-INFINITY, 0u, ~0ull};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += gridDim.x * blockDim.x) {
    const Entry e = q[i];
    const Stats L = {e.n, e.mean, e.m2};
    const Stats R = subtract(tot, L);
    const bool ok = L.n > 0.f && R.n > 0.f;
    const float vr = __fsub_rn(
        __fsub_rn(s2_d, __fmul_rn(__fdiv_rn(L.n, n_tot), variance(L))),
        __fmul_rn(__fdiv_rn(R.n, n_tot), variance(R)));
    const float score = ok ? vr : -INFINITY;
    if (isnan(score)) continue;        // a NaN score never wins
    const Best c = {score, 0u, tie_key(key[e.node], e.lo, e.node)};
    if (beats(c, b)) b = c;
  }
  b = best_of_block(b, sh);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
}

__global__ void __launch_bounds__(SCORE_THREADS) ebst_pick_kernel(
    const float* __restrict__ key, const Best* __restrict__ part, int parts,
    float* __restrict__ out) {
  __shared__ Best sh[SCORE_THREADS / 32];
  Best b = {-INFINITY, 0u, ~0ull};
  for (int i = threadIdx.x; i < parts; i += blockDim.x)
    if (beats(part[i], b)) b = part[i];
  b = best_of_block(b, sh);
  if (threadIdx.x != 0) return;
  // the walk keeps thr = 0 unless some score beat -inf
  const bool any = b.score > -INFINITY;
  const bool valid = isfinite(b.score);
  out[0] = any ? key[b.key & 0x7fffffffull] : 0.f;
  out[1] = valid ? b.score : 0.f;
  out[2] = valid ? 1.f : 0.f;
}

int score_blocks(int cap) {
  const long long b = ((long long)cap + SCORE_THREADS - 1) / SCORE_THREADS;
  return b < SCORE_BLOCKS ? (int)b : SCORE_BLOCKS;
}

// ---- the serial kernels (one thread each): the card-side oracle ----------

struct StackEntry {   // a node whose emit step is due, with its context S
  int node;
  float n, mean, m2;
};

__global__ void ebst_insert_serial_kernel(
    float* __restrict__ key, int* __restrict__ left, int* __restrict__ right,
    float* __restrict__ le_n, float* __restrict__ le_mean,
    float* __restrict__ le_m2, int* __restrict__ size_p,
    float* __restrict__ total, const int* __restrict__ decimals_p,
    const float* __restrict__ xs, const float* __restrict__ ys, long long N,
    int cap) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const int dec = *decimals_p;
  float scale = 1.f;
  for (int i = 0; i < dec; ++i) scale = __fmul_rn(scale, 10.f);
  const float inv = __fdiv_rn(1.f, scale);
  int size = *size_p;
  Stats tot = {total[0], total[1], total[2]};
  const Stats empty = {0.f, 0.f, 0.f};
  for (long long r = 0; r < N; ++r) {
    float x = xs[r];
    const float y = ys[r];
    if (dec >= 0) x = __fmul_rn(rintf(__fmul_rn(x, scale)), inv);
    tot = observe(tot, y);
    if (size == 0) {
      const Stats s = observe(empty, y);
      key[0] = x;
      le_n[0] = s.n; le_mean[0] = s.mean; le_m2[0] = s.m2;
      size = 1;
      continue;
    }
    int cur = 0;
    for (;;) {
      const float k = key[cur];
      const int lc = left[cur], rc = right[cur];
      const Stats s = {le_n[cur], le_mean[cur], le_m2[cur]};
      const bool goes_left = x <= k;
      if (goes_left) {
        const Stats u = observe(s, y);
        le_n[cur] = u.n; le_mean[cur] = u.mean; le_m2[cur] = u.m2;
      }
      const bool is_eq = x == k;
      const int child = goes_left ? lc : rc;
      if (child == -1 && !is_eq) {
        if (size < cap) {
          const Stats u = observe(empty, y);
          key[size] = x;
          le_n[size] = u.n; le_mean[size] = u.mean; le_m2[size] = u.m2;
          if (goes_left) left[cur] = size; else right[cur] = size;
          ++size;
        }
        break;
      }
      if (is_eq) break;
      cur = child;
    }
  }
  *size_p = size;
  total[0] = tot.n; total[1] = tot.mean; total[2] = tot.m2;
}

__global__ void ebst_query_serial_kernel(
    const float* __restrict__ key, const int* __restrict__ left,
    const int* __restrict__ right, const float* __restrict__ le_n,
    const float* __restrict__ le_mean, const float* __restrict__ le_m2,
    const int* __restrict__ size_p, const float* __restrict__ total,
    StackEntry* __restrict__ stk, float* __restrict__ out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const Stats tot = {total[0], total[1], total[2]};
  const float s2_d = variance(tot);
  const float n_tot = tot.n < 1.f ? 1.f : tot.n;
  float best = -INFINITY, thr = 0.f;
  int sp = 0;
  int v = *size_p > 0 ? 0 : -1;
  Stats S = {0.f, 0.f, 0.f};
  for (;;) {
    while (v != -1) {
      stk[sp++] = {v, S.n, S.mean, S.m2};
      v = left[v];
    }
    if (sp == 0) break;
    const StackEntry e = stk[--sp];
    const Stats ctx = {e.n, e.mean, e.m2};
    const Stats node = {le_n[e.node], le_mean[e.node], le_m2[e.node]};
    const Stats L = merge(ctx, node);
    const Stats R = subtract(tot, L);
    const bool ok = L.n > 0.f && R.n > 0.f;
    const float vr = __fsub_rn(
        __fsub_rn(s2_d, __fmul_rn(__fdiv_rn(L.n, n_tot), variance(L))),
        __fmul_rn(__fdiv_rn(R.n, n_tot), variance(R)));
    const float score = ok ? vr : -INFINITY;
    if (score > best) {
      best = score;
      thr = key[e.node];
    }
    v = right[e.node];
    S = L;
  }
  const bool valid = isfinite(best);
  out[0] = thr;
  out[1] = valid ? best : 0.f;
  out[2] = valid ? 1.f : 0.f;
}

}  // namespace

// Nodes the insert keeps in shared memory (the wrapper checks its copy).
extern "C" int ebst_shared_nodes() { return SHARED_NODES; }

// Inserts the N rows (xs, ys) in order, updating the state in place.
extern "C" int ebst_insert_launch(void* key, void* left, void* right,
                                  void* le_n, void* le_mean, void* le_m2,
                                  void* size, void* total,
                                  const void* decimals, const void* xs,
                                  const void* ys, long long n, int cap,
                                  void* stream) {
  if (n == 0) return 0;
  const int cached = cap < SHARED_NODES ? cap : SHARED_NODES;
  const size_t smem = (size_t)(cached + 2) * sizeof(Node) +
                      2 * RING * sizeof(Event) + 4 * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ebst_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ebst_insert_kernel<<<1, INSERT_THREADS, smem, (cudaStream_t)stream>>>(
      (float*)key, (int*)left, (int*)right, (float*)le_n, (float*)le_mean,
      (float*)le_m2, (int*)size, (float*)total, (const int*)decimals,
      (const float*)xs, (const float*)ys, n, cap, cached);
  return (int)cudaGetLastError();
}

// Bytes of scratch the query takes at capacity cap: the packed records,
// the level queue, the blocks' bests and the level walk's control block.
extern "C" long long ebst_query_scratch_bytes(int cap) {
  return (long long)(2 * (size_t)cap * sizeof(Record) +
                     (size_t)score_blocks(cap) * sizeof(Best) +
                     sizeof(LevelCtl));
}

// Best split of the tree: out = [threshold, merit, valid].
extern "C" int ebst_query_launch(const void* key, const void* left,
                                 const void* right, const void* le_n,
                                 const void* le_mean, const void* le_m2,
                                 const void* size, const void* total,
                                 void* scratch, int cap, void* out,
                                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  Record* rec = (Record*)scratch;
  Entry* q = (Entry*)(rec + cap);
  const int blocks = score_blocks(cap);
  Best* part = (Best*)(q + cap);
  LevelCtl* ctl = (LevelCtl*)(part + blocks);
  ebst_pack_kernel<<<blocks, SCORE_THREADS, 0, st>>>(
      (const float*)key, (const int*)left, (const int*)right,
      (const float*)le_n, (const float*)le_mean, (const float*)le_m2,
      (const int*)size, rec, ctl);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the narrow top of the tree in one block; no level of a tree of at
  // most WIDEST nodes is wider, so it is walked whole
  ebst_levels_kernel<<<1, LEVEL_THREADS, 0, st>>>(rec, (const int*)size, q,
                                                  ctl, 1, WIDEST);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (cap > WIDEST) {
    // the wide levels on the whole card: one block an SM, all resident (a
    // cooperative launch refuses a grid that cannot be), then the narrow
    // rest in one block
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ebst_wide_levels_kernel, LEVEL_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {(void*)&rec, (void*)&q, (void*)&ctl};
    e = cudaLaunchCooperativeKernel((const void*)ebst_wide_levels_kernel,
                                    dim3(sms), dim3(LEVEL_THREADS), args, 0,
                                    st);
    if (e != cudaSuccess) return (int)e;
    ebst_levels_kernel<<<1, LEVEL_THREADS, 0, st>>>(rec, (const int*)size, q,
                                                    ctl, 0, 0x7fffffff);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ebst_score_kernel<<<blocks, SCORE_THREADS, 0, st>>>(
      (const float*)key, (const int*)size, (const float*)total, q, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ebst_pick_kernel<<<1, SCORE_THREADS, 0, st>>>((const float*)key, part,
                                                blocks, (float*)out);
  return (int)cudaGetLastError();
}

// The serial kernels (one thread each): the oracle.
extern "C" int ebst_insert_serial_launch(void* key, void* left, void* right,
                                         void* le_n, void* le_mean,
                                         void* le_m2, void* size, void* total,
                                         const void* decimals, const void* xs,
                                         const void* ys, long long n, int cap,
                                         void* stream) {
  if (n == 0) return 0;
  ebst_insert_serial_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (float*)key, (int*)left, (int*)right, (float*)le_n, (float*)le_mean,
      (float*)le_m2, (int*)size, (float*)total, (const int*)decimals,
      (const float*)xs, (const float*)ys, n, cap);
  return (int)cudaGetLastError();
}

// stack holds cap + 1 entries of 16 bytes.
extern "C" int ebst_query_serial_launch(const void* key, const void* left,
                                        const void* right, const void* le_n,
                                        const void* le_mean,
                                        const void* le_m2, const void* size,
                                        const void* total, void* stack,
                                        void* out, void* stream) {
  ebst_query_serial_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const float*)key, (const int*)left, (const int*)right,
      (const float*)le_n, (const float*)le_mean, (const float*)le_m2,
      (const int*)size, (const float*)total, (StackEntry*)stack, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
