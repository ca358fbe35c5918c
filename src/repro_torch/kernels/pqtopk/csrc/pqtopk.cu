// PQTopK scoring kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// pq_scores_kernel replaces the TPU kernel
//   src/repro/kernels/pqtopk/kernel.py: pq_scores_kernel / _tile_scores
//   (launched by pq_scores_call).
//   r[q, i] = sum_k S[q, k, codes[i, k]]  ->  (B, N) f32.
//
// pq_topk_fused_kernel replaces the TPU kernel
//   src/repro/kernels/pqtopk/kernel.py: pq_topk_fused_kernel / _tile_topk
//   (launched by pq_topk_fused_call) in all four of its forms:
//   (a) a 1D identity tile_idx (the exhaustive pqtopk_fused route);
//   (b) a 1D compacted tile_idx with -1 sentinel slots (the batch-any
//       pqtopk_pruned route, kernel.py:170-173);
//   (c) a 2D (n_batch_tiles, n_slots) table (the grouped pqtopk_pruned
//       route, kernel.py:156-159): query q's slot i scores tile
//       tile_idx[(q / batch_tile) * n_slots + i];
//   (d) any of these with the `live` tombstone mask (the mutable
//       catalogue, kernel.py:148-155, :183-186, :279-285): a flat (n_rows,)
//       byte array, 0 = dead row, which scores -inf inside the tile top-k.
//   Per (item-tile slot, query): the tile's exact top-K, global ids, ties to
//   the lowest id, ids >= n_items (and dead rows) -inf; a slot whose
//   tile_idx is -1 writes (-inf, n_items).  Output (B, n_slots, K) f32 + i32;
//   the cross-slot merge is left to the caller.  The order is lax.top_k's
//   total order, the reference's: +0.0 above -0.0, +NaN first, -NaN last
//   (below -inf and below the -inf padding of a ragged tile), NaNs by their
//   bits.  Every comparison that ranks a score compares the int32 key
//   order_key(x) = bits ^ ((bits >> 31) & 0x7fffffff), made once where a
//   score is written for the selection; the winners' values are the keys
//   mapped back, bit for bit.
//
// What bounds them.  Both gather B*N*m f32 values of S from shared memory
// at random codes.  pq_scores also writes B*N f32 (325 MB at the main shape,
// B=64, N=1,271,638, m=8, b=512: 0.10 ms at 3.35 TB/s, its table bound);
// the fused kernel writes only B*n_slots*K candidates, so its table bound
// is the lookups, 32 four-byte lookups per SM per clock: 0.078 ms.  No
// random gather reaches that.  Lanes reading random words of one row of S
// meet in banks, and each distinct word in a bank costs a wavefront: 32
// lanes over 32 banks take ~3.5 wavefronts a warp load with S laid out
// (qb, m, b), a conflict-adjusted floor of ~0.27 ms for both kernels;
// 16-byte loads of 8 lanes a phase over 8 bank groups take ~2.5 a phase,
// ~0.20 ms.  That floor, not the table's bound, is what the design aims at:
// on an H100 (700 W) the fused kernel's scoring alone takes 0.365 ms at the
// main shape, and 0.226 ms with its gathers made conflict-free (a timing
// variant), the whole kernel 0.467 ms.
//
// Design (one design serves both kernels):
// * S is staged per block interleaved by query, (m, b, QB) with QB = 1, 2
//   or 4 queries innermost, so one lane fetches QB queries' values of one
//   (split, code) with one 4-, 8- or 16-byte ld.shared: 4x fewer loads
//   and fewer conflicts per lookup.  QB is chosen per launch (Python,
//   kernel.py: plan_launch): 4 for a batch, 1 at B=1, where every lane
//   then scores its own item for the one query.  The transpose happens in
//   the staging, once per block.
// * Code rows arrive asynchronously: a ring of 2 to 8 chunks of code rows
//   (and their live bytes, form d) in shared memory, filled with 16-byte
//   cp.async by all threads; all but one chunk are in flight while one is
//   scored (the plan fills the room S and the score buffers leave, up to
//   128 KB: enough to cover HBM latency where the codes do not fit in L2,
//   as BST's 4M rows).  Lanes read their item's codes from the ring as
//   16-, 8- or 4-byte words.  A sentinel slot issues no copy.  One block
//   barrier per chunk, which the ring needs anyway, is the only one.
// * Blocks are resident: one wave, block (x, y) staging S for query chunk
//   y once and striding over slots (item chunks for pq_scores) x, x + gx,
//   ..., so sentinel slots spread over the blocks wherever they sit.
// * Fused selection does not rescan the tile K times and does not hold up
//   scoring.  Warps are specialised: QB warps select, one query each, the
//   rest score.  Each query carries a threshold predicted from the slot
//   two before (the value ranked 2K - 1 there); the scoring warps append
//   the items that reach it to the query's candidate buffer (a shared
//   atomic, ~2K per slot on random scores) as they write the slot's score
//   keys (order_key) to one of two (QB, tile) buffers.  In the next chunk's
//   barrier interval, while the next slot is scored, the selecting warp
//   ranks the candidates by counting the ones that beat each in (key desc,
//   id asc) order; when at least K and at most the buffer's 64 items reached the
//   threshold, the K best of them are exactly the tile's top-K.  Otherwise
//   (the block's first two slots, a shifted score distribution) it selects
//   from the score buffer: theta0 = the ~1.5K-th largest lane maximum, the
//   items >= theta0 buffered and ranked, and when K > 32 or those overflow,
//   K rounds of a warp arg-max with a cached best per group of 8 columns.
//   Either way the bits do not change.  The selecting warps' shared-memory
//   round trips queue behind the scoring warps' gathers, so selection is
//   written with few of them: batched 16-byte loads, one atomic, no
//   shuffle chains on the common path.
// * One instance per width the configs use, M = 2, 4, 6, 8 (FM, DCN-v2,
//   DIEN, SASRec/BST), and a generic one for the rest.  The per-split
//   partials are summed as a binary counter (carry chain over the bits of
//   the split index, then a fold of the remaining levels), which is exactly
//   the reference's tree_sum order (pairs, odd tail appended) for every m
//   up to 64, and needs 7 partials whatever m is: no 64-entry local arrays.
// * Launch setup is cached per instance under a mutex, so threads on
//   their own streams may launch at once at different plans: the
//   shared-memory limit is raised once to the device's maximum (never
//   lowered between another thread's set and its launch), the occupancy
//   is read once per shared-memory size.
//
// The build uses no fast-math flags, so the results are bit-identical to
// the plain versions.  Every C entry returns cudaGetLastError() (or the
// first error seen) as an int.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

// The launch plan Python computes (kernel.py: plan_launch); byte offsets
// into dynamic shared memory.  Outside the anonymous namespace: the C
// entries take it, and a type with internal linkage would give them
// internal linkage too.
struct Plan {
  int threads;      // threads of a block (the kernels' kThreads)
  int qb;           // queries per lane lookup (1, 2 or 4)
  int chunk;        // code rows per ring stage
  int depth;        // ring stages
  int smem;         // dynamic shared memory bytes
  int sc_off;       // fused: 2 score buffers of (qb, tile) f32
  int cand_off;     // fused: the queries' candidates, then a buffer of
                    // kCandCap int2 per warp
  int ring_off;     // ring of `depth` stages
  int stage_bytes;  // bytes of one stage
  int live_off;     // live bytes within a stage (form d)
};

namespace {

constexpr int kMaxM = 64;            // largest m the generic path takes
constexpr int kLevels = 7;           // carry-chain partials: 2^6 = kMaxM
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneCols = 64;        // tile <= 2048 = 32 lanes x 64 columns
constexpr int kGroup = 8;            // arg-max: columns per cached group
constexpr int kGroups = kLaneCols / kGroup;
constexpr int kCandCap = 64;         // candidates a query's buffer holds
constexpr int kMaxQB = 4;
constexpr int kMaxDepth = 8;         // ring stages the wait below spells out
constexpr int kCacheSizes = 16;      // shared-memory sizes a launch cache holds

enum CodeType { kInt8 = 0, kUint8 = 1, kInt16 = 2, kUint16 = 3, kInt32 = 4 };

struct Args {
  const void* codes;
  const float* s;
  const int* tile_idx;
  const uint8_t* live;
  float* out_v;     // fused: (B, n_slots, k); scores: (B, n)
  int* out_i;
  int n_rows, n_items, m, b, bq, n_slots, tile, k, batch_tile;
  int n_chunks;     // scores: item chunks; fused: ring chunks per slot
  int vec;          // codes pointer 16-byte aligned: rows read as words
  Plan plan;
};

// Per-query selection state of the fused kernel, two sets (one per score
// buffer): the threshold key predicted for the slot scored into the
// buffer, the count of its items at or above it, and the first kCandCap
// of them.
struct QueryCands {
  int theta[2][kMaxQB];
  int count[2][kMaxQB];
  int2 cand[2][kMaxQB][kCandCap];     // (key, column)
};

template <int QB> struct VecOf;
template <> struct VecOf<1> { using T = float; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<4> { using T = float4; };

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float2 vadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float vget(float a, int) { return a; }
__device__ __forceinline__ float vget(float2 a, int j) { return j ? a.y : a.x; }
__device__ __forceinline__ float vget(float4 a, int j) {
  return j == 0 ? a.x : j == 1 ? a.y : j == 2 ? a.z : a.w;
}
__device__ __forceinline__ int vget(int4 a, int j) {
  return j == 0 ? a.x : j == 1 ? a.y : j == 2 ? a.z : a.w;
}
template <typename V>
__host__ __device__ constexpr int lanes_of() {
  return sizeof(V) / sizeof(float);
}

// 16-byte asynchronous copy global -> shared; bytes past `src_bytes` are
// zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most n committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// Copy bytes [lo, hi) of global memory into `dst` from the 16-byte
// boundary at or below lo (so lo lands at dst + (lo & 15)).  Every 16-byte
// word read holds a byte of [lo, hi), so no read leaves the words the
// array occupies.
__device__ __forceinline__ void copy_range(unsigned char* dst, uintptr_t lo,
                                           uintptr_t hi) {
  const uintptr_t a = lo & ~static_cast<uintptr_t>(15);
  const int words = static_cast<int>((hi - a + 15) >> 4);
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const uintptr_t src = a + 16 * static_cast<uintptr_t>(w);
    const uintptr_t left = hi - src;
    cp_async16(dst + 16 * w, reinterpret_cast<const void*>(src),
               left < 16 ? static_cast<int>(left) : 16);
  }
}

// One ring stage: code rows [g0, g0 + len) clipped to n_rows, and their
// live bytes; always commits one group (empty when len is 0).
template <typename CT>
__device__ __forceinline__ void issue_chunk(const Args& a, unsigned char* st,
                                            long long g0, int len) {
  const long long g1 = min(g0 + len, static_cast<long long>(a.n_rows));
  if (len > 0 && g1 > g0) {
    const size_t rb = static_cast<size_t>(a.m) * sizeof(CT);
    const uintptr_t base = reinterpret_cast<uintptr_t>(a.codes);
    copy_range(st, base + g0 * rb, base + g1 * rb);
    if (a.live) {
      const uintptr_t lb = reinterpret_cast<uintptr_t>(a.live);
      copy_range(st + a.plan.live_off, lb + g0, lb + g1);
    }
  }
  cp_async_commit();
}

// Codes of one row from the ring, as ints.  M > 0 with an aligned ring
// reads the row as 16-, 8- or 4-byte words; otherwise element by element.
template <typename CT, int M>
struct RowCodes {
  static constexpr int kBytes = M * static_cast<int>(sizeof(CT));
  static constexpr int kWord = kBytes % 16 == 0 ? 16
                               : kBytes % 8 == 0 ? 8
                               : kBytes % 4 == 0 ? 4 : 0;
  int c[M > 0 ? M : 1];

  __device__ __forceinline__ void load(const unsigned char* row, bool vec) {
    if constexpr (M > 0 && kWord > 0) {
      if (vec) {
        uint32_t w[kBytes / 4];
#pragma unroll
        for (int i = 0; i < kBytes / kWord; ++i) {
          if constexpr (kWord == 16) {
            const uint4 v = reinterpret_cast<const uint4*>(row)[i];
            w[4 * i] = v.x; w[4 * i + 1] = v.y;
            w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
          } else if constexpr (kWord == 8) {
            const uint2 v = reinterpret_cast<const uint2*>(row)[i];
            w[2 * i] = v.x; w[2 * i + 1] = v.y;
          } else {
            w[i] = reinterpret_cast<const uint32_t*>(row)[i];
          }
        }
#pragma unroll
        for (int k = 0; k < M; ++k) {
          const int byte = k * static_cast<int>(sizeof(CT));
          const uint32_t word = w[byte / 4] >> (8 * (byte % 4));
          if constexpr (sizeof(CT) == 1) {
            c[k] = static_cast<int>(static_cast<CT>(word & 0xffu));
          } else if constexpr (sizeof(CT) == 2) {
            c[k] = static_cast<int>(static_cast<CT>(word & 0xffffu));
          } else {
            c[k] = static_cast<int>(word);
          }
        }
        return;
      }
    }
    if constexpr (M > 0) {
#pragma unroll
      for (int k = 0; k < M; ++k)
        c[k] = static_cast<int>(reinterpret_cast<const CT*>(row)[k]);
    }
  }
};

// Score one item for the QB queries of the staged S.  The per-split
// partials are summed as a binary counter: pushing split k merges with
// the level-L partial for each low set bit L of k (earlier block on the
// left), and the levels left over are folded from the lowest up.  This is
// exactly tree_sum's order (checked for every m <= 64), with at most
// kLevels partials alive whatever m is.  M > 0 unrolls every split, so
// every index is compile-time.  M == 0 takes m at run time in blocks of 8
// splits: inside a block the carry over levels 0-2 is compile-time, and a
// full block (a level-3 partial) carries over levels 3-6 with branches on
// the block index, so nothing leaves the registers either way.
template <int QB>
__device__ __forceinline__ void push3(typename VecOf<QB>::T (&lo)[3],
                                      typename VecOf<QB>::T x, int ki,
                                      typename VecOf<QB>::T* full) {
  // ki's low bits are compile-time at every call (unrolled loops).
  if (!(ki & 1)) { lo[0] = x; return; }
  x = vadd(lo[0], x);
  if (!(ki & 2)) { lo[1] = x; return; }
  x = vadd(lo[1], x);
  if (!(ki & 4)) { lo[2] = x; return; }
  *full = vadd(lo[2], x);
}

template <typename CT, int M, int QB>
__device__ __forceinline__ typename VecOf<QB>::T score_item(
    const unsigned char* row, const float* __restrict__ s_sh, int m_rt,
    int b, bool vec) {
  using V = typename VecOf<QB>::T;
  auto look = [&](int k, int c) {
    return *reinterpret_cast<const V*>(s_sh + (k * b + c) * QB);
  };
  V acc;
  bool have = false;
  if constexpr (M > 0) {
    RowCodes<CT, M> rc;
    rc.load(row, vec);
    V lv[kLevels];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      V x = look(k, rc.c[k]);
#pragma unroll
      for (int L = 0; L < kLevels; ++L) {
        if ((k >> L) & 1) {
          x = vadd(lv[L], x);
        } else {
          lv[L] = x;
          break;
        }
      }
    }
#pragma unroll
    for (int L = 0; L < kLevels; ++L) {
      if ((M >> L) & 1) {
        acc = have ? vadd(lv[L], acc) : lv[L];
        have = true;
      }
    }
  } else {
    const int m = m_rt;
    const CT* cr = reinterpret_cast<const CT*>(row);
    V lo[3], o0, o1, o2, o3;   // levels 0-2; levels 3, 4, 5, 6
    for (int kb = 0; kb * 8 < m; ++kb) {
      V full;
      bool done = false;
#pragma unroll
      for (int ki = 0; ki < 8; ++ki) {
        const int k = kb * 8 + ki;
        if (k < m) {
          push3<QB>(lo, look(k, static_cast<int>(cr[k])), ki, &full);
          done = ki == 7;
        }
      }
      if (done) {              // a level-3 partial: carry by kb's bits
        V x = full;
        if (!(kb & 1)) {
          o0 = x;
        } else {
          x = vadd(o0, x);
          if (!(kb & 2)) {
            o1 = x;
          } else {
            x = vadd(o1, x);
            if (!(kb & 4)) o2 = x;
            else o3 = vadd(o2, x);
          }
        }
      }
    }
#pragma unroll
    for (int L = 0; L < 3; ++L) {
      if ((m >> L) & 1) {
        acc = have ? vadd(lo[L], acc) : lo[L];
        have = true;
      }
    }
    auto fold = [&](int L, const V& v) {
      if ((m >> L) & 1) {
        acc = have ? vadd(v, acc) : v;
        have = true;
      }
    };
    fold(3, o0);
    fold(4, o1);
    fold(5, o2);
    fold(6, o3);
  }
  return acc;
}

// Stage S for queries [q0, q0 + nq) as (m, b, qb), queries innermost;
// query slots past nq hold 0.
__device__ __forceinline__ void stage_s(float* s_sh, const float* __restrict__ s,
                                        int q0, int nq, int qb, int mb) {
  for (int e = threadIdx.x; e < qb * mb; e += blockDim.x) {
    const int j = e / mb, kc = e - j * mb;
    s_sh[kc * qb + j] =
        j < nq ? s[static_cast<long long>(q0 + j) * mb + kc] : 0.0f;
  }
}

// Score ring chunk rows [0, len) with threads tid = 0 .. nt - 1: row r is
// global item g0 + r, found at byte (codes + g0 * row bytes) & 15 of the
// stage (copy_range).  Each valid item's QB scores go to sink(r, g, v) (v a
// float, float2 or float4), an invalid one (past n_items or n_rows, or
// dead) to dead(r).
template <typename CT, int M, int QB, typename Sink, typename Dead>
__device__ __forceinline__ void score_rows(const Args& a,
                                           const unsigned char* st,
                                           const float* s_sh, long long g0,
                                           int len, int tid, int nt,
                                           Sink& sink, Dead& dead) {
  const size_t rb = static_cast<size_t>(M > 0 ? M : a.m) * sizeof(CT);
  const unsigned char* rows =
      st + ((reinterpret_cast<uintptr_t>(a.codes) + g0 * rb) & 15);
  const unsigned char* lives =
      st + a.plan.live_off + ((reinterpret_cast<uintptr_t>(a.live) + g0) & 15);
  const bool vec = a.vec != 0;
  for (int r = tid; r < len; r += nt) {
    const long long g = g0 + r;
    if (g >= a.n_items || g >= a.n_rows || (a.live && !lives[r])) {
      dead(r);
      continue;
    }
    sink(r, g, score_item<CT, M, QB>(rows + r * rb, s_sh, a.m, a.b, vec));
  }
}

// score_rows at the launch's QB (block-uniform): the only code that
// exists once per QB.
template <typename CT, int M, typename Sink, typename Dead>
__device__ __forceinline__ void score_chunk(const Args& a,
                                            const unsigned char* st,
                                            const float* s_sh, long long g0,
                                            int len, int tid, int nt,
                                            Sink sink, Dead dead) {
  switch (a.plan.qb) {
    case 4:
      score_rows<CT, M, 4>(a, st, s_sh, g0, len, tid, nt, sink, dead);
      break;
    case 2:
      score_rows<CT, M, 2>(a, st, s_sh, g0, len, tid, nt, sink, dead);
      break;
    default:
      score_rows<CT, M, 1>(a, st, s_sh, g0, len, tid, nt, sink, dead);
      break;
  }
}

// lax.top_k's total order as signed integers: -NaN < -inf < .. < -0.0 <
// +0.0 < .. < +inf < +NaN.  The map is its own inverse.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}
constexpr int kNegInfKey = static_cast<int>(0x807fffff);   // order_key(-inf)
constexpr int kNoTheta = 0x7fffffff;  // "no prediction"; see next_theta

// a beats b: larger key, or equal key and lower column.
__device__ __forceinline__ bool beats(int ak, int ai, int bk, int bi) {
  return ak > bk || (ak == bk && ai < bi);
}

// The selection below runs on warps of their own while the scoring warps
// keep the shared-memory pipe busy with gathers, so each of its dependent
// shared-memory round trips waits behind that queue: it is written to need
// few of them (batched 16-byte loads, one atomic, no shuffle chains).

// The next slots' threshold key as stored.  One at or below -inf's would
// take every item but -NaN ones, so it becomes kNoTheta, "no prediction":
// the largest key, which only canonical +NaN items (0x7fffffff, what the
// card's adds return for NaN) reach.  The selection stays exact whatever
// the threshold: it ranks the candidates only when every item at or above
// the threshold is one of them and there are at least K, so a collision of
// kNoTheta with real +NaN scores is one more exact case, not a sentinel
// clash.
__device__ __forceinline__ int next_theta(int key) {
  return key <= kNegInfKey ? kNoTheta : key;
}

// One warp ranks `total` (<= kCandCap) candidates (key, column) in `cand`
// by the candidates that beat them (ranks are distinct: columns are),
// writes rank r < k to ov/oi[r] with global id base + column, and stores
// the key ranked kt - 1 (kt <= total) to *theta.  When every item of the
// tile at or above some key is a candidate and there are at least k of
// them, the k best are exactly the tile's top-k.  Each lane reads the
// candidates 16 at a time, 8 independent 16-byte broadcast loads.
__device__ __forceinline__ void rank_cands(const int2* cand, int total,
                                           int k, int kt, long long base,
                                           float* ov, int* oi, int* theta,
                                           int lane) {
  for (int e = lane; e < total; e += 32) {
    const int2 me = cand[e];
    int rank = 0;
    for (int f0 = 0; f0 < total; f0 += 16) {
      int4 w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = reinterpret_cast<const int4*>(cand + f0)[i];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        rank += (f0 + 2 * i < total) & beats(w[i].x, w[i].y, me.x, me.y);
        rank += (f0 + 2 * i + 1 < total) & beats(w[i].z, w[i].w, me.x, me.y);
      }
    }
    if (rank < k) {
      ov[rank] = key_value(me.x);
      oi[rank] = static_cast<int>(base + me.y);
    }
    if (rank == kt - 1) *theta = next_theta(me.x);
  }
}

// The K-round fallback's cached best of group G: columns lane + 32 j for
// j in [G*kGroup, (G+1)*kGroup), read from the key row; taken or absent
// columns are skipped; ties to the lowest j.
#define PQ_GROUP_BEST(G)                                                  \
  {                                                                       \
    int v_ = INT_MIN;                                                     \
    int j_ = -1;                                                          \
    _Pragma("unroll") for (int jj = 0; jj < kGroup; ++jj) {               \
      const int j = (G) * kGroup + jj;                                    \
      if (j < n_cols && !((taken >> j) & 1ull)) {                         \
        const int x_ = row[lane + 32 * j];                                \
        if (j_ < 0 || x_ > v_) {                                          \
          v_ = x_;                                                        \
          j_ = j;                                                         \
        }                                                                 \
      }                                                                   \
    }                                                                     \
    gv[G] = v_;                                                           \
    gj[G] = j_;                                                           \
  }

// The lane's best over its group bests -> (key, column); an exhausted
// lane offers (INT_MIN, INT_MAX), which loses every tie.
__device__ __forceinline__ void lane_best(const int (&gv)[kGroups],
                                          const int (&gj)[kGroups], int lane,
                                          int* bv, int* bi) {
  int v = INT_MIN;
  int jb = -1;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (gj[g] >= 0 && (jb < 0 || gv[g] > v)) {
      v = gv[g];
      jb = gj[g];
    }
  }
  *bv = v;
  *bi = jb < 0 ? 0x7fffffff : lane + 32 * jb;
}

// One warp: the exact top-k of one query's scored tile `row` (tile keys in
// shared memory), written to ov/oi with global ids base + column, and the
// next slots' threshold to *theta.  kq in [k, 32]: theta0 = the kq-th
// largest lane maximum, so at least kq items (every item, when a lane
// without columns ranks among the first kq) reach theta0 and every top-kq
// item does; those (~1.4 kq on random scores) are buffered in `buf` (the
// warp's kCandCap int2) and ranked, and *theta is the one ranked
// min(total, 2k) - 1.  Otherwise, or when they overflow the buffer, k
// rounds of a warp arg-max with a cached best per group of 8 columns, and
// *theta is the k-th best.
__device__ __forceinline__ void select_row(const int* row, int tile, int k,
                                           int kq, long long base, float* ov,
                                           int* oi, int2* buf, int* theta,
                                           int lane) {
  const int n_cols = tile > lane ? (tile - lane + 31) >> 5 : 0;
  if (kq <= 32) {
    // The lane's columns are read from the row three times (maximum, count,
    // candidates) rather than held: registers are the scoring warps'.
    int l0 = INT_MIN, l1 = INT_MIN, l2 = INT_MIN, l3 = INT_MIN;
    int j = 0;
    for (; j + 4 <= n_cols; j += 4) {
      l0 = max(l0, row[lane + 32 * j]);
      l1 = max(l1, row[lane + 32 * (j + 1)]);
      l2 = max(l2, row[lane + 32 * (j + 2)]);
      l3 = max(l3, row[lane + 32 * (j + 3)]);
    }
    for (; j < n_cols; ++j) l0 = max(l0, row[lane + 32 * j]);
    const int lm = max(max(l0, l1), max(l2, l3));
    // theta0: the lane maxima go through the buffer; each lane ranks its
    // own among them (key desc, lane asc) and the one ranked kq - 1 posts
    // it.
    int* sm = reinterpret_cast<int*>(buf);
    int* counter = sm + 65;
    sm[lane] = lm;
    if (lane == 0) *counter = 0;
    __syncwarp();
    int r = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int4 w = reinterpret_cast<const int4*>(sm)[i];
      r += (w.x > lm) | ((w.x == lm) & (4 * i < lane));
      r += (w.y > lm) | ((w.y == lm) & (4 * i + 1 < lane));
      r += (w.z > lm) | ((w.z == lm) & (4 * i + 2 < lane));
      r += (w.w > lm) | ((w.w == lm) & (4 * i + 3 < lane));
    }
    if (r == kq - 1) sm[64] = lm;
    __syncwarp();
    const int theta0 = sm[64];
    int mine = 0;
#pragma unroll 16
    for (int j = 0; j < n_cols; ++j) mine += row[lane + 32 * j] >= theta0;
    int pos = atomicAdd(counter, mine);
    __syncwarp();
    const int total = *counter;
    __syncwarp();             // every lane has read theta0 and the total
    if (total <= kCandCap) {
      for (int j = 0; j < n_cols; ++j) {
        const int v = row[lane + 32 * j];
        if (v >= theta0) buf[pos++] = make_int2(v, lane + 32 * j);
      }
      __syncwarp();
      rank_cands(buf, total, k, min(total, 2 * k), base, ov, oi, theta,
                 lane);
      __syncwarp();
      return;
    }
  }
  unsigned long long taken = 0;
  int gv[kGroups];
  int gj[kGroups];
  PQ_GROUP_BEST(0) PQ_GROUP_BEST(1) PQ_GROUP_BEST(2) PQ_GROUP_BEST(3)
  PQ_GROUP_BEST(4) PQ_GROUP_BEST(5) PQ_GROUP_BEST(6) PQ_GROUP_BEST(7)
  int bv;
  int bi;
  lane_best(gv, gj, lane, &bv, &bi);
  for (int r = 0; r < k; ++r) {
    int v = bv;
    int i = bi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int v2 = __shfl_xor_sync(0xffffffffu, v, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
      if (beats(v2, i2, v, i)) {
        v = v2;
        i = i2;
      }
    }
    if (lane == 0) {
      ov[r] = key_value(v);
      oi[r] = static_cast<int>(base + i);
      if (r == k - 1) *theta = next_theta(v);
    }
    if ((i & 31) == lane) {                       // the winner's owner
      const int jw = i >> 5;
      taken |= 1ull << jw;
      switch (jw / kGroup) {
        case 0: PQ_GROUP_BEST(0) break;
        case 1: PQ_GROUP_BEST(1) break;
        case 2: PQ_GROUP_BEST(2) break;
        case 3: PQ_GROUP_BEST(3) break;
        case 4: PQ_GROUP_BEST(4) break;
        case 5: PQ_GROUP_BEST(5) break;
        case 6: PQ_GROUP_BEST(6) break;
        default: PQ_GROUP_BEST(7) break;
      }
      lane_best(gv, gj, lane, &bv, &bi);
    }
  }
}

// ---------------------------------------------------------------------
// pq_scores: block (x, y) scores query chunk y over item chunks x,
// x + gridDim.x, ...  A ring of `depth` stages keeps depth - 1 chunks in
// flight.

template <typename CT, int M>
__global__ void __launch_bounds__(kThreads, 1)
pq_scores_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char sh[];
  float* s_sh = reinterpret_cast<float*>(sh);
  unsigned char* ring = sh + a.plan.ring_off;
  const int qb = a.plan.qb, chunk = a.plan.chunk, depth = a.plan.depth;
  const int gx = gridDim.x;
  const long long n = a.n_rows;
  const int q0 = blockIdx.y * qb;
  const int nq = min(qb, a.bq - q0);
  auto issue = [&](int x, int stage) {
    const long long g0 = static_cast<long long>(x) * chunk;
    issue_chunk<CT>(a, ring + stage * a.plan.stage_bytes, g0,
                    x < a.n_chunks ? static_cast<int>(min(
                                         static_cast<long long>(chunk), n - g0))
                                   : 0);
  };
  for (int i = 0; i < depth - 1; ++i)
    issue(blockIdx.x + i * gx, i);
  stage_s(s_sh, a.s, q0, nq, qb, a.m * a.b);
  float* out = a.out_v;
  int step = 0;
  for (int x = blockIdx.x; x < a.n_chunks; x += gx, ++step) {
    cp_async_wait(depth - 2);
    __syncthreads();          // this chunk and S landed; the last chunk's
                              // reads of the stage refilled below are done
    issue(x + (depth - 1) * gx, (step + depth - 1) % depth);
    const long long g0 = static_cast<long long>(x) * chunk;
    score_chunk<CT, M>(
        a, ring + (step % depth) * a.plan.stage_bytes, s_sh, g0,
        static_cast<int>(min(static_cast<long long>(chunk), n - g0)),
        threadIdx.x, blockDim.x,
        [&](int, long long g, auto v) {
#pragma unroll
          for (int j = 0; j < lanes_of<decltype(v)>(); ++j)
            if (j < nq) __stcs(out + static_cast<long long>(q0 + j) * n + g,
                               vget(v, j));
        },
        [&](int) {});
  }
}

// ---------------------------------------------------------------------
// pq_topk_fused: block (x, y) serves query chunk y over slots x,
// x + gridDim.x, ... (strided, so sentinel slots, wherever they sit, spread
// over the blocks); a slot that is not a sentinel is a.n_chunks ring
// chunks ("steps").  Warps are specialised: the last qb warps select (warp
// kWarps - qb + q serves query q), the others score.  Slot i is scored into
// score buffer i % 2 while its queries' items at or above their predicted
// thresholds are buffered as candidates; it is selected in the next step's
// barrier interval, while the scoring warps score the next slot, so
// selection never delays scoring.

template <typename CT, int M>
__global__ void __launch_bounds__(kThreads, 1)
pq_topk_fused_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char sh[];
  float* s_sh = reinterpret_cast<float*>(sh);
  int* sc = reinterpret_cast<int*>(sh + a.plan.sc_off);   // score keys
  QueryCands* qc = reinterpret_cast<QueryCands*>(sh + a.plan.cand_off);
  int2* wcand = reinterpret_cast<int2*>(sh + a.plan.cand_off +
                                        sizeof(QueryCands));
  unsigned char* ring = sh + a.plan.ring_off;
  const int qb = a.plan.qb, chunk = a.plan.chunk, depth = a.plan.depth;
  const int tile = a.tile, gx = gridDim.x, k = a.k;
  // The fallback's lane-maximum rank: ~1.5k, so about 2k candidates reach
  // theta0 (at k = 16, ~43 of 2048 on random scores; the buffer holds 64).
  const int kq = k <= 32 ? min(32, (3 * k + 1) / 2) : k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * qb;
  const int nq = min(qb, a.bq - q0);
  const int n_score = (kWarps - qb) * 32;     // scoring threads
  // 2D table: the chunk's queries all lie in row q0 / batch_tile.
  const int* row = a.batch_tile > 0
      ? a.tile_idx + static_cast<long long>(q0 / a.batch_tile) * a.n_slots
      : a.tile_idx;
  // Steps in order: (slot, c) over the block's slots that are not
  // sentinels.  Block-uniform.
  auto advance = [&](int* slot, int* c) {
    if (*slot < 0) return;
    if (++*c < a.n_chunks) return;
    *c = 0;
    for (*slot += gx; *slot < a.n_slots; *slot += gx)
      if (row[*slot] >= 0) return;
    *slot = -1;
  };
  auto chunk_rows = [&](int slot, int c, long long* g0) {
    *g0 = static_cast<long long>(row[slot]) * tile +
          static_cast<long long>(c) * chunk;
    return min(chunk, tile - c * chunk);
  };
  int is = blockIdx.x, ic = a.n_chunks - 1;   // the next step to issue
  if (is >= a.n_slots || row[is] < 0) advance(&is, &ic);
  else ic = 0;
  auto issue = [&](int stage) {
    long long g0 = 0;
    const int len = is >= 0 ? chunk_rows(is, ic, &g0) : 0;
    issue_chunk<CT>(a, ring + stage * a.plan.stage_bytes, g0, len);
    advance(&is, &ic);
  };
  for (int i = 0; i < depth - 1; ++i) issue(i);
  stage_s(s_sh, a.s, q0, nq, qb, a.m * a.b);
  // The first two slots have no prediction (next_theta).
  for (int e = threadIdx.x; e < 2 * kMaxQB; e += blockDim.x) {
    (&qc->theta[0][0])[e] = kNoTheta;
    (&qc->count[0][0])[e] = 0;
  }
  // Select the slot scored into buffer pb: selecting warp q serves query q
  // and posts the threshold of the slot two ahead (same buffer).
  auto select = [&](int pslot, int pb, long long base) {
    const int q = warp - (kWarps - qb);
    if (q >= 0 && q < nq) {
      const long long o =
          (static_cast<long long>(q0 + q) * a.n_slots + pslot) * k;
      const int count = qc->count[pb][q];
      __syncwarp();           // every lane has read the count
      if (lane == 0) qc->count[pb][q] = 0;
      int* theta = &qc->theta[pb][q];
      if (count >= k && count <= kCandCap) {
        rank_cands(qc->cand[pb][q], count, k, min(count, 2 * k), base,
                   a.out_v + o, a.out_i + o, theta, lane);
      } else {
        select_row(sc + (static_cast<long long>(pb) * qb + q) * tile, tile,
                   k, kq, base, a.out_v + o, a.out_i + o,
                   wcand + warp * kCandCap, theta, lane);
      }
    }
  };
  int pslot = -1, pbuf = 0, buf = 0, step = 0;
  long long pbase = 0;
  for (int slot = blockIdx.x; slot < a.n_slots; slot += gx) {
    const int t_id = row[slot];
    if (t_id < 0) {           // sentinel slot: no copy, no scoring
      for (int e = threadIdx.x; e < nq * k; e += blockDim.x) {
        const long long o =
            (static_cast<long long>(q0 + e / k) * a.n_slots + slot) * k +
            e % k;
        a.out_v[o] = -INFINITY;
        a.out_i[o] = a.n_items;
      }
      continue;
    }
    for (int c = 0; c < a.n_chunks; ++c, ++step) {
      cp_async_wait(depth - 2);
      __syncthreads();        // this chunk and S landed; the last step's
                              // reads of the stage refilled below, and the
                              // pending slot's scoring, are done
      issue((step + depth - 1) % depth);
      if (c == 0 && pslot >= 0) {
        select(pslot, pbuf, pbase);   // the selecting warps only
        pslot = -1;
      }
      if (static_cast<int>(threadIdx.x) >= n_score) continue;
      const int4 th = *reinterpret_cast<const int4*>(qc->theta[buf]);
      int* cnt = qc->count[buf];
      int2(*cand)[kCandCap] = qc->cand[buf];
      long long g0;
      const int len = chunk_rows(slot, c, &g0);
      const int col0 = c * chunk;
      int* out = sc + static_cast<long long>(buf) * qb * tile + col0;
      // Score column col0 + r for query j as its key; keep it as a
      // candidate when it reaches the query's predicted threshold.
      auto put = [&](int j, int r, float x) {
        const int key = order_key(x);
        out[j * tile + r] = key;
        if (key >= vget(th, j)) {
          const int pos = atomicAdd(cnt + j, 1);
          if (pos < kCandCap) cand[j][pos] = make_int2(key, col0 + r);
        }
      };
      score_chunk<CT, M>(
          a, ring + (step % depth) * a.plan.stage_bytes, s_sh, g0, len,
          threadIdx.x, n_score,
          [&](int r, long long, auto v) {
#pragma unroll
            for (int j = 0; j < lanes_of<decltype(v)>(); ++j)
              put(j, r, vget(v, j));
          },
          [&](int r) {
#pragma unroll
            for (int j = 0; j < kMaxQB; ++j)
              if (j < qb) put(j, r, -INFINITY);
          });
    }
    pslot = slot;
    pbuf = buf;
    pbase = static_cast<long long>(t_id) * tile;
    buf ^= 1;
  }
  __syncthreads();            // the pending slot's scoring is done
  if (pslot >= 0) select(pslot, pbuf, pbase);
}

// ---------------------------------------------------------------------
// Launch.  Threads may launch one instance at once, at different plans
// (QB 4/2/1, with or without live bytes: different shared-memory sizes).
// So the instance's dynamic shared-memory limit is raised once, to all the
// device allows a block, and never lowered, and the occupancy is read once
// per shared-memory size into a small table; both under the instance's
// mutex.  The launch itself runs outside it.

struct LaunchCache {
  std::mutex mu;
  bool limit_set = false;
  int n = 0;
  int smem[kCacheSizes];
  int blocks[kCacheSizes];    // resident blocks on the device at smem[i]
};

template <typename K>
int resident_blocks(K kernel, LaunchCache* cache, int smem, int* blocks) {
  std::lock_guard<std::mutex> lock(cache->mu);
  for (int i = 0; i < cache->n; ++i)
    if (cache->smem[i] == smem) {
      *blocks = cache->blocks[i];
      return 0;
    }
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !cache->limit_set) {
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - static_cast<int>(attr.sharedSizeBytes));
    if (err == cudaSuccess) cache->limit_set = true;
  }
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = sms * per_sm;
  if (cache->n < kCacheSizes) {
    cache->smem[cache->n] = smem;
    cache->blocks[cache->n] = *blocks;
    ++cache->n;
  }
  return 0;
}

// Grid: y = the query chunks; x = as many blocks as one resident wave
// holds per query chunk (rounded down, so no block waits for a second
// wave), never more than `work` (slots or item chunks).
template <typename K>
int launch(K kernel, LaunchCache* cache, const Args& a, int work,
           cudaStream_t stream) {
  int blocks = 0;
  const int rc = resident_blocks(kernel, cache, a.plan.smem, &blocks);
  if (rc != 0) return rc;
  const int ny = (a.bq + a.plan.qb - 1) / a.plan.qb;
  if (ny > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  int gx = blocks / ny;
  gx = gx < 1 ? 1 : (gx > work ? work : gx);
  kernel<<<dim3(gx, ny), kThreads, a.plan.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename CT, int M>
int launch_scores(const Args& a, cudaStream_t stream) {
  static LaunchCache cache;
  return launch(pq_scores_kernel<CT, M>, &cache, a, a.n_chunks, stream);
}

template <typename CT, int M>
int launch_topk(const Args& a, cudaStream_t stream) {
  static LaunchCache cache;
  return launch(pq_topk_fused_kernel<CT, M>, &cache, a, a.n_slots, stream);
}

// Dispatch on (code type, m): one instance per width the configs use (2, 4,
// 6, 8) and a generic one for every other m <= kMaxM.
#define PQ_WIDTHS(FN, CT)                                                 \
  switch (a.m) {                                                          \
    case 2: return FN<CT, 2>(a, stream);                                  \
    case 4: return FN<CT, 4>(a, stream);                                  \
    case 6: return FN<CT, 6>(a, stream);                                  \
    case 8: return FN<CT, 8>(a, stream);                                  \
    default: return FN<CT, 0>(a, stream);                                 \
  }
#define PQ_DISPATCH(FN)                                                   \
  switch (code_type) {                                                    \
    case kInt8: PQ_WIDTHS(FN, int8_t)                                     \
    case kUint8: PQ_WIDTHS(FN, uint8_t)                                   \
    case kInt16: PQ_WIDTHS(FN, int16_t)                                   \
    case kUint16: PQ_WIDTHS(FN, uint16_t)                                 \
    case kInt32: PQ_WIDTHS(FN, int32_t)                                   \
    default: return static_cast<int>(cudaErrorInvalidValue);              \
  }

bool plan_ok(const Plan& p, bool fused) {
  return (p.qb == 1 || p.qb == 2 || p.qb == 4) && p.chunk >= 1 &&
         p.depth >= 2 && p.depth <= kMaxDepth && p.threads == kThreads &&
         p.smem > 0 && p.stage_bytes > 0 && p.ring_off % 16 == 0 &&
         p.stage_bytes % 16 == 0 && p.live_off % 16 == 0 &&
         (!fused || p.ring_off - p.cand_off >=
                        static_cast<int>(sizeof(QueryCands)) +
                            kWarps * kCandCap * 8);
}

}  // namespace

extern "C" {

int pq_scores_launch(const void* codes, int code_type, const void* s,
                     void* out, int n, int m, int b, int bq, const Plan* plan,
                     void* stream_) {
  if (m < 1 || m > kMaxM || n < 1 || bq < 1 || !plan || !plan_ok(*plan, false))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.codes = codes;
  a.s = static_cast<const float*>(s);
  a.out_v = static_cast<float*>(out);
  a.n_rows = a.n_items = n;
  a.m = m;
  a.b = b;
  a.bq = bq;
  a.plan = *plan;
  a.n_chunks = (n + plan->chunk - 1) / plan->chunk;
  a.vec = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  PQ_DISPATCH(launch_scores)
}

// batch_tile == 0: tile_idx is 1D (n_slots,); batch_tile > 0: tile_idx is
// 2D (ceil(bq / batch_tile), n_slots), row j serving queries
// j * batch_tile .. (j + 1) * batch_tile - 1, and plan->qb divides
// batch_tile.  live: null, or (n_rows,) bytes, 0 = dead row.
int pq_topk_fused_launch(const void* codes, int code_type, const void* s,
                         const void* tile_idx, const void* live, void* out_v,
                         void* out_i, int n_rows, int n_items, int m, int b,
                         int bq, int n_slots, int tile, int k, int batch_tile,
                         const Plan* plan, void* stream_) {
  if (m < 1 || m > kMaxM || tile < 1 || tile > 32 * kLaneCols || k < 1 ||
      k > tile || batch_tile < 0 || bq < 1 || n_slots < 1 || !plan ||
      !plan_ok(*plan, true) || (batch_tile > 0 && batch_tile % plan->qb))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.codes = codes;
  a.s = static_cast<const float*>(s);
  a.tile_idx = static_cast<const int*>(tile_idx);
  a.live = static_cast<const uint8_t*>(live);
  a.out_v = static_cast<float*>(out_v);
  a.out_i = static_cast<int*>(out_i);
  a.n_rows = n_rows;
  a.n_items = n_items;
  a.m = m;
  a.b = b;
  a.bq = bq;
  a.n_slots = n_slots;
  a.tile = tile;
  a.k = k;
  a.batch_tile = batch_tile;
  a.plan = *plan;
  a.n_chunks = (tile + plan->chunk - 1) / plan->chunk;
  a.vec = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  PQ_DISPATCH(launch_topk)
}

}  // extern "C"
