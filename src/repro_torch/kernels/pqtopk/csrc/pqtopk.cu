// PQTopK scoring kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// pq_scores_kernel replaces the TPU kernel
//   src/repro/kernels/pqtopk/kernel.py: pq_scores_kernel / _tile_scores
//   (launched by pq_scores_call).
//   r[q, i] = sum_k S[q, k, codes[i, k]]  ->  (B, N) f32.
//   Bound: bytes.  It reads N*m codes and writes B*N f32 scores (325 MB at
//   N=1,271,638, B=64), so HBM rate bounds it.  Design: one resident wave
//   of blocks; a block stages S for a chunk of queries in shared memory
//   once (m*b*4 bytes per query) and strides over the items; each thread
//   reads one item's m codes once and gathers them for every query of the
//   chunk; consecutive threads write consecutive items, so the score
//   writes coalesce.
//
// pq_topk_fused_kernel replaces the TPU kernel
//   src/repro/kernels/pqtopk/kernel.py: pq_topk_fused_kernel / _tile_topk
//   (launched by pq_topk_fused_call) in all four of its forms:
//   (a) a 1D identity tile_idx (the exhaustive pqtopk_fused route);
//   (b) a 1D compacted tile_idx with -1 sentinel slots at its tail (the
//       batch-any pqtopk_pruned route, kernel.py:170-173);
//   (c) a 2D (n_batch_tiles, n_slots) table (the grouped pqtopk_pruned
//       route, kernel.py:156-159): query q's slot i scores tile
//       tile_idx[(q / batch_tile) * n_slots + i];
//   (d) any of these with the `live` tombstone mask (the mutable
//       catalogue, kernel.py:148-155, :183-186, :279-285).  The TPU streams
//       an (N/tile, tile) int8 block beside each codes tile under the same
//       clamped index map; here `live` is a flat (n_rows,) byte array and
//       the thread that scores item g reads live[g] (1 byte beside the
//       item's m codes), so a dead item scores -inf inside the tile top-k.
//       A null pointer means no mask.
//   Per (item-tile slot, query chunk): score the tile into shared memory,
//   mask ids >= n_items (and dead rows) to -inf, write the tile's exact
//   top-K per query with global ids, ties to the lowest id; a slot whose
//   tile_idx is -1 writes (-inf, n_items).  Output (B, n_slots, K) f32 + i32; the cross-slot merge
//   is left to the caller.  In the 2D form a query chunk never straddles two
//   rows (its size divides batch_tile), so a block reads one row.
//   Bound: operations.  It reads N*m codes (once per query chunk, mostly
//   from L2) and writes only B*n_slots*K candidates, so bytes bound it far
//   less than its B*N*(m-1) f32 adds; in practice the B*N*m shared-memory
//   gathers from the staged S table and the K selection rounds are the
//   work.  Design: one resident wave of blocks, each staging S for its
//   query chunk once and striding over the slots; a tile's scores never
//   leave shared memory; one warp per query then takes K rounds of a warp
//   arg-max over the tile, each lane holding its 64 columns in registers
//   with the best of each group of 8 cached, so taking a column rescans
//   only its group.  For (b) and (c) the work is data-dependent: the bound
//   counts only the scored (slot, query) pairs, pairs_scored x tile x m
//   shared-memory lookups of S (sentinel slots exit at once).  Form (d)
//   adds one byte per scored item to its m code bytes, and no lookups.
//
// Both kernels reduce the m per-split partials in exactly the reference's
// tree_sum order (pairs, odd tail appended), and the build uses no fast-math
// flags, so the results are bit-identical to the plain versions.  Every C
// entry returns cudaGetLastError() (or the first error seen) as an int.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 64;            // largest m the generic path takes
constexpr int kThreads = 256;
constexpr int kLaneCols = 64;        // tile <= 2048 = 32 lanes x 64 columns
constexpr int kGroup = 8;            // arg-max: columns per cached group
constexpr int kGroups = kLaneCols / kGroup;   // 8, as PQ_GROUP_BEST spells out

enum CodeType { kInt8 = 0, kUint8 = 1, kInt16 = 2, kUint16 = 3, kInt32 = 4 };

// Balanced-tree sum of parts[0..m) in the reference's tree_sum order.
// With M > 0 every loop has a constant trip count and the parts stay in
// registers; M == 0 takes m at run time.
template <int M>
__device__ __forceinline__ float tree_sum(float* parts, int m_rt) {
  int n = M > 0 ? M : m_rt;
#pragma unroll
  for (int level = 0; level < 7; ++level) {   // 2^6 = kMaxM
    if (n > 1) {
      const int h = n >> 1;
#pragma unroll
      for (int i = 0; i < (M > 0 ? M / 2 : kMaxM / 2); ++i) {
        if (i < h) parts[i] = parts[2 * i] + parts[2 * i + 1];
      }
      if (n & 1) {
        parts[h] = parts[n - 1];
        n = h + 1;
      } else {
        n = h;
      }
    }
  }
  return parts[0];
}

template <typename CT, int M>
__device__ __forceinline__ void load_codes(const CT* __restrict__ codes,
                                           long long row, int m, int* c) {
  const CT* p = codes + row * m;
#pragma unroll
  for (int k = 0; k < (M > 0 ? M : kMaxM); ++k) {
    if (M > 0 || k < m) c[k] = static_cast<int>(p[k]);
  }
}

template <int M>
__device__ __forceinline__ float score_one(const float* __restrict__ s_q,
                                           const int* c, int m, int b) {
  float parts[M > 0 ? M : kMaxM];
#pragma unroll
  for (int k = 0; k < (M > 0 ? M : kMaxM); ++k) {
    if (M > 0 || k < m) parts[k] = s_q[k * b + c[k]];
  }
  return tree_sum<M>(parts, m);
}

__device__ __forceinline__ void stage_s(float* s_sh, const float* __restrict__ s,
                                        int q0, int nq, int per_q) {
  const float* src = s + static_cast<long long>(q0) * per_q;
  for (int i = threadIdx.x; i < nq * per_q; i += blockDim.x) s_sh[i] = src[i];
}

template <typename CT, int M>
__global__ void __launch_bounds__(kThreads)
pq_scores_kernel(const CT* __restrict__ codes, const float* __restrict__ s,
                 float* __restrict__ out, int n, int m_rt, int b, int bq,
                 int qb) {
  extern __shared__ float s_sh[];                     // (qb, m, b)
  const int m = M > 0 ? M : m_rt;
  const int q0 = blockIdx.y * qb;
  const int nq = min(qb, bq - q0);
  stage_s(s_sh, s, q0, nq, m * b);
  __syncthreads();
  // Resident blocks: S is staged once and the block strides over items.
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long item = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
       item < n; item += stride) {
    int c[M > 0 ? M : kMaxM];
    load_codes<CT, M>(codes, item, m, c);
    for (int q = 0; q < nq; ++q) {
      out[static_cast<long long>(q0 + q) * n + item] =
          score_one<M>(s_sh + q * m * b, c, m, b);
    }
  }
}

// a beats b: larger value, or equal value and lower column.
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// A lane's columns lane + 32 j live in registers, in kGroups groups of
// kGroup consecutive j, with each group's best not-yet-taken (value, j)
// cached in gv/gj, so taking a column rescans only its group (8 compares,
// not 64).  j ascends within and across groups and only a strictly larger
// value displaces the current best, so ties go to the lowest column; j ==
// -1 marks an exhausted group.  A macro with a literal group index keeps
// every array access compile-time, so nothing leaves the registers.
#define PQ_GROUP_BEST(G)                                                  \
  {                                                                       \
    float v_ = -INFINITY;                                                 \
    int j_ = -1;                                                          \
    _Pragma("unroll") for (int jj = 0; jj < kGroup; ++jj) {               \
      const int j = (G) * kGroup + jj;                                    \
      if (!((taken >> j) & 1ull) && (j_ < 0 || vals[j] > v_)) {           \
        v_ = vals[j];                                                     \
        j_ = j;                                                           \
      }                                                                   \
    }                                                                     \
    gv[G] = v_;                                                           \
    gj[G] = j_;                                                           \
  }

// The lane's best over its group bests -> (value, column); an exhausted
// lane offers (-inf, INT_MAX), which loses every tie.
__device__ __forceinline__ void lane_best(const float (&gv)[kGroups],
                                          const int (&gj)[kGroups], int lane,
                                          float* bv, int* bi) {
  float v = -INFINITY;
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

template <typename CT, int M>
__global__ void __launch_bounds__(kThreads)
pq_topk_fused_kernel(const CT* __restrict__ codes, const float* __restrict__ s,
                     const int* __restrict__ tile_idx,
                     const uint8_t* __restrict__ live,
                     float* __restrict__ out_v, int* __restrict__ out_i,
                     int n_rows, int n_items, int m_rt, int b, int bq,
                     int n_slots, int tile, int k, int qb, int batch_tile) {
  extern __shared__ float sh[];
  const int m = M > 0 ? M : m_rt;
  float* s_sh = sh;                                   // (qb, m, b)
  float* sc = sh + qb * m * b;                        // (qb, tile)
  const int q0 = blockIdx.y * qb;
  const int nq = min(qb, bq - q0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // This lane's columns lane + 32 j < tile; those past the tile never
  // exist: mark them taken up front.
  const int n_cols = tile > lane ? (tile - lane + 31) >> 5 : 0;
  const unsigned long long absent =
      n_cols >= kLaneCols ? 0ull : (~0ull << n_cols);
  // 2D table: the chunk's queries all lie in row q0 / batch_tile.
  const int* row_idx =
      batch_tile > 0
          ? tile_idx + static_cast<long long>(q0 / batch_tile) * n_slots
          : tile_idx;
  stage_s(s_sh, s, q0, nq, m * b);
  // Resident blocks: S is staged once and the block strides over slots.
  for (int slot = blockIdx.x; slot < n_slots; slot += gridDim.x) {
    const int t_id = row_idx[slot];                   // block-uniform
    if (t_id < 0) {                                   // sentinel slot
      for (int e = threadIdx.x; e < nq * k; e += blockDim.x) {
        const long long o =
            (static_cast<long long>(q0 + e / k) * n_slots + slot) * k + e % k;
        out_v[o] = -INFINITY;
        out_i[o] = n_items;
      }
      continue;
    }
    __syncthreads();      // S staged / the previous tile's scores consumed
    const long long base = static_cast<long long>(t_id) * tile;
    for (int t = threadIdx.x; t < tile; t += blockDim.x) {
      const long long g = base + t;
      if (g >= n_items || g >= n_rows || (live && !live[g])) {
        for (int q = 0; q < nq; ++q) sc[q * tile + t] = -INFINITY;
        continue;
      }
      int c[M > 0 ? M : kMaxM];
      load_codes<CT, M>(codes, g, m, c);
      for (int q = 0; q < nq; ++q) {
        sc[q * tile + t] = score_one<M>(s_sh + q * m * b, c, m, b);
      }
    }
    __syncthreads();
    for (int q = warp; q < nq; q += blockDim.x >> 5) {
      const float* row = sc + q * tile;
      float vals[kLaneCols];
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        vals[j] = j < n_cols ? row[lane + 32 * j] : -INFINITY;
      }
      unsigned long long taken = absent;
      float gv[kGroups];
      int gj[kGroups];
      PQ_GROUP_BEST(0) PQ_GROUP_BEST(1) PQ_GROUP_BEST(2) PQ_GROUP_BEST(3)
      PQ_GROUP_BEST(4) PQ_GROUP_BEST(5) PQ_GROUP_BEST(6) PQ_GROUP_BEST(7)
      float bv;
      int bi;
      lane_best(gv, gj, lane, &bv, &bi);
      float* ov = out_v + (static_cast<long long>(q0 + q) * n_slots + slot) * k;
      int* oi = out_i + (static_cast<long long>(q0 + q) * n_slots + slot) * k;
      for (int r = 0; r < k; ++r) {
        float v = bv;
        int i = bi;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
          const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
          if (beats(v2, i2, v, i)) {
            v = v2;
            i = i2;
          }
        }
        if (lane == 0) {
          ov[r] = v;
          oi[r] = static_cast<int>(base + i);
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
  }
}

int qb_for(int per_query_bytes, int bq, int budget) {
  int qb = budget / per_query_bytes;
  qb = qb < 1 ? 1 : (qb > 8 ? 8 : qb);
  return qb < bq ? qb : bq;
}

// Blocks along x for a resident grid: at most one wave of (SMs x blocks
// per SM) split over the `ny` query chunks (rounded down, so no block waits
// for a second wave), never more than `work` items of x.
template <typename K>
int resident_x(K kernel, size_t smem, int ny, long long work, int* gx) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long x = static_cast<long long>(sms) * per_sm / ny;
  x = x < work ? x : work;
  *gx = static_cast<int>(x < 1 ? 1 : x);
  return 0;
}

template <typename CT, int M>
int launch_scores(const void* codes, const float* s, float* out, int n, int m,
                  int b, int bq, cudaStream_t stream) {
  const int qb = qb_for(m * b * 4, bq, 96 * 1024);
  const size_t smem = static_cast<size_t>(qb) * m * b * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pq_scores_kernel<CT, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ny = (bq + qb - 1) / qb;
  int gx = 1;
  const int rc = resident_x(pq_scores_kernel<CT, M>, smem, ny,
                            (n + kThreads - 1) / kThreads, &gx);
  if (rc != 0) return rc;
  pq_scores_kernel<CT, M><<<dim3(gx, ny), kThreads, smem, stream>>>(
      static_cast<const CT*>(codes), s, out, n, m, b, bq, qb);
  return static_cast<int>(cudaGetLastError());
}

template <typename CT, int M>
int launch_topk(const void* codes, const float* s, const int* tile_idx,
                const uint8_t* live, float* out_v, int* out_i, int n_rows,
                int n_items, int m, int b, int bq, int n_slots, int tile,
                int k, int batch_tile, cudaStream_t stream) {
  int qb = qb_for((m * b + tile) * 4, bq, 100 * 1024);
  if (batch_tile > 0) {            // 2D: a chunk must not straddle two rows
    qb = qb < batch_tile ? qb : batch_tile;
    while (batch_tile % qb) --qb;
  }
  const size_t smem =
      static_cast<size_t>(qb) * (m * b + tile) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pq_topk_fused_kernel<CT, M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ny = (bq + qb - 1) / qb;
  int gx = 1;
  const int rc = resident_x(pq_topk_fused_kernel<CT, M>, smem, ny, n_slots,
                            &gx);
  if (rc != 0) return rc;
  pq_topk_fused_kernel<CT, M><<<dim3(gx, ny), kThreads, smem, stream>>>(
      static_cast<const CT*>(codes), s, tile_idx, live, out_v, out_i, n_rows,
      n_items, m, b, bq, n_slots, tile, k, qb, batch_tile);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on (code type, m): m == 8 is the configs' width and gets a
// specialised body; every other m <= kMaxM takes the generic one.
#define PQ_DISPATCH(FN, ...)                                              \
  switch (code_type) {                                                    \
    case kInt8:                                                           \
      return m == 8 ? FN<int8_t, 8>(__VA_ARGS__) : FN<int8_t, 0>(__VA_ARGS__); \
    case kUint8:                                                          \
      return m == 8 ? FN<uint8_t, 8>(__VA_ARGS__) : FN<uint8_t, 0>(__VA_ARGS__); \
    case kInt16:                                                          \
      return m == 8 ? FN<int16_t, 8>(__VA_ARGS__) : FN<int16_t, 0>(__VA_ARGS__); \
    case kUint16:                                                         \
      return m == 8 ? FN<uint16_t, 8>(__VA_ARGS__) : FN<uint16_t, 0>(__VA_ARGS__); \
    case kInt32:                                                          \
      return m == 8 ? FN<int32_t, 8>(__VA_ARGS__) : FN<int32_t, 0>(__VA_ARGS__); \
    default:                                                              \
      return static_cast<int>(cudaErrorInvalidValue);                     \
  }

}  // namespace

extern "C" {

// Largest dynamic shared memory the launches above will ask for, per
// kernel, so the Python wrapper can refuse shapes before launching.
int pq_smem_bytes(int which, int m, int b, int bq, int tile) {
  if (which == 0) {
    return qb_for(m * b * 4, bq, 96 * 1024) * m * b * 4;
  }
  return qb_for((m * b + tile) * 4, bq, 100 * 1024) * (m * b + tile) * 4;
}

int pq_scores_launch(const void* codes, int code_type, const void* s,
                     void* out, int n, int m, int b, int bq, void* stream) {
  if (m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  PQ_DISPATCH(launch_scores, codes, static_cast<const float*>(s),
              static_cast<float*>(out), n, m, b, bq,
              static_cast<cudaStream_t>(stream))
}

// batch_tile == 0: tile_idx is 1D (n_slots,); batch_tile > 0: tile_idx is
// 2D (ceil(bq / batch_tile), n_slots), row j serving queries
// j * batch_tile .. (j + 1) * batch_tile - 1.  live: null, or (n_rows,)
// bytes, 0 = dead row.
int pq_topk_fused_launch(const void* codes, int code_type, const void* s,
                         const void* tile_idx, const void* live, void* out_v,
                         void* out_i, int n_rows, int n_items, int m, int b,
                         int bq, int n_slots, int tile, int k, int batch_tile,
                         void* stream) {
  if (m < 1 || m > kMaxM || tile < 1 || tile > 32 * kLaneCols || k < 1 ||
      k > tile || batch_tile < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PQ_DISPATCH(launch_topk, codes, static_cast<const float*>(s),
              static_cast<const int*>(tile_idx),
              static_cast<const uint8_t*>(live), static_cast<float*>(out_v),
              static_cast<int*>(out_i), n_rows, n_items, m, b, bq, n_slots,
              tile, k, batch_tile, static_cast<cudaStream_t>(stream))
}

}  // extern "C"
