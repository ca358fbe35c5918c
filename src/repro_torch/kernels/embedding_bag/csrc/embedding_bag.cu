// Embedding-bag kernel for Hopper (sm_90a), bound to Python with ctypes.
//
// embedding_bag_kernel replaces the TPU kernel
//   src/repro/kernels/embedding_bag/kernel.py: embedding_bag_kernel
//   (launched by embedding_bag_call, wrapped by ops.embedding_bag).
//   out[b, :] = sum_j w[b, j] * table[max(idx[b, j], 0), :]      (sum)
//   with w[b, j] = weights[b, j] * (idx[b, j] >= 0), or the mask alone for
//   an unweighted bag; mean divides that by max(sum_j w[b, j], 1): the
//   weight sum, not the count, so an all-padding bag gives 0.  A padded
//   slot still reads row 0 and multiplies it by 0, as the reference does,
//   so a NaN or inf in row 0 propagates the same way.  Indices lie in
//   [-1, V); they are not checked.
//
//   Bound: bytes.  The least traffic reads each distinct row once (row 0
//   too where a slot is padding), each index, each weight where the bag
//   is weighted (an unweighted bag's mask follows from its indices), and
//   writes each bag's d-wide row.  For BST's serve_bulk batch (262,144
//   bags of 20 uniform ids over 4,000,000 rows of 32 floats) that is
//   2,922,064 distinct rows, 429 MB, against 2 * n_bags * bag * d flops:
//   far below the card's balance point.  This kernel reads one row per
//   slot (5,242,880 rows, 671 MB, 726 MB in all with the indices and the
//   output: 0.217 ms at 3.35 TB/s); only a pass that deduplicates the
//   batch's rows could read each distinct row once.
//
//   The TPU kernel issues one row DMA per slot from HBM into VMEM scratch
//   for 8 bags a grid step, waits on them all, then reduces the block on
//   the VPU.  On the card the rows go straight to registers, and what
//   decides the speed is how well the random row reads use HBM: enough of
//   them in flight (Little's law: ~20 KB per SM at HBM latency), in as few
//   and as wide load instructions as the row allows.  So:
//   * Where d % 4 == 0 (and the table is 16-byte aligned) a lane of a
//     large batch loads 4 floats at once; else 1.  A group of L lanes owns
//     one bag, L = the row's vectors (at least 4, at most 32), lane c of
//     the group holding vector c (a row of more than 32 vectors takes
//     one pass over the bag per 32); a warp packs 32 / L bags:
//     4 bags of 32 floats at BST's serve_bulk, 3 of 10 (FM), so few lanes
//     idle and one load instruction reads up to 8 rows.  A batch that
//     fits one wave of warps (no more bags than the device holds
//     resident warps, 8,192 on an H100 SXM; d <= 32: BST's serve_p99,
//     DCN-v2's 4,096 bags) is bound by latency instead and takes 1-float
//     loads, which spread it over 4x the warps.
//   * The group reads its bag's indices (and weights, where weighted)
//     once, L slots at a time, lane j holding slot j, and folds the
//     padding mask there; __shfl_sync hands each slot's row index and
//     weight to the lanes that need them.  An unweighted bag reads no
//     weights, and the caller folds nothing.
//   * Each lane issues the row loads of 8 slots before the first of their
//     adds.
//   On an H100 (700 W) at BST's serve_bulk the random 128-byte reads
//   saturate HBM near 3 TB/s: 4 slots in flight per lane were no faster
//   than 8, and 1-float loads (4 to 16 slots in flight) 3-20% slower
//   (PERF.md, PR 16).
//
// Exactness: acc = __fadd_rn(acc, __fmul_rn(w, x)) in slot order, and the
// weight sum in the same order, so nvcc cannot contract into FMA; the fold
// is __fmul_rn(weight, mask), as the plain version's product; the build
// uses no fast-math flags and the division is IEEE.  The plain version
// (ref.py) takes the same steps, so the two agree bit for bit.  The mean's
// clamp keeps a NaN weight sum (as torch.clamp and jnp.maximum do) where
// fmaxf would drop it.  Row offsets are 64-bit: Criteo's largest table has
// 10,131,227 rows.  The C entry returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 8;           // slots whose row loads go together
constexpr int kMaxDevices = 64;      // devices whose wave size is cached

// Lanes per bag for rows of n_vec vectors: a whole warp past 16, else
// max(n_vec, 4), 32 / L bags a warp.
__host__ __device__ constexpr int lanes_per_bag(int n_vec) {
  return n_vec > 16 ? 32 : (n_vec < 4 ? 4 : n_vec);
}

template <int V> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float& at(T& v, int) { return v; }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float& at(T& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};

// V floats a load (4: rows 16-byte aligned), one vector a lane a pass: a
// row of more than 32 vectors takes several passes over the bag, each
// adding its columns in slot order, so every column's sum is the same.
template <int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ weights,
                     float* __restrict__ out, int n_bags, int bag, int d,
                     int mean) {
  using VT = typename Vec<V>::T;
  const int L = lanes_per_bag(d / V);
  const int per_warp = 32 / L;
  const int lane = threadIdx.x & 31;
  const int g = lane / L, li = lane - g * L;      // group, lane in group
  const int64_t b =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5))
          * per_warp + g;
  // Every lane runs the loops below (the shuffles need the whole warp);
  // lanes of no bag load nothing and store nothing.
  const bool own = g < per_warp && b < n_bags;
  const int32_t* ib = idx + b * bag;
  const float* wb = weights ? weights + b * bag : nullptr;
  const int src0 = g * L;
  for (int cb = 0; cb < d; cb += L * V) {        // one pass unless d > 32 V
    const int c = cb + li * V;
    VT acc = Vec<V>::zero();
    float den = 0.0f;
    for (int j0 = 0; j0 < bag; j0 += L) {
      const int n_here = min(L, bag - j0);
      int raw = 0;
      float wf = 0.0f;
      if (own && li < n_here) {
        raw = __ldg(ib + j0 + li);
        const float mask = raw >= 0 ? 1.0f : 0.0f;
        wf = wb ? __fmul_rn(__ldg(wb + j0 + li), mask) : mask;
      }
      for (int u0 = 0; u0 < n_here; u0 += kUnroll) {
        VT x[kUnroll];
        float wu[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = __shfl_sync(kFull, raw, src0 + u0 + u);
          wu[u] = __shfl_sync(kFull, wf, src0 + u0 + u);
          const float* row = table + static_cast<int64_t>(r > 0 ? r : 0) * d;
          x[u] = own && u0 + u < n_here && c < d ? Vec<V>::load(row + c)
                                                 : Vec<V>::zero();
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (u0 + u < n_here) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
              float& a = Vec<V>::at(acc, j);
              a = __fadd_rn(a, __fmul_rn(wu[u], Vec<V>::at(x[u], j)));
            }
            den = __fadd_rn(den, wu[u]);
          }
        }
      }
    }
    if (own && c < d) {
      if (mean) {
        const float q = den < 1.0f ? 1.0f : den;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float& a = Vec<V>::at(acc, j);
          a = a / q;
        }
      }
      *reinterpret_cast<VT*>(out + b * d + c) = acc;
    }
  }
}

template <int V>
void launch(const float* table, const int32_t* idx, const float* w,
            float* out, int n_bags, int bag, int d, int mean,
            cudaStream_t stream) {
  const int per_block = kWarpsPerBlock * (32 / lanes_per_bag(d / V));
  const int blocks = static_cast<int>(
      (static_cast<int64_t>(n_bags) + per_block - 1) / per_block);
  embedding_bag_kernel<V><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      table, idx, w, out, n_bags, bag, d, mean);
}

// Warps one wave of the current device holds (its SMs x the most warps an
// SM keeps resident: 132 x 64 = 8,192 on an H100 SXM), read once per
// device.  Returns a CUDA error code.
int wave_warps(int* warps) {
  static int cache[kMaxDevices];      // 0: not read yet
  int dev = 0, sms = 0, threads = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && cache[dev] > 0) {
    *warps = cache[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *warps = sms * (threads / 32);
  if (dev < kMaxDevices) cache[dev] = *warps;
  return 0;
}

}  // namespace

extern "C" {

// table (v, d) f32; idx (n_bags, bag) int32 in [-1, v); w (n_bags, bag)
// f32 weights, or null for an unweighted bag (the padding mask is applied
// here either way); out (n_bags, d) f32.  mean: 0 for the weighted sum, 1
// for the weight-sum mean.
int embedding_bag_launch(const void* table, const void* idx, const void* w,
                         void* out, int n_bags, int bag, int d, int mean,
                         void* stream) {
  if (n_bags < 0 || bag < 0 || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_bags == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  const float* t = static_cast<const float*>(table);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // A batch of no more bags than one wave holds warps is bound by latency,
  // not by HBM: with d <= 32 it takes scalar loads, which spread it over
  // more warps.
  int wave = 0;
  const int rc = wave_warps(&wave);
  if (rc != 0) return rc;
  if (d % 4 == 0 && !(n_bags <= wave && d <= 32) &&
      (reinterpret_cast<uintptr_t>(t) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(o) & 15) == 0)
    launch<4>(t, i, wf, o, n_bags, bag, d, mean, s);
  else
    launch<1>(t, i, wf, o, n_bags, bag, d, mean, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
