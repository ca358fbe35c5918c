// Embedding-bag kernel for Hopper (sm_90a), bound to Python with ctypes.
//
// embedding_bag_kernel replaces the TPU kernel
//   src/repro/kernels/embedding_bag/kernel.py: embedding_bag_kernel
//   (launched by embedding_bag_call, wrapped by ops.embedding_bag).
//   out[b, :] = sum_j w[b, j] * table[max(idx[b, j], 0), :]      (sum)
//   mean divides that by max(sum_j w[b, j], 1): the weight sum, not the
//   count, so an all-padding bag gives 0.  The caller has folded the
//   padding mask into w (w = 0 where idx = -1); a padded slot still reads
//   row 0 and multiplies it by 0, as the reference does, so a NaN in row 0
//   propagates the same way.  Indices lie in [-1, V); they are not checked.
//
//   Bound: bytes.  The least traffic reads each distinct row once (row 0
//   too where a slot is padding), each index, each weight where the bag
//   is weighted (an unweighted bag's mask follows from its indices), and
//   writes each bag's d-wide row.  For BST's serve_bulk batch (262,144
//   bags of 20 uniform ids over 4,000,000 rows of 32 floats) that is
//   2,922,064 distinct rows, 429 MB, against 2 * n_bags * bag * d flops:
//   far below the card's balance point.  This kernel reads one row and
//   one folded weight per slot (5,242,880 rows, 671 MB of them), and a
//   row that another bag read earlier comes again from HBM unless L2
//   still holds it, so it moves more than the bound counts.
//
//   The TPU kernel issues one row DMA per slot from HBM into VMEM scratch
//   for 8 bags a grid step, waits on them all, then reduces the block on
//   the VPU.  On the card there is nothing to stage: one warp owns one
//   bag, lane c owns columns c, c + 32, ... and keeps their sums in a
//   register, and the loop over the bag's slots runs in order, so the
//   row reads of many warps in flight hide the memory latency.  Rows of
//   10, 16 or 18 floats (40-72 bytes) are not 16-byte aligned, so the
//   loads are scalar; a row is one contiguous, coalesced read per warp.
//
// Exactness: acc = __fadd_rn(acc, __fmul_rn(w, x)) in slot order, and the
// weight sum in the same order, so nvcc cannot contract into FMA; the build
// uses no fast-math flags and the division is IEEE.  The plain version
// (ref.py) takes the same steps, so the two agree bit for bit.  The mean's
// clamp keeps a NaN weight sum (as torch.clamp and jnp.maximum do) where
// fmaxf would drop it.  Row offsets are 64-bit: Criteo's largest table has
// 10,131,227 rows.  The C entry returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void embedding_bag_kernel(const float* __restrict__ table,
                                     const int32_t* __restrict__ idx,
                                     const float* __restrict__ w,
                                     float* __restrict__ out, int n_bags,
                                     int bag, int d, int mean) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= n_bags) return;
  const int32_t* ib = idx + b * bag;
  const float* wb = w + b * bag;
  float* ob = out + b * d;
  for (int c = lane; c < d; c += 32) {
    float acc = 0.0f;
    float den = 0.0f;
    for (int j = 0; j < bag; ++j) {
      const int32_t raw = __ldg(ib + j);
      const float wj = __ldg(wb + j);
      const int64_t row = raw > 0 ? raw : 0;
      acc = __fadd_rn(acc, __fmul_rn(wj, __ldg(table + row * d + c)));
      den = __fadd_rn(den, wj);
    }
    if (mean) acc = acc / (den < 1.0f ? 1.0f : den);
    ob[c] = acc;
  }
}

}  // namespace

extern "C" {

// table (v, d) f32; idx (n_bags, bag) int32 in [-1, v); w (n_bags, bag)
// f32 with the padding mask folded in; out (n_bags, d) f32.  mean: 0 for
// the weighted sum, 1 for the weight-sum mean.
int embedding_bag_launch(const void* table, const void* idx, const void* w,
                         void* out, int n_bags, int bag, int d, int mean,
                         void* stream) {
  if (n_bags < 0 || bag < 0 || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_bags == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  embedding_bag_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<float*>(out), n_bags, bag, d,
      mean);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
