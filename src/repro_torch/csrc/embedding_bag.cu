// EmbeddingBag for Hopper (sm_90a): out[b] = sum_j w[b,j] * table[idx[b,j]].
//
// Replaces the TPU kernel repro/kernels/embedding_bag/embedding_bag.py:embedding_bag
// (Pallas, `_kernel`): there the ids and weights are scalar-prefetched and a
// sequential grid of B*nnz steps DMAs one [1, d] row into a VMEM-resident
// bag accumulator per step. Hopper's blocks run in parallel and in no order,
// so that design is not carried over.
//
// What bounds it: bytes. A call reads B*nnz ids (4 B each), B*nnz weights
// (4 B each, none when `w` is null) and B*nnz rows of 4*d bytes, and writes
// 4*B*d bytes: B*nnz*(4d+8) + 4*B*d in all, against d multiply-adds per id,
// far below the card's operations-per-byte balance.
//
// What the design does about it:
//   * a group of G lanes (G = d/4 rounded up to a power of two, at most 32)
//     owns one bag, so one warp serves 32/G bags at once: d=64 is two bags a
//     warp, d=16 eight. Neighbouring lanes read neighbouring 16-byte chunks
//     of a row, so every row read is coalesced into whole 32-byte sectors;
//   * each lane loads its bag's ids and weights itself (no scalar prefetch,
//     no shared memory), walks j = 0..nnz-1 and keeps the bag's partial sum
//     in f32 registers: the bag never leaves registers and is stored once;
//   * 8 warps a block, ceil(bags / bags-per-block) blocks, no atomics.
//
// Exactness: the first term is acc = w*row (acc = row when `w` is null), not
// 0 + w*row, so a bag of one with unit weight is exactly the gathered row.
//
// Out-of-range ids: an id outside [0, V) executes __trap() before any read
// of the table, so the kernel never reads outside it. The launch then fails
// and the next synchronising call on the stream raises (the CUDA context is
// lost: an out-of-range id is a caller's bug, not a recoverable input).
//
// Interface: plain C, loaded with ctypes. It takes d % 4 == 0 and a 16-byte
// aligned table (the wrapper, kernels/embedding_bag/ops.py, refuses anything
// else). It launches on `stream`, does not synchronise, allocates nothing,
// and returns cudaGetLastError() after the launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
  return acc;
}

__device__ __forceinline__ float4 scale4(float a, float4 x) {
  return make_float4(a * x.x, a * x.y, a * x.z, a * x.w);
}

__device__ __forceinline__ float4 add4(float4 x, float4 acc) {
  return make_float4(acc.x + x.x, acc.y + x.y, acc.z + x.z, acc.w + x.w);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out,
                     int B, int nnz, int V, int d, int group) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int bags_per_warp = 32 / group;
  const int sub = lane / group;  // which of this warp's bags
  const int g = lane % group;    // this lane's place in its bag's group
  const long long b = warp * bags_per_warp + sub;
  if (b >= B) return;

  const int nvec = d / 4;
  const int32_t* bag_idx = idx + b * nnz;
  const float* bag_w = w ? w + b * nnz : nullptr;
  float4* out_row = reinterpret_cast<float4*>(out + b * d);

  for (int c = g; c < nvec; c += group) {
    float4 acc{};  // overwritten (not added to) at j == 0
    for (int j = 0; j < nnz; ++j) {
      const int r = __ldg(bag_idx + j);
      if (r < 0 || r >= V) __trap();
      const float4 row = __ldg(reinterpret_cast<const float4*>(table + static_cast<long long>(r) * d) + c);
      if (bag_w) {
        const float wj = __ldg(bag_w + j);
        acc = (j == 0) ? scale4(wj, row) : fma4(wj, row, acc);
      } else {
        acc = (j == 0) ? row : add4(row, acc);
      }
    }
    out_row[c] = acc;
  }
}

}  // namespace

extern "C" int embedding_bag_f32(const void* table, const void* idx, const void* weights,
                                 void* out, int B, int nnz, int V, int d, void* stream) {
  // The caller guarantees d % 4 == 0 and 16-byte aligned table and out.
  const int nvec = d / 4;
  int group = 1;
  while (group < nvec && group < 32) group <<= 1;
  const long long bags_per_block = static_cast<long long>(kWarpsPerBlock) * (32 / group);
  const long long blocks = (B + bags_per_block - 1) / bags_per_block;
  embedding_bag_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(weights), static_cast<float*>(out), B, nnz, V, d, group);
  return static_cast<int>(cudaGetLastError());
}
