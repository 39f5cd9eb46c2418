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
//   * a lane loads VEC floats at a time: 16 bytes (VEC=4) when d % 4 == 0 and
//     the table is 16-byte aligned, 8 bytes (VEC=2) when d % 2 == 0 and it is
//     8-byte aligned, else 4 bytes. The caller picks VEC; the kernel is
//     templated on it;
//   * a group of G lanes (G = ceil(d/VEC) rounded up to a power of two, at
//     most 32) owns one bag, so one warp serves 32/G bags at once: d=64 is
//     two bags a warp, d=18 two, d=16 eight, d=10 four, d=1 thirty-two.
//     Neighbouring lanes read neighbouring chunks of a row, so a row is read
//     in as few 32-byte sectors as it spans;
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
// Interface: plain C, loaded with ctypes. `vec` is 4, 2 or 1, with d % vec
// == 0 and table and out aligned to 4*vec bytes (the wrapper,
// kernels/embedding_bag/embedding_bag.py, picks it); any other `vec` returns
// cudaErrorInvalidValue and launches nothing. It launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError() after
// the launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int VEC> struct Chunk;
template <> struct Chunk<4> { using T = float4; };
template <> struct Chunk<2> { using T = float2; };
template <> struct Chunk<1> { using T = float; };

__device__ __forceinline__ float4 fma_c(float a, float4 x, float4 acc) {
  return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y), fmaf(a, x.z, acc.z),
                     fmaf(a, x.w, acc.w));
}
__device__ __forceinline__ float2 fma_c(float a, float2 x, float2 acc) {
  return make_float2(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y));
}
__device__ __forceinline__ float fma_c(float a, float x, float acc) { return fmaf(a, x, acc); }

__device__ __forceinline__ float4 scale_c(float a, float4 x) {
  return make_float4(a * x.x, a * x.y, a * x.z, a * x.w);
}
__device__ __forceinline__ float2 scale_c(float a, float2 x) { return make_float2(a * x.x, a * x.y); }
__device__ __forceinline__ float scale_c(float a, float x) { return a * x; }

__device__ __forceinline__ float4 add_c(float4 x, float4 acc) {
  return make_float4(acc.x + x.x, acc.y + x.y, acc.z + x.z, acc.w + x.w);
}
__device__ __forceinline__ float2 add_c(float2 x, float2 acc) {
  return make_float2(acc.x + x.x, acc.y + x.y);
}
__device__ __forceinline__ float add_c(float x, float acc) { return acc + x; }

template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out,
                     int B, int nnz, int V, int d, int group) {
  using T = typename Chunk<VEC>::T;
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int bags_per_warp = 32 / group;
  const int sub = lane / group;  // which of this warp's bags
  const int g = lane % group;    // this lane's place in its bag's group
  const long long b = warp * bags_per_warp + sub;
  if (b >= B) return;

  const int nvec = d / VEC;
  const int32_t* bag_idx = idx + b * nnz;
  const float* bag_w = w ? w + b * nnz : nullptr;
  T* out_row = reinterpret_cast<T*>(out + b * d);

  for (int c = g; c < nvec; c += group) {
    T acc{};  // overwritten (not added to) at j == 0
    for (int j = 0; j < nnz; ++j) {
      const int r = __ldg(bag_idx + j);
      if (r < 0 || r >= V) __trap();
      const T row = __ldg(reinterpret_cast<const T*>(table + static_cast<long long>(r) * d) + c);
      if (bag_w) {
        const float wj = __ldg(bag_w + j);
        acc = (j == 0) ? scale_c(wj, row) : fma_c(wj, row, acc);
      } else {
        acc = (j == 0) ? row : add_c(row, acc);
      }
    }
    out_row[c] = acc;
  }
}

template <int VEC>
int launch(const float* table, const int32_t* idx, const float* w, float* out, int B, int nnz,
           int V, int d, cudaStream_t stream) {
  const int nvec = d / VEC;
  int group = 1;
  while (group < nvec && group < 32) group <<= 1;
  const long long bags_per_block = static_cast<long long>(kWarpsPerBlock) * (32 / group);
  const long long blocks = (B + bags_per_block - 1) / bags_per_block;
  embedding_bag_kernel<VEC><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
      table, idx, w, out, B, nnz, V, d, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int embedding_bag_f32(const void* table, const void* idx, const void* weights,
                                 void* out, int B, int nnz, int V, int d, int vec,
                                 void* stream) {
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: return launch<4>(t, i, w, o, B, nnz, V, d, s);
    case 2: return launch<2>(t, i, w, o, B, nnz, V, d, s);
    case 1: return launch<1>(t, i, w, o, B, nnz, V, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
