// EmbeddingBag for Hopper (sm_90a): out[b] = sum_j w[b,j] * table[idx[b,j]].
//
// Replaces the TPU kernel repro/kernels/embedding_bag/embedding_bag.py:embedding_bag
// (Pallas, `_kernel`): there the ids and weights are scalar-prefetched and a
// sequential grid of B*nnz steps DMAs one [1, d] row into a VMEM-resident
// bag accumulator per step. Hopper's blocks run in parallel and in no order,
// so that design is not carried over.
//
// What bounds it: bytes, and before them latency. A call reads B*nnz ids
// (4 B each), B*nnz weights (4 B each, none when `w` is null) and B*nnz
// rows of 4*d bytes, and writes 4*B*d bytes, against d multiply-adds per
// id, far below the card's operations-per-byte balance. The rows lie at
// random addresses, so what keeps the memory busy is the number of row
// loads in flight: threads on the card times loads in flight a thread.
//
// What the design does about it:
//   * a lane loads VEC floats at a time: 16 bytes (VEC=4) when d % 4 == 0 and
//     the table is 16-byte aligned, 8 bytes (VEC=2) when d % 2 == 0 and it is
//     8-byte aligned, else 4 bytes. The caller picks VEC;
//   * a group of G lanes (G = ceil(d/VEC) rounded up to a power of two, at
//     most 32) covers a row: neighbouring lanes read neighbouring chunks,
//     so a row is read in as few 32-byte sectors as it spans;
//   * `split` groups own one bag (a power of two, G * split <= 32, picked by
//     the caller from B, nnz and d): group s takes the contiguous run of ids
//     j in [s*R, s*R + R), R = ceil(nnz / split). Where d alone would leave
//     the card idle (FM's d = 1 bags of 39, d = 64 bags of 100) the ids of
//     a bag are walked by several groups at once; a bag of one id never
//     splits;
//   * a group loads U = 8 ids (and weights) of its run at a time, coalesced,
//     a lane each (several when G < 8), passes them to each other with
//     __shfl_sync, and then issues the U row loads (ld.global.nc) before it
//     adds any: 8 row loads in flight a lane, not one after another. A run
//     of one id (every bag of one) skips the shuffle: each lane of the
//     group loads the id, one broadcast request, so the row load waits on
//     one load and not on a load and a shuffle; that case is compiled apart
//     (ONE), so the registers of the 8-row batch do not cut its occupancy;
//   * the run's sum stays in f32 registers; the split partial sums combine
//     in a fixed shuffle tree (group s with s + split/2, then /4, ...), and
//     group 0 stores the bag. No shared memory, no atomics; 8 warps a block
//     (2 for few bags of one: more SMs share their id-then-row waits).
//
// TMA does not help here: Hopper's tensor memory accelerator has no
// row-gather mode, and a row of <= 256 bytes at a random address gains
// nothing from a bulk copy. The lever is memory-level parallelism.
//
// Order and exactness: each run adds its rows in j order, the runs combine
// in the fixed tree, so a result does not change from run to run. The
// first term of a run is acc = w*row (acc = row when `w` is null), not
// 0 + w*row, so a bag of one with unit weight is exactly the gathered row.
//
// Out-of-range ids: an id outside [0, V) executes __trap() in the lane that
// would read its row, before that read, so the kernel never reads outside
// the table. The launch then fails and the next synchronising call on the
// stream raises (the CUDA context is lost: an out-of-range id is a caller's
// bug, not a recoverable input).
//
// Interface: plain C, loaded with ctypes. `vec` is 4, 2 or 1, with d % vec
// == 0 and table and out aligned to 4*vec bytes; `split` a power of two
// with G * split <= 32 (the wrapper, kernels/embedding_bag/embedding_bag.py,
// picks both); B, nnz, V, d >= 1. Anything else returns
// cudaErrorInvalidValue and launches nothing. It launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after the launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a block
// few bags of one (fewer lanes than 132 SMs x 256): blocks of 2 warps, so
// more SMs share their id-then-row waits
constexpr int kWarpsFew = 2;
constexpr long long kFewLanes = 132LL * 256;
constexpr int kU = 8;  // ids a group loads at once: row loads in flight a lane
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float4 shfl_down_c(float4 v, int off, int width) {
  return make_float4(__shfl_down_sync(kFull, v.x, off, width), __shfl_down_sync(kFull, v.y, off, width),
                     __shfl_down_sync(kFull, v.z, off, width), __shfl_down_sync(kFull, v.w, off, width));
}
__device__ __forceinline__ float2 shfl_down_c(float2 v, int off, int width) {
  return make_float2(__shfl_down_sync(kFull, v.x, off, width), __shfl_down_sync(kFull, v.y, off, width));
}
__device__ __forceinline__ float shfl_down_c(float v, int off, int width) {
  return __shfl_down_sync(kFull, v, off, width);
}

// ONE: every run holds one id (nnz <= split: every bag of one), compiled
// apart so that the registers of the U-row batch do not cut its occupancy.
template <int VEC, int G, bool ONE>
__global__ void __launch_bounds__(kWarps * 32)
embedding_bag_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out,
                     int B, int nnz, int V, int d, int split) {
  using T = typename Chunk<VEC>::T;
  constexpr int kIdRegs = (kU + G - 1) / G;  // ids a lane loads for its group
  const int lane = threadIdx.x & 31;
  const int lanes = G * split;                // a bag's lanes: a power of two
  const int log_lanes = __ffs(lanes) - 1;     // shifts, not divisions, on the way to the id
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long b = (warp << (5 - log_lanes)) + (lane >> log_lanes);
  const int s = (lane & (lanes - 1)) / G;  // this lane's run
  const int g = lane % G;                  // its place in the group
  const bool live = b < B;  // lanes past the last bag still take part in the shuffles

  const int nvec = d / VEC;
  const int run = (nnz + split - 1) / split;
  const int j0 = s * run;
  const int n_run = live ? max(0, min(nnz - j0, run)) : 0;  // ids of this lane's run
  const int32_t* run_idx = idx + b * nnz + j0;
  const float* run_w = w ? w + b * nnz + j0 : nullptr;
  T* out_row = reinterpret_cast<T*>(out + b * d);

  for (int c0 = 0; c0 < nvec; c0 += G) {  // one pass unless d > 32 * VEC
    const int c = c0 + g;
    T acc{};  // overwritten (not added to) at the run's first id
    if constexpr (ONE) {  // the group loads its one id in one broadcast request
      if (n_run == 1 && c < nvec) {
        const int r = __ldg(run_idx);
        if (r < 0 || r >= V) __trap();
        const T row = __ldg(reinterpret_cast<const T*>(table + static_cast<long long>(r) * d) + c);
        acc = run_w ? scale_c(__ldg(run_w), row) : row;
      }
    } else {
      for (int t0 = 0; t0 < run; t0 += kU) {
        const int nu = min(kU, run - t0);  // the same for every lane of the warp
        int ids[kIdRegs];
        float ws[kIdRegs];
#pragma unroll
        for (int i = 0; i < kIdRegs; ++i) {  // the group's next U ids, a lane each
          const int u = g + G * i;
          const bool ok = u < nu && t0 + u < n_run;
          ids[i] = ok ? __ldg(run_idx + t0 + u) : 0;
          ws[i] = ok && run_w ? __ldg(run_w + t0 + u) : 1.f;
        }
        T rows[kU];
        float wu[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {  // every row load issued before any add
          if (u >= nu) break;
          const int r = __shfl_sync(kFull, ids[u / G], u % G, G);
          wu[u] = __shfl_sync(kFull, ws[u / G], u % G, G);
          if (t0 + u < n_run && c < nvec) {
            if (r < 0 || r >= V) __trap();
            rows[u] = __ldg(reinterpret_cast<const T*>(table + static_cast<long long>(r) * d) + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (t0 + u >= n_run || c >= nvec) break;
          if (run_w) {
            acc = (t0 + u == 0) ? scale_c(wu[u], rows[u]) : fma_c(wu[u], rows[u], acc);
          } else {
            acc = (t0 + u == 0) ? rows[u] : add_c(rows[u], acc);
          }
        }
      }
    }
    for (int off = lanes / 2; off >= G; off >>= 1) {  // run s += run s + off/G: a fixed tree
      const T other = shfl_down_c(acc, off, lanes);
      if (s < off / G) acc = add_c(other, acc);
    }
    if (live && s == 0 && c < nvec) out_row[c] = acc;
  }
}

template <int VEC, int G>
int launch(const float* table, const int32_t* idx, const float* w, float* out, int B, int nnz,
           int V, int d, int split, cudaStream_t stream) {
  const bool one = nnz <= split;
  const int warps = one && static_cast<long long>(B) * G * split < kFewLanes ? kWarpsFew : kWarps;
  const long long bags_per_block = static_cast<long long>(warps) * (32 / (G * split));
  const long long blocks = (B + bags_per_block - 1) / bags_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = one ? embedding_bag_kernel<VEC, G, true> : embedding_bag_kernel<VEC, G, false>;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, 0, stream>>>(table, idx, w, out, B, nnz, V, d,
                                                                   split);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch_group(const float* table, const int32_t* idx, const float* w, float* out, int B,
                 int nnz, int V, int d, int split, cudaStream_t stream) {
  const int nvec = d / VEC;
  int group = 1;
  while (group < nvec && group < 32) group <<= 1;
  if (split < 1 || (split & (split - 1)) != 0 || group * split > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (group) {
    case 1: return launch<VEC, 1>(table, idx, w, out, B, nnz, V, d, split, stream);
    case 2: return launch<VEC, 2>(table, idx, w, out, B, nnz, V, d, split, stream);
    case 4: return launch<VEC, 4>(table, idx, w, out, B, nnz, V, d, split, stream);
    case 8: return launch<VEC, 8>(table, idx, w, out, B, nnz, V, d, split, stream);
    case 16: return launch<VEC, 16>(table, idx, w, out, B, nnz, V, d, split, stream);
    default: return launch<VEC, 32>(table, idx, w, out, B, nnz, V, d, split, stream);
  }
}

}  // namespace

extern "C" int embedding_bag_f32(const void* table, const void* idx, const void* weights,
                                 void* out, int B, int nnz, int V, int d, int vec, int split,
                                 void* stream) {
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (B < 1 || nnz < 1 || V < 1 || d < 1 || (vec != 1 && vec != 2 && vec != 4) || d % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (vec) {
    case 4: return launch_group<4>(t, i, w, o, B, nnz, V, d, split, s);
    case 2: return launch_group<2>(t, i, w, o, B, nnz, V, d, split, s);
    case 1: return launch_group<1>(t, i, w, o, B, nnz, V, d, split, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
