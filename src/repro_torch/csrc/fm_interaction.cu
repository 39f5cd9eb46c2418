// FM second-order interaction for Hopper (sm_90a):
//   out[b] = 0.5 * sum_c [ (sum_f e[b,f,c])^2 - sum_f e[b,f,c]^2 ]
// for e f32 [B, F, k] -> out f32 [B] (Rendle's sum-square identity).
//
// Replaces the TPU kernel repro/kernels/fm_interaction/fm_interaction.py:
// fm_interaction_kernel (Pallas, `_kernel`): there one grid step holds a
// [256, F, k] block in VMEM and reduces it with whole-block jnp sums, and
// the batch must divide by 256. Here any B, F, k >= 1 run.
//
// What bounds it: bytes, and at the serve path's size the latency of one
// trip to memory. A call reads 4*B*F*k bytes once and writes 4*B; it does
// about 3 operations per value read. FM at B=512 reads 798,720 bytes:
// 0.24 us at 3.35 TB/s, below the time of any launch; at B=65,536 it reads
// 102 MB, 0.0306 ms.
//
// What the design does about it:
//   * a block takes a chunk of E consecutive examples, E*F*k contiguous
//     floats, and issues every load of the chunk before it uses any: 16-byte
//     cp.async into shared memory, with the chunk's unaligned head and
//     ragged tail (at most 3 floats each) as 4-byte cp.async. So a chunk
//     costs one trip to memory, not one per row of the example that a lane
//     walks (the previous design, a warp an example, made 13 in a row at
//     F = 39, k = 10);
//   * the launch plan (kernels/fm_interaction/fm_interaction.py:
//     launch_plan) takes E so that B = 512 fills one wave of the card (4
//     examples a block, 128 blocks) and a large B keeps ~16 KB a block in
//     flight with many blocks an SM (10 examples a block at F*k = 390:
//     16.4 KB of shared memory, 13 blocks an SM) and a block takes one
//     chunk. (A persistent grid whose blocks load their next chunk into a
//     second buffer while they reduce one was slower on the card at
//     B = 65,536.)
//   * the reduction reads the chunk from shared memory in a fixed order:
//     thread (example, row group r, column c), c fastest, sums e and e^2 over
//     f = r, r+R, ... (R row groups, so short rows still keep the threads
//     busy), the R partial sums of a column meet in shared memory in r
//     order, and a warp an example forms S^2 - Q over its columns and sums
//     them with shuffles. Two launches give the same bits;
//   * an example too wide for shared memory (the plan's `wide`) takes
//     another branch of the same kernel: a block an example, reading e
//     directly, its sums in a fixed order too.
//
// Interface: plain C, loaded with ctypes (kernels/fm_interaction/
// fm_interaction.py), which passes the plan. It takes e contiguous and
// 4-byte aligned, B, F, k >= 1. It launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() after the
// launch (0 = launched); a plan it does not take returns
// cudaErrorInvalidValue and launches nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr long long kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kThreads = 128;  // threads a block (fm_interaction.py:THREADS)
constexpr int kMinBlocks = 8;  // so at most 64 registers a thread

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Floats of e a chunk's buffer holds: the chunk and up to 3 floats before
// it, so that its 16-byte-aligned part lands 16-byte aligned in shared
// memory (mirrors fm_interaction.py:buffer_floats).
__host__ __device__ __forceinline__ long long buffer_floats(long long chunk_floats) {
  return (chunk_floats + 3 + 3) / 4 * 4;
}

// Floats past the last 16-byte boundary at or before p.
__device__ __forceinline__ int misalign(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Copy `count` floats from g to buf + misalign(g): 4-byte copies up to the
// first 16-byte boundary of g, 16-byte copies, 4-byte copies of the rest.
__device__ __forceinline__ void load_chunk(float* buf, const float* g, int count) {
  const int mis = misalign(g);
  float* s = buf + mis;
  const int head = min((4 - mis) & 3, count);
  const int nvec = (count - head) >> 2;
  const int tail = count - head - 4 * nvec;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    cp_async16(s + head + 4 * i, g + head + 4 * i);
  }
  if (static_cast<int>(threadIdx.x) < head) cp_async4(s + threadIdx.x, g + threadIdx.x);
  if (static_cast<int>(threadIdx.x) < tail) {
    const int o = head + 4 * nvec + threadIdx.x;
    cp_async4(s + o, g + o);
  }
}

// Reduce n <= E examples of x [E, F, k] into out[0 .. n): partial sums of
// (example, r, c) into ps/pq [E, R, k], then a warp an example.
__device__ __forceinline__ void reduce_chunk(const float* x, float* ps, float* pq, float* out,
                                             int n, int E, int F, int k, int R) {
  const int FK = F * k, RK = R * k, items = E * RK;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int ex = it / RK;
    const int rem = it - ex * RK;
    const int r = rem / k;
    const int c = rem - r * k;
    float s = 0.f, q = 0.f;
    if (ex < n) {
      const float* p = x + ex * FK + r * k + c;
#pragma unroll 4
      for (int f = r; f < F; f += R, p += RK) {
        const float v = *p;
        s += v;
        q = fmaf(v, v, q);
      }
    }
    ps[it] = s;
    pq[it] = q;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int ex = threadIdx.x >> 5; ex < n; ex += kThreads / 32) {
    float term = 0.f;
    for (int c = lane; c < k; c += 32) {
      float S = 0.f, Q = 0.f;
      for (int r = 0; r < R; ++r) {
        S += ps[(ex * R + r) * k + c];
        Q += pq[(ex * R + r) * k + c];
      }
      term += S * S - Q;
    }
    for (int off = 16; off > 0; off >>= 1) term += __shfl_xor_sync(0xffffffffu, term, off);
    if (lane == 0) out[ex] = 0.5f * term;
  }
}

// One example too wide for shared memory, x [F, k], read directly into
// *out. R > 1 (R*k <= kThreads): thread (r, c) sums over f = r, r+R, ...
// and the R partials of a column meet in shared memory; R == 1: a thread
// walks columns c, c + kThreads, ... over every f. Then the block's
// terms are summed warp by warp, in order.
__device__ __forceinline__ void reduce_wide(const float* __restrict__ x, float* ps, float* pq,
                                            float* out, int F, int k, int R) {
  __shared__ float warp_sum[kThreads / 32];
  const int tid = threadIdx.x;
  float term = 0.f;
  if (R > 1) {
    if (tid < R * k) {
      const int r = tid / k, c = tid - r * k;
      float s = 0.f, q = 0.f;
      for (long long f = r; f < F; f += R) {
        const float v = __ldg(x + f * k + c);
        s += v;
        q = fmaf(v, v, q);
      }
      ps[tid] = s;
      pq[tid] = q;
    }
    __syncthreads();
    if (tid < k) {
      float S = 0.f, Q = 0.f;
      for (int r = 0; r < R; ++r) {
        S += ps[r * k + tid];
        Q += pq[r * k + tid];
      }
      term = S * S - Q;
    }
  } else {
    for (int c = tid; c < k; c += kThreads) {
      float s = 0.f, q = 0.f;
      for (long long f = 0; f < F; ++f) {
        const float v = __ldg(x + f * k + c);
        s += v;
        q = fmaf(v, v, q);
      }
      term += s * s - q;
    }
  }
  for (int off = 16; off > 0; off >>= 1) term += __shfl_xor_sync(0xffffffffu, term, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = term;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_sum[w];
    *out = 0.5f * t;
  }
}

// Staged: block x reduces chunk x, E examples from example x·E, loaded in
// one go. Wide: block x reduces example x from e directly.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fm_interaction_kernel(const float* __restrict__ e, float* __restrict__ out, int B, int F, int k,
                      int E, int R, bool wide) {
  extern __shared__ __align__(16) float smem[];
  const long long FK = static_cast<long long>(F) * k;
  if (wide) {
    reduce_wide(e + blockIdx.x * FK, smem, smem + R * k, out + blockIdx.x, F, k, R);
    return;
  }
  const long long b0 = static_cast<long long>(blockIdx.x) * E;
  const int n = static_cast<int>(min(static_cast<long long>(E), B - b0));
  float* ps = smem + buffer_floats(E * FK);
  float* pq = ps + E * R * k;
  const float* g = e + b0 * FK;
  load_chunk(smem, g, static_cast<int>(n * FK));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  reduce_chunk(smem + misalign(g), ps, pq, out + b0, n, E, F, k, R);
}

}  // namespace

// `wide`, `examples`, `rows` and `blocks` are the caller's plan
// (kernels/fm_interaction/fm_interaction.py:launch_plan).
extern "C" int fm_interaction_f32(const void* e, void* out, int B, int F, int k, int wide,
                                  int examples, int rows, int blocks, void* stream) {
  const int E = examples, R = rows;
  if (B < 1 || F < 1 || k < 1 || E < 1 || R < 1 || R > F || blocks < 1 ||
      reinterpret_cast<uintptr_t>(e) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long FK = static_cast<long long>(F) * k;
  long long smem;
  if (wide) {
    if (E != 1 || blocks != B || (R > 1 && static_cast<long long>(R) * k > kThreads)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    smem = R > 1 ? 8LL * R * k : 0;
  } else {
    smem = 4 * (buffer_floats(E * FK) + 2LL * E * R * k);
    if (smem > kMaxSmem || blocks != (B + static_cast<long long>(E) - 1) / E) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        fm_interaction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fm_interaction_kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<float*>(out), B, F, k, E, R, wide != 0);
  return static_cast<int>(cudaGetLastError());
}
