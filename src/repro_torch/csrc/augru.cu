// AUGRU recurrence (DIEN's interest evolution) for Hopper (sm_90a).
//
// For each batch row, from h = h0, for t = 0..T-1:
//   zh = h @ wh                              wh f32 [g, 3g], gates [r, u, c]
//   r  = sigmoid(zx_t[:g]   + zh[:g])
//   u  = sigmoid(zx_t[g:2g] + zh[g:2g])
//   c  = tanh(zx_t[2g:] + r * zh[2g:])
//   u  = a_t * u
//   h  = m_t ? (1 - u) * h + u * c : h
// and out = the last h. zx f32 [B, T, 3g] (x @ wx + b, precomputed), att f32
// [B, T], mask bool [B, T], h0 f32 [B, g] -> out f32 [B, g].
//
// Replaces the TPU kernel repro/kernels/augru/augru.py:augru (Pallas,
// `_kernel`): there one grid step per block of 128 rows keeps h in VMEM and
// runs the T loop inside the kernel, with h @ wh on the MXU each step, and
// B must divide by 128. Here any B runs.
//
// What bounds it: operations. At DIEN's B=512, T=100, g=108 the products
// h @ wh are 2*B*T*g*3g = 3.58 GFLOP, 0.053 ms at 67 TFLOP/s f32, while zx
// (66.4 MB, read once) takes 0.020 ms at 3.35 TB/s. The T steps depend on
// one another, so a block's step is on the critical path T times: what a
// step costs beyond its multiply-adds is paid T times over.
//
// What the design does about it:
//   * a block owns R batch rows (a multiple of 4) for the whole T loop; R
//     is chosen from B by the caller (kernels/augru/augru.py:launch_plan)
//     so that the batch fits one wave of blocks, one block an SM: 4 rows
//     at B = 512, 32 at B = 4096. A ragged last block masks its rows;
//   * wh lives in registers for all T steps: lane s of a group of kS = 4
//     lanes owns unit k's three columns (r, u, c) at the rows j = jj*4 + s
//     of wh, 3*KS floats (KS = ceil(g/4), 81 at g = 108). A warp is 8 units
//     of 4 lanes; g = 108 is 14 warps. A lane's sum is a chain of KS
//     multiply-adds over its quarter of j, four batch rows at once (h kept
//     in shared memory as [j][4 rows], one 16-byte broadcast per j);
//   * the four quarters are added by shuffles that scatter the rows, so
//     that lane s ends with row s's three sums in a fixed order,
//     (q_s + q_{s^2}) + (q_{s^1} + q_{s^3}); that lane then computes the
//     gates and the update of (row s, unit k) itself. The new h goes to
//     the other half of a double buffer, so a step needs one barrier;
//   * a step's inputs are in shared memory when it starts: the block's att
//     and mask rows are read kAmSteps steps at a time (all of DIEN's 100 at
//     once), and the zx rows of step t+2 are copied with cp.async while
//     step t computes (three buffers), so a step waits on no load from
//     device memory;
//   * f32 on CUDA cores with full-precision expf and tanhf, in JAX's
//     expression order: TF32 or fast math would miss the 1e-5 tolerance.
//
// Interface: plain C, loaded with ctypes (kernels/augru/augru.py). All
// arrays contiguous; the launch (R, KS, threads, shared memory) comes from
// the caller's plan and is checked here: anything else returns
// cudaErrorInvalidValue and launches nothing. It launches on `stream`,
// does not synchronise, allocates nothing, and returns the first CUDA
// error of the attribute call or the launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kS = 4;                   // lanes that split one unit's sum over j
constexpr int kUnitsPerWarp = 32 / kS;  // 8
constexpr int kMaxRows = 64;            // rows a block
constexpr long long kMaxSmem = 232448;  // a block's shared memory on Hopper

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A row of zx in shared memory: 3g rounded up to 8 more than a multiple of
// 32 floats, so the four rows a warp's gate lanes read fall in other banks.
__host__ __device__ inline int zx_stride(int g) {
  const int g3 = 3 * g;
  return g3 + ((8 - g3 % 32) + 32) % 32;
}

constexpr int kZxBuffers = 3;  // zx rows of steps t, t+1 and t+2
constexpr int kAmSteps = 128;  // steps of att and mask staged at once

// h [2][R/4][4*KS][4] + zx [3][R][zx_stride] + att [R][kAmSteps] f32, then
// mask [R][kAmSteps] bytes (kernels/augru/augru.py:smem_bytes)
__host__ __device__ inline long long smem_bytes(int R, int g, int KS) {
  return 4LL * (2LL * R * kS * KS + static_cast<long long>(kZxBuffers) * R * zx_stride(g) +
                static_cast<long long>(R) * kAmSteps) + static_cast<long long>(R) * kAmSteps;
}

// Issue the copies of step t's zx rows into `dst` ([R][zx_stride]).
__device__ __forceinline__ void load_zx(float* dst, const float* __restrict__ zx, long long row0,
                                        int R, int B, int T, int g3, int zs, int t, bool vec4) {
  if (vec4) {
    const int n4 = g3 / 4;
    for (int e = threadIdx.x; e < R * n4; e += blockDim.x) {
      const int r = e / n4, c = e % n4;
      const long long b = row0 + r;
      if (b < B) cp_async16(dst + r * zs + 4 * c, zx + (b * T + t) * g3 + 4 * c);
    }
  } else {
    for (int e = threadIdx.x; e < R * g3; e += blockDim.x) {
      const int r = e / g3, c = e % g3;
      const long long b = row0 + r;
      if (b < B) cp_async4(dst + r * zs + c, zx + (b * T + t) * g3 + c);
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(32 * ((KS + 1) / 2))
augru_kernel(const float* __restrict__ zx, const float* __restrict__ wh,
             const float* __restrict__ h0, const float* __restrict__ att,
             const uint8_t* __restrict__ mask, float* __restrict__ out, int B, int T, int g,
             int R, int vec4) {
  constexpr int J = kS * KS;  // rows of wh a lane group covers, g padded
  extern __shared__ __align__(16) float smem[];
  const int g3 = 3 * g, zs = zx_stride(g), RC = R / 4;
  float4* h4 = reinterpret_cast<float4*>(smem);  // [2][RC][J]: 4 rows a float4
  float* hf = smem;                              // hf[((buf*RC + c)*J + j)*4 + r]
  float* zxs = smem + 2 * RC * J * 4;            // [kZxBuffers][R][zs]
  float* as = zxs + kZxBuffers * R * zs;         // [R][kAmSteps]: att of steps t0..
  uint8_t* ms = reinterpret_cast<uint8_t*>(as + R * kAmSteps);  // [R][kAmSteps]: mask

  const int tid = threadIdx.x, lane = tid & 31, s = lane % kS;
  const int k = (tid / 32) * kUnitsPerWarp + lane / kS;  // this lane's unit
  const bool unit = k < g;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;

  // the first steps' zx in flight while the rest is set up
  for (int i = 0; i < kZxBuffers - 1; ++i) {
    if (i < T) load_zx(zxs + i * R * zs, zx, row0, R, B, T, g3, zs, i, vec4);
    cp_async_commit();
  }

  float wr[KS], wu[KS], wc[KS];
#pragma unroll
  for (int jj = 0; jj < KS; ++jj) {
    const int j = jj * kS + s;
    const bool in = unit && j < g;
    const float* w = wh + static_cast<long long>(j) * g3 + k;
    wr[jj] = in ? __ldg(w) : 0.f;
    wu[jj] = in ? __ldg(w + g) : 0.f;
    wc[jj] = in ? __ldg(w + 2 * g) : 0.f;
  }

  for (int i = tid; i < 2 * RC * J; i += blockDim.x) h4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int i = tid; i < R * g; i += blockDim.x) {
    const int r = i / g, j = i % g;
    const long long b = row0 + r;
    if (b < B) hf[((r / 4) * J + j) * 4 + r % 4] = __ldg(h0 + b * g + j);
  }
  // att and mask of steps t0 .. t0 + kAmSteps − 1
  auto load_am = [&](int t0) {
    for (int i = tid; i < R * kAmSteps; i += blockDim.x) {
      const long long b = row0 + i / kAmSteps;
      const int t = t0 + i % kAmSteps;
      const bool in = b < B && t < T;
      as[i] = in ? __ldg(att + b * T + t) : 0.f;
      ms[i] = in ? __ldg(mask + b * T + t) : 0;
    }
  };
  load_am(0);
  cp_async_wait_group<kZxBuffers - 2>();  // step 0's zx
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const float* zt = zxs + (t % kZxBuffers) * R * zs;
    // step t+2's zx in flight (into the buffer step t−1 used) while step t computes
    if (t + kZxBuffers - 1 < T) {
      load_zx(zxs + ((t + kZxBuffers - 1) % kZxBuffers) * R * zs, zx, row0, R, B, T, g3, zs,
              t + kZxBuffers - 1, vec4);
    }
    cp_async_commit();
    for (int c = 0; c < RC; ++c) {
      const float4* hc = h4 + (cur * RC + c) * J;
      float4 ar = make_float4(0.f, 0.f, 0.f, 0.f), au = ar, ac = ar;
#pragma unroll
      for (int jj = 0; jj < KS; ++jj) {
        const float4 h = hc[jj * kS + s];
        ar.x = fmaf(h.x, wr[jj], ar.x); ar.y = fmaf(h.y, wr[jj], ar.y);
        ar.z = fmaf(h.z, wr[jj], ar.z); ar.w = fmaf(h.w, wr[jj], ar.w);
        au.x = fmaf(h.x, wu[jj], au.x); au.y = fmaf(h.y, wu[jj], au.y);
        au.z = fmaf(h.z, wu[jj], au.z); au.w = fmaf(h.w, wu[jj], au.w);
        ac.x = fmaf(h.x, wc[jj], ac.x); ac.y = fmaf(h.y, wc[jj], ac.y);
        ac.z = fmaf(h.z, wc[jj], ac.z); ac.w = fmaf(h.w, wc[jj], ac.w);
      }
      // scatter the rows over the 4 lanes: keep 2 rows, then 1
      const bool hi2 = s & 2, hi1 = s & 1;
      float r0 = (hi2 ? ar.z : ar.x) + __shfl_xor_sync(0xffffffffu, hi2 ? ar.x : ar.z, 2);
      float r1 = (hi2 ? ar.w : ar.y) + __shfl_xor_sync(0xffffffffu, hi2 ? ar.y : ar.w, 2);
      float u0 = (hi2 ? au.z : au.x) + __shfl_xor_sync(0xffffffffu, hi2 ? au.x : au.z, 2);
      float u1 = (hi2 ? au.w : au.y) + __shfl_xor_sync(0xffffffffu, hi2 ? au.y : au.w, 2);
      float c0 = (hi2 ? ac.z : ac.x) + __shfl_xor_sync(0xffffffffu, hi2 ? ac.x : ac.z, 2);
      float c1 = (hi2 ? ac.w : ac.y) + __shfl_xor_sync(0xffffffffu, hi2 ? ac.y : ac.w, 2);
      const float zr = (hi1 ? r1 : r0) + __shfl_xor_sync(0xffffffffu, hi1 ? r0 : r1, 1);
      const float zu = (hi1 ? u1 : u0) + __shfl_xor_sync(0xffffffffu, hi1 ? u0 : u1, 1);
      const float zc = (hi1 ? c1 : c0) + __shfl_xor_sync(0xffffffffu, hi1 ? c0 : c1, 1);

      const int rr = 4 * c + s;  // this lane's row of the block
      if (unit && row0 + rr < B) {
        const float* z = zt + rr * zs;
        const float rg = sigmoid_f32(z[k] + zr);
        float u = sigmoid_f32(z[g + k] + zu);
        const float cc = tanhf(z[2 * g + k] + rg * zc);
        u = as[rr * kAmSteps + t % kAmSteps] * u;
        const float h = hf[((cur * RC + c) * J + k) * 4 + s];
        const float h_new = (1.f - u) * h + u * cc;
        hf[((nxt * RC + c) * J + k) * 4 + s] = ms[rr * kAmSteps + t % kAmSteps] ? h_new : h;
      }
    }
    cp_async_wait_group<kZxBuffers - 2>();  // step t+1's zx (step t+2's may still be arriving)
    __syncthreads();
    if ((t + 1) % kAmSteps == 0 && t + 1 < T) {  // the next steps' att and mask
      load_am(t + 1);
      __syncthreads();
    }
  }

  const int fin = T & 1;
  for (int i = tid; i < R * g; i += blockDim.x) {
    const int r = i / g, j = i % g;
    const long long b = row0 + r;
    if (b < B) out[b * g + j] = hf[((fin * RC + r / 4) * J + j) * 4 + r % 4];
  }
}

template <int KS>
int launch(const void* zx, const void* wh, const void* h0, const void* att, const void* mask,
           void* out, int B, int T, int g, int R, int blocks, int threads, cudaStream_t stream) {
  const long long smem = smem_bytes(R, g, KS);
  if (threads != 32 * ((g + kUnitsPerWarp - 1) / kUnitsPerWarp) || threads > 32 * ((KS + 1) / 2) ||
      smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      augru_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec4 = (3 * g) % 4 == 0 && reinterpret_cast<uintptr_t>(zx) % 16 == 0;
  augru_kernel<KS><<<blocks, threads, static_cast<size_t>(smem), stream>>>(
      static_cast<const float*>(zx), static_cast<const float*>(wh),
      static_cast<const float*>(h0), static_cast<const float*>(att),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), B, T, g, R, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `ks`, `rows`, `blocks` and `threads` are the caller's plan
// (kernels/augru/augru.py:launch_plan); `ks` one of its KS_SIZES.
extern "C" int augru_f32(const void* zx, const void* wh, const void* h0, const void* att,
                         const void* mask, void* out, int B, int T, int g, int ks, int rows,
                         int blocks, int threads, void* stream) {
  if (B < 1 || T < 1 || g < 1 || rows < 4 || rows % 4 || rows > kMaxRows ||
      static_cast<long long>(blocks) * rows < B || static_cast<long long>(blocks - 1) * rows >= B ||
      kS * ks < g) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AUGRU_CASE(N) \
  case N: return launch<N>(zx, wh, h0, att, mask, out, B, T, g, rows, blocks, threads, st);
  switch (ks) {
    AUGRU_CASE(1) AUGRU_CASE(2) AUGRU_CASE(4) AUGRU_CASE(8) AUGRU_CASE(16) AUGRU_CASE(24)
    AUGRU_CASE(27) AUGRU_CASE(32) AUGRU_CASE(34)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AUGRU_CASE
}
