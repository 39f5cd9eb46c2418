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
// one another, so each step's latency adds on top.
//
// What the design does about it:
//   * one block owns kRows = 4 batch rows for the whole T loop; a ragged
//     last block masks its missing rows, so B=1 and B=512 both run;
//   * wh (140 KB at g=108) and h live in shared memory for all T steps,
//     loaded once. Above 48 KB that is dynamic shared memory, raised with
//     cudaFuncSetAttribute before the launch (the launch fails without it);
//     at 147 KB one block fits an SM, and B=512 is 128 blocks on 132 SMs;
//   * h is stored transposed, [g][kRows], so one 16-byte broadcast read
//     gives h[j] of all four rows: a thread owns one column of zh and does
//     4 multiply-adds per wh read. 3g = 324 columns run on 352 threads; the
//     idle lanes of the last warp are masked;
//   * each step: zh for all rows and columns, a barrier, the gates and the
//     masked update of h (one thread per (row, unit), reading zx_t, a_t and
//     m_t coalesced along 3g from device memory), a barrier;
//   * f32 on CUDA cores with full-precision expf and tanhf, in JAX's
//     expression order: TF32 or fast math would miss the 1e-5 tolerance.
//
// Interface: plain C, loaded with ctypes (kernels/augru/augru.py). All
// arrays contiguous; g small enough that smem_bytes(g) fits the block (the
// wrapper checks). It launches on `stream`, does not synchronise,
// allocates nothing, and returns the first CUDA error of the attribute call
// or the launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;  // batch rows a block; h_s holds one float4 per unit
static_assert(kRows == 4, "the zh loop keeps one accumulator per row of a float4");

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void augru_kernel(const float* __restrict__ zx, const float* __restrict__ wh,
                             const float* __restrict__ h0, const float* __restrict__ att,
                             const uint8_t* __restrict__ mask, float* __restrict__ out,
                             int B, int T, int g) {
  extern __shared__ float4 smem4[];
  const int g3 = 3 * g;
  float4* h_s = smem4;                                   // [g] of kRows rows
  float* wh_s = reinterpret_cast<float*>(smem4 + g);     // [g, 3g]
  float* zh_s = wh_s + static_cast<long long>(g) * g3;   // [kRows, 3g]
  float* h_f = reinterpret_cast<float*>(h_s);            // h_f[j * kRows + r]

  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  for (int i = threadIdx.x; i < g * g3; i += blockDim.x) wh_s[i] = __ldg(wh + i);
  for (int i = threadIdx.x; i < kRows * g; i += blockDim.x) {
    const int r = i / g, j = i % g;
    const long long b = row0 + r;
    h_f[j * kRows + r] = b < B ? __ldg(h0 + b * g + j) : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int col = threadIdx.x; col < g3; col += blockDim.x) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int j = 0; j < g; ++j) {
        const float w = wh_s[j * g3 + col];
        const float4 h = h_s[j];
        a0 = fmaf(h.x, w, a0);
        a1 = fmaf(h.y, w, a1);
        a2 = fmaf(h.z, w, a2);
        a3 = fmaf(h.w, w, a3);
      }
      zh_s[0 * g3 + col] = a0;
      zh_s[1 * g3 + col] = a1;
      zh_s[2 * g3 + col] = a2;
      zh_s[3 * g3 + col] = a3;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * g; i += blockDim.x) {
      const int r = i / g, k = i % g;
      const long long b = row0 + r;
      if (b < B) {
        const long long bt = b * T + t;
        const float* z = zx + bt * g3;
        const float* zh = zh_s + r * g3;
        const float rg = sigmoid_f32(__ldg(z + k) + zh[k]);
        float u = sigmoid_f32(__ldg(z + g + k) + zh[g + k]);
        const float c = tanhf(__ldg(z + 2 * g + k) + rg * zh[2 * g + k]);
        u = __ldg(att + bt) * u;
        const float h = h_f[k * kRows + r];
        const float h_new = (1.f - u) * h + u * c;
        if (__ldg(mask + bt)) h_f[k * kRows + r] = h_new;
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < kRows * g; i += blockDim.x) {
    const int r = i / g, j = i % g;
    const long long b = row0 + r;
    if (b < B) out[b * g + j] = h_f[j * kRows + r];
  }
}

// h [kRows, g] + wh [g, 3g] + zh [kRows, 3g], f32 (kernels/augru/augru.py:smem_bytes)
long long smem_bytes(int g) {
  return 4LL * (static_cast<long long>(kRows) * g + 3LL * g * g + 3LL * kRows * g);
}

}  // namespace

extern "C" int augru_f32(const void* zx, const void* wh, const void* h0, const void* att,
                         const void* mask, void* out, int B, int T, int g, void* stream) {
  const long long smem = smem_bytes(g);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        augru_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((3 * g + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  augru_kernel<<<blocks, threads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zx), static_cast<const float*>(wh),
      static_cast<const float*>(h0), static_cast<const float*>(att),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), B, T, g);
  return static_cast<int>(cudaGetLastError());
}
