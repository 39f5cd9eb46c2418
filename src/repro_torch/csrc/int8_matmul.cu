// W8A8 int8 matrix product with its dequant epilogue, for Hopper (sm_90a):
//   out[M,N] = f32(Σ_k a_q[m,k]·b_q[k,n], summed in int32) · (a_s[m] · b_s[n])
// with a_q int8 [M,K], b_q int8 [K,N], a_s f32 [M], b_s f32 [N].
//
// Replaces the TPU kernel repro/kernels/int8_matmul/int8_matmul.py:
// int8_matmul (Pallas, `_kernel`): there the grid is (M/128, N/128, K/128),
// K innermost, an int32 VMEM accumulator lives across the K sweep and the
// epilogue `acc · (a_s[:,None] · b_s[None,:])` runs at the last K step;
// M, K and N must divide by 128 (its wrapper falls back to the jnp
// reference otherwise). Here any M, K, N >= 1 run: the ragged edges are
// read as 0 inside the kernel. The epilogue is the Pallas one, in the same
// association.
//
// What bounds it: at the kernel benchmark's 512³, 1.57 MB of operands and
// output (0.0005 ms at 3.35 TB/s) against 0.27 GOP (0.00014 ms at the int8
// tensor-core rate): a launch-sized call. At the ranker's FFN w1 shape
// (51,200 x 64 x 256) the activations and the output are 55.7 MB, 0.0166 ms
// by bytes.
//
// What the design does about it:
//   * a block of 256 threads owns a 64 x 64 tile of out and walks K in
//     steps of 32; each step stages the 64 x 32 bytes of a_q and the
//     32 x 64 bytes of b_q in shared memory, packed four k values to a
//     32-bit word (a_q along its rows, b_q down its columns), bytes outside
//     the matrices as 0;
//   * each thread forms a 4 x 4 patch of out with __dp4a, four int8
//     multiply-adds into an int32 at a time, on the CUDA cores. Int32 sums
//     are exact in any order, so the accumulator equals the plain
//     version's bit for bit;
//   * the epilogue multiplies once per output, f32(acc) · (a_s · b_s).
//   The int8 tensor cores (mma.sync / wgmma .s8) and TMA are later work.
//
// Interface: plain C, loaded with ctypes (kernels/int8_matmul/int8_matmul.py).
// Arrays contiguous and row-major; M, K, N >= 1. Anything else returns
// cudaErrorInvalidValue and launches nothing. It launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after the launch (0 = launched).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;   // rows of out a block
constexpr int kBN = 64;   // columns of out a block
constexpr int kBK = 32;   // k values a step
constexpr int kKW = kBK / 4;  // packed words a step
constexpr int kTM = 4;    // rows of out a thread
constexpr int kTN = 4;    // columns of out a thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPad = 4;   // keeps rows 16-byte aligned, spreads the banks

__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return (static_cast<uint32_t>(b0) & 0xffu) | ((static_cast<uint32_t>(b1) & 0xffu) << 8) |
         ((static_cast<uint32_t>(b2) & 0xffu) << 16) | ((static_cast<uint32_t>(b3) & 0xffu) << 24);
}

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   const float* __restrict__ a_s, const float* __restrict__ b_s,
                   float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) int as[kKW][kBM + kPad];  // as[w][m]: a[m, 4w .. 4w+3]
  __shared__ __align__(16) int bs[kKW][kBN + kPad];  // bs[w][n]: b[4w .. 4w+3, n]

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // a tile: 64 rows x 8 words; neighbouring lanes walk k (contiguous in a)
#pragma unroll
    for (int r = 0; r < (kBM * kKW) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int mm = e / kKW, w = e % kKW;
      const long long m = m0 + mm;
      int v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = k0 + 4 * w + t;
        v[t] = (m < M && k < K) ? a[m * K + k] : 0;
      }
      as[w][mm] = static_cast<int>(pack4(v[0], v[1], v[2], v[3]));
    }
    // b tile: 8 words x 64 columns; neighbouring lanes walk n (contiguous in b)
#pragma unroll
    for (int r = 0; r < (kKW * kBN) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int w = e / kBN, nn = e % kBN;
      const int n = n0 + nn;
      int v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = k0 + 4 * w + t;
        v[t] = (k < K && n < N) ? b[static_cast<long long>(k) * N + n] : 0;
      }
      bs[w][nn] = static_cast<int>(pack4(v[0], v[1], v[2], v[3]));
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kKW; ++w) {
      const int4 av = *reinterpret_cast<const int4*>(&as[w][ty * kTM]);
      const int4 bv = *reinterpret_cast<const int4*>(&bs[w][tx * kTN]);
      const int ar[kTM] = {av.x, av.y, av.z, av.w};
      const int br[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
    if (m >= M) break;
    const float sa = a_s[m];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n < N) out[m * N + n] = static_cast<float>(acc[i][j]) * (sa * b_s[n]);
    }
  }
}

}  // namespace

extern "C" int int8_matmul_s8(const void* a_q, const void* b_q, const void* a_scale,
                              const void* b_scale, void* out, int M, int K, int N,
                              void* stream) {
  if (M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((N + kBN - 1) / kBN));
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  int8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a_q), static_cast<const int8_t*>(b_q),
      static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
