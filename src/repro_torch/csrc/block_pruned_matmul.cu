// Block-pruned matrix product for Hopper (sm_90a):
//   out[M,N] = x[M,K] @ (w[K,N] * expand(block_mask))
// where block_mask int32 [ceil(K/128), ceil(N/128)] says which 128 x 128
// tiles of w survived structured pruning (0 = pruned).
//
// Replaces the TPU kernel repro/kernels/block_pruned_matmul/
// block_pruned_matmul.py:block_pruned_matmul (Pallas, `_kernel`): there the
// mask is scalar-prefetched, the grid is (M/128, N/128, K/128) and a
// `pl.when` on mask[k, n] skips the DMA and the MXU product of a pruned
// tile; M, K and N must divide by 128 (its wrapper falls back to the jnp
// reference otherwise, and every linear of taobao_ssa is ragged). Here any
// M, K, N >= 1 run: the ragged edges are masked inside the kernel.
//
// What bounds it: at the serve path's widest linears (M = 51,200 tokens,
// K x N = 64 x 256 at density 0.5) bytes and operations are close: x and
// out are 65.5 MB (0.020 ms at 3.35 TB/s) against 0.84 GFLOP of surviving
// f32 multiply-adds (0.0125 ms at 67 TFLOP/s outside the tensor cores).
// The products run in f32 on the CUDA cores: the reference is f32, and
// TF32 tensor cores would keep only about three decimal digits.
//
// What the design does about it:
//   * a block of 256 threads owns a 64 x 64 tile of out; 64 divides the
//     mask's tile of 128, so a tile lies inside one column stripe of the
//     mask, and every k-step of 16 rows inside one row stripe;
//   * the block walks the row stripes kb = 0 .. ceil(K/128)-1 and skips
//     the whole stripe, loads and products, where block_mask[kb, nb] == 0;
//     a tile whose stripes are all pruned still writes its zeros;
//   * each k-step stages a 64 x 16 tile of x (transposed) and a 16 x 64 tile
//     of w in shared memory, out-of-range elements as 0; each thread then
//     forms a 4 x 4 patch of out from 16-byte shared-memory reads, summing
//     in k order with fmaf. A sum's order is fixed, so a result does not
//     change from run to run.
//   wgmma and TMA are later work.
//
// Interface: plain C, loaded with ctypes (kernels/block_pruned_matmul/
// block_pruned_matmul.py). x, w, block_mask and out contiguous and
// row-major; M, K, N >= 1. Anything else returns
// cudaErrorInvalidValue and launches nothing. It launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after the launch (0 = launched).

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;  // rows of out a block
constexpr int kBN = 64;  // columns of out a block
constexpr int kBK = 16;  // depth of one k-step
constexpr int kTM = 4;   // rows of out a thread
constexpr int kTN = 4;   // columns of out a thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPad = 4;  // keeps rows 16-byte aligned, spreads the banks
constexpr int kBlock = 128;  // the mask's tile: repro's pruned_linear and prune_tree's
static_assert(kBlock % kBN == 0 && kBlock % kBK == 0, "a CTA tile lies inside one mask tile");

__global__ void __launch_bounds__(kThreads)
block_pruned_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const int* __restrict__ block_mask, float* __restrict__ out,
                           int M, int K, int N) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];  // xs[k][m]
  __shared__ __align__(16) float ws[kBK][kBN + kPad];  // ws[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);  // column group
  const int ty = tid / (kBN / kTN);  // row group
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int nb = n0 / kBlock;
  const int n_col_blocks = (N + kBlock - 1) / kBlock;
  const int n_row_blocks = (K + kBlock - 1) / kBlock;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < n_row_blocks; ++kb) {
    if (block_mask[kb * n_col_blocks + nb] == 0) continue;  // the same for the whole block
    const int k_end = min(K, (kb + 1) * kBlock);
    for (int k0 = kb * kBlock; k0 < k_end; k0 += kBK) {
      // x tile: 64 rows x 16 columns; lane order walks k first (contiguous in x)
#pragma unroll
      for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int mm = e / kBK, kk = e % kBK;
        const long long m = m0 + mm;
        const int k = k0 + kk;
        xs[kk][mm] = (m < M && k < k_end) ? x[m * K + k] : 0.f;
      }
      // w tile: 16 rows x 64 columns; lane order walks n (contiguous in w)
#pragma unroll
      for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int kk = e / kBN, nn = e % kBN;
        const int k = k0 + kk, n = n0 + nn;
        ws[kk][nn] = (k < k_end && n < N) ? w[static_cast<long long>(k) * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * kTM]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * kTN]);
        const float av[kTM] = {a.x, a.y, a.z, a.w};
        const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n < N) out[m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int block_pruned_matmul_f32(const void* x, const void* w, const void* block_mask,
                                       void* out, int M, int K, int N, void* stream) {
  if (M < 1 || K < 1 || N < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((N + kBN - 1) / kBN));
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  block_pruned_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(block_mask), static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
