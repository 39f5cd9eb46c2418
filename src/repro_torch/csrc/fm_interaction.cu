// FM second-order interaction for Hopper (sm_90a):
//   out[b] = 0.5 * sum_c [ (sum_f e[b,f,c])^2 - sum_f e[b,f,c]^2 ]
// for e f32 [B, F, k] -> out f32 [B] (Rendle's sum-square identity).
//
// Replaces the TPU kernel repro/kernels/fm_interaction/fm_interaction.py:
// fm_interaction_kernel (Pallas, `_kernel`): there one grid step holds a
// [256, F, k] block in VMEM and reduces it with whole-block jnp sums, and
// the batch must divide by 256. Here any B runs.
//
// What bounds it: bytes, and at the serve path's size the launch itself.
// A call reads 4*B*F*k bytes once and writes 4*B; it does about 3 operations
// per value read. FM at B=512 reads 798,720 bytes: 0.24 us at 3.35 TB/s.
//
// What the design does about it:
//   * one warp per example, 8 warps a block, ceil(B/8) blocks; the warp of
//     an example past B returns, so a ragged B needs no padding;
//   * the warp walks its example's [F, k] values in chunks of C = min(k, 32)
//     columns. In a chunk, lane (row, col) = (lane / C, lane % C) of the
//     R = 32 / C rows sums e and e^2 over f = row, row+R, ...: R neighbouring
//     rows are read by one instruction, so k = 10 keeps 30 of 32 lanes busy
//     and each read is R*k contiguous floats;
//   * the R partial sums of a column meet in 64 floats of shared memory per
//     warp; lane col adds them in row order, forms S^2 - Q, and the warp sums
//     its lanes with shuffles. Every sum is taken in a fixed order, so the
//     result does not change from run to run.
//
// Interface: plain C, loaded with ctypes (kernels/fm_interaction/
// fm_interaction.py). It takes e contiguous, F >= 1, k >= 1. It launches on
// `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 = launched).

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fm_interaction_kernel(const float* __restrict__ e, float* __restrict__ out, int B, int F, int k) {
  __shared__ float part_s[kWarpsPerBlock][32];
  __shared__ float part_q[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + wib;
  if (b >= B) return;  // the whole warp leaves together

  const float* ex = e + b * static_cast<long long>(F) * k;
  const int C = k < 32 ? k : 32;  // columns a chunk
  const int R = 32 / C;           // rows a pass
  const int row = lane / C;
  const int col = lane % C;
  float term = 0.f;
  for (int c0 = 0; c0 < k; c0 += C) {
    const int cols = (k - c0) < C ? (k - c0) : C;
    float s = 0.f, q = 0.f;
    if (row < R && col < cols) {
      for (int f = row; f < F; f += R) {
        const float v = __ldg(ex + static_cast<long long>(f) * k + c0 + col);
        s += v;
        q = fmaf(v, v, q);
      }
    }
    part_s[wib][lane] = s;
    part_q[wib][lane] = q;
    __syncwarp();
    if (lane < cols) {
      float S = 0.f, Q = 0.f;
      for (int r = 0; r < R; ++r) {
        S += part_s[wib][r * C + lane];
        Q += part_q[wib][r * C + lane];
      }
      term += S * S - Q;
    }
    __syncwarp();
  }
  for (int off = 16; off > 0; off >>= 1) term += __shfl_xor_sync(0xffffffffu, term, off);
  if (lane == 0) out[b] = 0.5f * term;
}

}  // namespace

extern "C" int fm_interaction_f32(const void* e, void* out, int B, int F, int k, void* stream) {
  const unsigned blocks = static_cast<unsigned>((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  fm_interaction_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<float*>(out), B, F, k);
  return static_cast<int>(cudaGetLastError());
}
