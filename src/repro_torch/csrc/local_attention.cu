// Windowed (local) attention for Hopper (sm_90a), the paper's C2 pattern:
//   out[r,i] = Σ_j softmax_j(q[r,i]·k[r,j] · dh^-½) · v[r,j]
// over the keys j with |i−j| < window, j < kv_len[r] (when kv_len is
// given) and, if causal, j ≤ i; q, k, v and out are [BH, L, dh], f32 or
// bf16, with dh = 16, 32, 64 or 128.
//
// Replaces the TPU kernel repro/kernels/local_attention/local_attention.py:
// local_attention (Pallas, `_kernel`): there a grid step (bh, query block,
// relative key block) adds one 128-key block to a running max, normaliser
// and accumulator kept in VMEM across the sequential key axis; out-of-range
// key blocks are clamped by the index map and masked afterwards, L must
// divide by 128, and there is no key mask. Here any L >= 1 runs, and the
// key mask of repro's taobao_ssa encoder (`kv_len`) is applied in the
// kernel. A query row with no valid key (kv_len ≤ 0, or i ≥ kv_len +
// window − 1) gets what repro's model gives it: every score is −1e30 there,
// the softmax is uniform over all L keys, and the row is the mean of v
// over all L positions.
//
// What bounds it: at the ranker's call (BH = 4 heads x 512 requests,
// L = 100, dh = 16, window 32) q, k, v and out are 52.4 MB, 0.016 ms at
// 3.35 TB/s, against about 0.8 GFLOP of f32 work; at the kernel benchmark's
// shape (BH 8, L 2048, dh 64, window 256) 2.1 GFLOP, 0.032 ms at 67 TFLOP/s
// outside the tensor cores, against 16.8 MB. The products run in f32 on
// the CUDA cores: the reference is f32, and TF32 tensor cores would keep
// only about three decimal digits.
//
// What the design does about it:
//   * a block owns 64 query rows of one (b, h); dh/16 neighbouring lanes
//     share a row, each keeping 16 of its q (scaled by dh^-½) and of its
//     accumulator in registers; a row's score is summed over those lanes
//     with warp shuffles;
//   * the block walks only the keys its rows' windows reach, 32 at a time:
//     each tile of K and V is staged in shared memory as f32 (out-of-range
//     rows as 0), and each key's validity is decided from its absolute
//     position, so a tile past the window or past kv_len adds nothing;
//   * the softmax is online: a tile's scores, their max, one rescale of
//     the running sum and accumulator, all in f32 with expf;
//   * rows with no valid key take the column mean of v, which the block
//     sums in key order only when one of its rows needs it.
//   Every sum runs in a fixed order, so a result does not change from run
//   to run. Tensor cores (wgmma) and TMA are later work.
//
// Interface: plain C, loaded with ctypes (kernels/local_attention/
// local_attention.py). All arrays contiguous; kv_len int32 [BH] or null;
// BH, L, window >= 1. Anything else returns cudaErrorInvalidValue and
// launches nothing. It launches on `stream`, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after the launch
// (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;   // query rows a block
constexpr int kBK = 32;   // keys a shared-memory tile
constexpr int kDPT = 16;  // head dims a lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kBQ * (DH / kDPT))
local_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ kv_len,
                       T* __restrict__ out, int L, int window, int causal, float scale) {
  constexpr int kTPR = DH / kDPT;            // lanes a query row: 1, 2, 4 or 8
  constexpr int kThreads = kBQ * kTPR;
  __shared__ __align__(16) float ks[kBK][DH];
  __shared__ __align__(16) float vs[kBK][DH];
  __shared__ float vmean[DH];

  const int tid = threadIdx.x;
  const int part = tid % kTPR;               // which 16 dims of the row
  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int i = q0 + tid / kTPR;             // this lane's query row
  const bool live = i < L;
  const int klen = kv_len != nullptr ? min(kv_len[bh], L) : L;  // keys j < klen exist
  // the row's valid keys are lo..hi; none where lo > hi
  const int lo = max(0, i - window + 1);
  const int hi = min(klen - 1, causal ? i : i + window - 1);
  const bool empty = live && lo > hi;
  const long long base = bh * L * DH;

  float qr[kDPT], acc[kDPT];
#pragma unroll
  for (int d = 0; d < kDPT; ++d) {
    qr[d] = live ? to_f32(q[base + static_cast<long long>(i) * DH + part * kDPT + d]) * scale
                 : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;  // running max of the valid scores
  float l = 0.f;        // running sum of exp(score − m)

  // keys any row of this block can reach
  const int q_last = min(q0 + kBQ, L) - 1;
  const int k_begin = max(0, q0 - window + 1);
  const int k_end = min(klen, (causal ? q_last : q_last + window - 1) + 1);  // exclusive

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int c = e / DH, d = e % DH;
      const int j = kt + c;
      const bool in = j < k_end;
      const long long at = base + static_cast<long long>(j) * DH + d;
      ks[c][d] = in ? to_f32(k[at]) : 0.f;
      vs[c][d] = in ? to_f32(v[at]) : 0.f;
    }
    __syncthreads();

    // every lane takes part in the shuffles; only valid keys count
    float s[kBK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int c = 0; c < kBK; ++c) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[c][part * kDPT]);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kDPT / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
#pragma unroll
      for (int off = kTPR / 2; off >= 1; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int j = kt + c;
      s[c] = (live && j >= lo && j <= hi) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[c]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;  // no valid key for this row yet
    const float alpha = expf(m - m_new);  // 0 while m is still −inf
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kDPT; ++d) acc[d] *= alpha;
#pragma unroll
    for (int c = 0; c < kBK; ++c) {
      const float p = expf(s[c] - m_new);  // 0 for an invalid key
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(&vs[c][part * kDPT]);
#pragma unroll
      for (int d4 = 0; d4 < kDPT / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m = m_new;
  }

  // rows with no valid key: the mean of v over all L keys, summed in order
  if (__syncthreads_or(empty)) {
    for (int d = tid; d < DH; d += kThreads) {
      float sum = 0.f;
      for (int j = 0; j < L; ++j) sum += to_f32(v[base + static_cast<long long>(j) * DH + d]);
      vmean[d] = sum / static_cast<float>(L);
    }
    __syncthreads();
  }
  if (!live) return;
  T* o = out + base + static_cast<long long>(i) * DH + part * kDPT;
#pragma unroll
  for (int d = 0; d < kDPT; ++d) o[d] = from_f32<T>(empty ? vmean[part * kDPT + d] : acc[d] / l);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* out, int BH,
           int L, int window, int causal, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>((L + kBQ - 1) / kBQ));
  local_attention_kernel<T, DH><<<grid, kBQ * (DH / kDPT), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(out), L, window, causal,
      1.0f / sqrtf(static_cast<float>(DH)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kv_len, void* out, int BH,
             int L, int dh, int window, int causal, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, kv_len, out, BH, L, window, causal, stream);
    case 32: return launch<T, 32>(q, k, v, kv_len, out, BH, L, window, causal, stream);
    case 64: return launch<T, 64>(q, k, v, kv_len, out, BH, L, window, causal, stream);
    case 128: return launch<T, 128>(q, k, v, kv_len, out, BH, L, window, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int local_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* out, int BH, int L, int dh,
                                   int window, int causal, int bf16, void* stream) {
  if (BH < 1 || L < 1 || window < 1 || (L + kBQ - 1) / kBQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  window = window < L ? window : L;  // |i − j| < L always: a wider window changes nothing
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, kv_len, out, BH, L, dh, window, causal, s)
              : dispatch<float>(q, k, v, kv_len, out, BH, L, dh, window, causal, s);
}
