// Windowed (local) attention for Hopper (sm_90a), the paper's C2 pattern:
//   out[b,h,i] = Σ_j softmax_j(q[b,h,i]·k[b,h,j] · dh^-½) · v[b,h,j]
// over the keys j with |i−j| < window, j < kv_len[b] (when kv_len is
// given) and, if causal, j ≤ i; q, k, v and out are [B, H, L, dh] views
// with any strides whose last dimension is contiguous, f32 or bf16, with
// dh = 16, 32, 64 or 128.
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
// What bounds it: at the ranker's call (B 512, H 4, L 100, dh 16, window
// 32, histories of 25 to 100) the bytes it must move, about 45 MB, 0.013 ms
// at 3.35 TB/s. Its f32 products, about 0.3 G multiply-adds, take as long
// again on the CUDA cores, and there each one also needs its operand from
// shared memory: a kernel with a lane a row and its keys in shared memory
// is held by those loads, not by bytes. At the kernel benchmark's shape
// (BH 8, L 2048, dh 64, window 256) 2.1 GFLOP.
//
// What the design does about it:
//   * the products run on the tensor cores as 3xTF32 with
//     mma.sync.m16n8k8: a = hi + lo, both rounded to TF32, hi·hi + hi·lo +
//     lo·hi, the small terms first. That keeps f32's accuracy (chip_smoke
//     holds it against the function in f64), where TF32 alone keeps about
//     three digits. Each
//     k-step of q·kᵀ is its own chain of three products, and p·v a fresh
//     fragment each 8 keys, each then added to f32 registers;
//   * the k index of both products is permuted within each 8: fragment
//     column t is dim (or key) 2t, column t + 4 is 2t + 1. A lane then reads
//     a row of q or k two dims at a time, and the scores' C fragment is
//     already the A fragment of p·v: no shuffle moves the probabilities;
//   * a warp owns 16 neighbouring query rows (the mma's m16) and walks only
//     the keys their windows reach (63 + 15 at window 32), 8 at a time, with
//     masks only where a key lies outside some row's window: the score
//     tile, an online softmax per row in base 2 (q is scaled by
//     log2(e)/√dh; max by quad shuffles; ex2.approx), then p·v. The
//     accumulator stays in registers, 64 of them a thread at dh 16, so
//     that eight blocks of four warps share an SM and hide one another's
//     latency;
//   * a block owns one (b, h) and a tile of up to 64 query rows; its key
//     span is staged in shared memory with cp.async, in one tile where it
//     fits (at the ranker's call, all of it) or in double-buffered tiles
//     with one barrier a tile; rows of k and v are padded so that a
//     fragment's loads fall in other banks;
//   * strides in, strides out: the model's q, k and v are transposed views
//     of [B, L, H, dh] projections, and the output is written through the
//     strides the caller gives (the wrapper returns a view of [B, L, H, dh]),
//     so nothing is copied around the kernel;
//   * rows with no valid key take the mean of v over L, summed by the block
//     in a fixed order of segments, read while the tile arrives and only in
//     a block that has such a row; such rows read no q.
//   Every sum runs in a fixed order, so a result does not change from run
//   to run. bf16 inputs are exact in TF32, so they take the same path.
//
// Interface: plain C, loaded with ctypes (kernels/local_attention/
// local_attention.py, whose `launch_plan` gives warps, rows and keys a
// block). `strides` holds 12 int64 element strides, (b, h, l) of q, k, v
// and out; every base and every such stride 16-byte aligned (the caller
// checks); kv_len int32 [B] or null. Anything else returns
// cudaErrorInvalidValue and launches nothing. It launches on `stream`,
// does not synchronise, allocates nothing, and returns the first CUDA
// error of the attribute call or the launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kRowsAWarp = 16;  // the mma's m16
constexpr int kMaxWarps = 4;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxSmem = 232448 - 8192;  // a block's 227 KB, less the static `red`

struct Strides {
  long long q[3], k[3], v[3], o[3];  // (b, h, l), in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero:
// what cvt.rna.tf32.f32 does, in two integer operations.
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }

// a = hi + lo, both TF32: hi = rna(a), lo = rna(a − hi)
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(__float_as_uint(a));
  lo = rna_tf32(__float_as_uint(a - __uint_as_float(hi)));
}

// 2^x (ex2.approx: 2 ulp; results below 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Staged rows of k and v, in elements: k's dh + 8 (a B fragment of q·kᵀ
// reads keys g = 0..7 at dims 2t, 2t + 1: 8-byte loads that a stride of 8
// words mod 16 puts in other banks); v's dh + 4 in f32 (keys 2t and 2t + 1
// at dim g: 4 mod 16 words), dh + 8 in bf16 (16-byte rows). Mirrors
// kernels/local_attention/local_attention.py:row_strides.
template <typename T> __host__ __device__ constexpr int k_stride(int dh) { return dh + 8; }
template <typename T> __host__ __device__ constexpr int v_stride(int dh) {
  return sizeof(T) == 4 ? dh + 4 : dh + 8;
}

// The keys a block of `rows` query rows can reach, at most.
__host__ __device__ inline int block_span(int L, int rows, int window, int causal) {
  const int span = rows + (window - 1) * (causal ? 1 : 2);
  return span < L ? span : L;
}

// Registers a thread may take: 64 at dh 16 and 32 (eight blocks of 128
// threads an SM: latency is hidden by warps in flight), 128 at dh 64 (the
// accumulator and q's fragments grow with dh), all at dh 128.
template <typename T, int DH>
__global__ void __launch_bounds__(kMaxThreads, DH <= 32 ? 8 : (DH == 64 ? 4 : 2))
local_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ kv_len,
                       T* __restrict__ out, Strides st, int H, int L, int window, int causal,
                       int rows_per_block, int keys_per_tile, int buffers, float scale) {
  constexpr int KS = DH / 8;  // k-steps of q·kᵀ; n-tiles of p·v
  constexpr int KST = k_stride<T>(DH), VST = v_stride<T>(DH);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);  // [buffers][k: keys x KST, v: keys x VST]
  const int buf_elems = keys_per_tile * (KST + VST);
  __shared__ float red[kMaxThreads + DH];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma's group and thread-in-group
  const long long bh = blockIdx.x;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  T* ob = out + b * st.o[0] + h * st.o[1];
  const int klen = kv_len != nullptr ? min(max(kv_len[b], 0), L) : L;  // keys j < klen exist

  const int q0 = blockIdx.y * rows_per_block;
  const int q_last = min(q0 + rows_per_block, L) - 1;
  const int blo = max(0, q0 - window + 1);  // the block's keys blo..bhi
  const int bhi = min(klen - 1, causal ? q_last : q_last + window - 1);
  const int n_tiles = bhi >= blo ? (bhi - blo + keys_per_tile) / keys_per_tile : 0;

  auto stage = [&](int tile) {
    T* ks_ = kv_s + (tile % buffers) * buf_elems;
    T* vs_ = ks_ + keys_per_tile * KST;
    const int j0 = blo + tile * keys_per_tile;
    const int n = min(keys_per_tile, bhi + 1 - j0);
    constexpr int CH = DH * static_cast<int>(sizeof(T)) / 16;  // 16-byte copies a row
    for (int e = tid; e < 2 * n * CH; e += blockDim.x) {
      const int which = e / (n * CH), rest = e % (n * CH);
      const int c = rest / CH, ch = rest % CH;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          (which ? vb : kb) + static_cast<long long>(j0 + c) * (which ? st.v[2] : st.k[2]));
      T* dst = which ? vs_ + c * VST : ks_ + c * KST;
      cp_async16(reinterpret_cast<unsigned char*>(dst) + ch * 16, src + ch * 16);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) stage(0);  // in flight while q is read

  const int w0 = q0 + warp * kRowsAWarp;  // the warp's first row
  // this lane's two rows (the fragments' g and g + 8) and their valid keys lo..hi
  int row[2], lo[2], hi[2];
  bool live[2], empty[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    row[x] = w0 + g + 8 * x;
    live[x] = row[x] <= q_last;
    lo[x] = max(0, row[x] - window + 1);
    hi[x] = min(klen - 1, causal ? row[x] : row[x] + window - 1);
    empty[x] = live[x] && lo[x] > hi[x];
  }
  const int w_last = min(w0 + kRowsAWarp - 1, q_last);  // the warp's keys wlo..whi
  const int wlo = max(0, w0 - window + 1);
  const int whi = w0 <= q_last ? min(klen - 1, causal ? w_last : w_last + window - 1) : -1;
  // keys every live row of the warp takes (no mask needed there); rows past
  // the block are never written, so their scores need none
  const int all_lo = max(0, w_last - window + 1);
  const int all_hi = min(klen - 1, causal ? w0 : w0 + window - 1);

  // q as A fragments, scaled by log2(e)/√dh (the softmax runs in base 2) and
  // split. The k index of q·kᵀ is permuted within each k-step: column t of
  // the fragment is dim 2t, column t + 4 dim 2t + 1, for q as for k, so
  // that a lane reads a key's two dims at once. a0, a2: row g; a1, a3: g + 8.
  // A row with no valid key reads no q.
  float qv[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = e & 1, d = ks * 8 + 2 * t + (e >> 1);
      qv[ks][e] = live[x] && !empty[x]
                      ? to_f32(qb[static_cast<long long>(row[x]) * st.q[2] + d]) : 0.f;
    }
  }
  // a live row with no valid key (i >= klen + window − 1) takes the mean of v
  // over all L keys: sums of segments of keys, read while the tile arrives
  const bool need_mean = klen == 0 || q_last >= klen + window - 1;  // block-uniform
  float* vmean = red + kMaxThreads;
  const int segs = blockDim.x / DH, seg = tid / DH, dm = tid % DH;
  if (need_mean && seg < segs) {
    const int per = (L + segs - 1) / segs, j0 = seg * per, j1 = min(L, j0 + per);
    float sum = 0.f;
#pragma unroll 8
    for (int j = j0; j < j1; ++j) sum += to_f32(vb[static_cast<long long>(j) * st.v[2] + dm]);
    red[seg * DH + dm] = sum;
  }
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split(qv[ks][e] * scale, qh[ks][e], ql[ks][e]);
  }
  float o[KS][4];  // p·v: n-tile nt holds dims nt*8 + 2t, + 1 of rows g (0, 1) and g + 8 (2, 3)
#pragma unroll
  for (int nt = 0; nt < KS; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the valid scores, by row
  float l[2] = {0.f, 0.f};              // this lane's share of the running sum of 2^(s − m)

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait_all();
    __syncthreads();  // tile `tile` is in; every warp is done with tile − 1's buffer
    if (tile + 1 < n_tiles) stage(tile + 1);
    const T* ks_ = kv_s + (tile % buffers) * buf_elems;
    const T* vs_ = ks_ + keys_per_tile * KST;
    const int j0 = blo + tile * keys_per_tile;
    const int k_lo = max(wlo, j0), k_hi = min(whi, j0 + keys_per_tile - 1);
    for (int kb0 = k_lo; kb0 <= k_hi; kb0 += 8) {  // warp-uniform
      // scores of keys kb0 + 2t, + 1 (the C fragment's columns) for rows g,
      // g + 8: each k-step its own chain of three products, then added
      const T* kr = ks_ + (min(kb0 + g, k_hi) - j0) * KST + 2 * t;  // key g, dims 2t, 2t + 1
      float part[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bh[2], bl[2];
        const float2 kk = load2(kr + ks * 8);
        split(kk.x, bh[0], bl[0]);
        split(kk.y, bh[1], bl[1]);
        part[ks][0] = part[ks][1] = part[ks][2] = part[ks][3] = 0.f;
        mma_3xtf32(part[ks], qh[ks], ql[ks], bh, bl);
      }
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) s[e] += part[ks][e];
      }
      if (kb0 < all_lo || kb0 + 7 > min(all_hi, k_hi)) {  // warp-uniform
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = e >> 1, c = kb0 + 2 * t + (e & 1);
          if (c > k_hi || c < lo[x] || c > hi[x]) s[e] = -INFINITY;
        }
      }
      float p[4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float mx = fmaxf(s[2 * x], s[2 * x + 1]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[x], mx);
        const float base = m_new == -INFINITY ? 0.f : m_new;  // no valid key yet: p = 0
        const float alpha = ex2(m[x] - base);                // 0 while m is −inf
        p[2 * x] = ex2(s[2 * x] - base);
        p[2 * x + 1] = ex2(s[2 * x + 1] - base);
        l[x] = l[x] * alpha + (p[2 * x] + p[2 * x + 1]);
#pragma unroll
        for (int nt = 0; nt < KS; ++nt) {
          o[nt][2 * x] *= alpha;
          o[nt][2 * x + 1] *= alpha;
        }
        m[x] = m_new;
      }
      // p as the A fragment of p·v, its k index (the keys) permuted as q·kᵀ's:
      // column t is key 2t, column t + 4 key 2t + 1, so the C fragment of the
      // scores is already in place: a0 = (g, 2t), a1 = (g + 8, 2t), a2 =
      // (g, 2t + 1), a3 = (g + 8, 2t + 1)
      uint32_t ah[4], al[4];
      split(p[0], ah[0], al[0]);
      split(p[2], ah[1], al[1]);
      split(p[1], ah[2], al[2]);
      split(p[3], ah[3], al[3]);
      // B fragment of v: keys 2t, 2t + 1 of the group, dim g of each n-tile
      const T* v0 = vs_ + (min(kb0 + 2 * t, k_hi) - j0) * VST + g;
      const T* v1 = vs_ + (min(kb0 + 2 * t + 1, k_hi) - j0) * VST + g;
#pragma unroll
      for (int nt = 0; nt < KS; ++nt) {
        uint32_t bh[2], bl[2];
        split(to_f32(v0[nt * 8]), bh[0], bl[0]);
        split(to_f32(v1[nt * 8]), bh[1], bl[1]);
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(pv, ah, al, bh, bl);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] += pv[e];
      }
    }
  }

  // a row's sum over its quad, in a fixed order (both halves get the same bits)
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
  }
  if (need_mean) {  // the segments' sums in order
    __syncthreads();
    if (tid < DH) {
      float sum = 0.f;
      for (int sg = 0; sg < segs; ++sg) sum += red[sg * DH + tid];
      vmean[tid] = sum / static_cast<float>(L);
    }
    __syncthreads();
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (!live[x]) continue;
    T* orow = ob + static_cast<long long>(row[x]) * st.o[2];
#pragma unroll
    for (int nt = 0; nt < KS; ++nt) {
      const int d = nt * 8 + 2 * t;
      if (empty[x]) {
        store2(orow + d, vmean[d], vmean[d + 1]);
      } else {
        store2(orow + d, o[nt][2 * x] / l[x], o[nt][2 * x + 1] / l[x]);
      }
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* out,
           const Strides& st, int B, int H, int L, int window, int causal, int warps,
           int rows_per_block, int keys_per_tile, cudaStream_t stream) {
  if (rows_per_block != warps * kRowsAWarp || 32 * warps < DH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int buffers = block_span(L, rows_per_block, window, causal) <= keys_per_tile ? 1 : 2;
  const size_t smem = static_cast<size_t>(buffers) * keys_per_tile *
                      (k_stride<T>(DH) + v_stride<T>(DH)) * sizeof(T);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      local_attention_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * H,
                  static_cast<unsigned>((L + rows_per_block - 1) / rows_per_block));
  local_attention_kernel<T, DH><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(out), st, H, L, window, causal,
      rows_per_block, keys_per_tile, buffers,
      1.4426950408889634f / sqrtf(static_cast<float>(DH)));  // log2(e)/√dh
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kv_len, void* out,
             const Strides& st, int B, int H, int L, int dh, int window, int causal, int warps,
             int rows, int keys, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, kv_len, out, st, B, H, L, window, causal, warps, rows, keys, s);
    case 32: return launch<T, 32>(q, k, v, kv_len, out, st, B, H, L, window, causal, warps, rows, keys, s);
    case 64: return launch<T, 64>(q, k, v, kv_len, out, st, B, H, L, window, causal, warps, rows, keys, s);
    case 128: return launch<T, 128>(q, k, v, kv_len, out, st, B, H, L, window, causal, warps, rows, keys, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// `warps`, `rows` (query rows a block) and `keys` (keys a staged tile) are
// the caller's plan (kernels/local_attention/local_attention.py:launch_plan).
extern "C" int local_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* out, const long long* strides,
                                   int B, int H, int L, int dh, int window, int causal, int bf16,
                                   int warps, int rows, int keys, void* stream) {
  if (B < 1 || H < 1 || L < 1 || window < 1 || warps < 1 || warps > kMaxWarps || keys < 1 ||
      (L + rows - 1) / rows > 65535 || static_cast<long long>(B) * H > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  window = window < L ? window : L;  // |i − j| < L always: a wider window changes nothing
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, kv_len, out, st, B, H, L, dh, window, causal,
                                        warps, rows, keys, s)
              : dispatch<float>(q, k, v, kv_len, out, st, B, H, L, dh, window, causal, warps,
                                rows, keys, s);
}
