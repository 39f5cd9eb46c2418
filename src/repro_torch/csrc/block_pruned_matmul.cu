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
// What bounds it: at the serve path's encoder calls (M = 51,200 tokens,
// K, N <= 256) the shapes say bytes: x and out alone are
// 26-66 MB, 8-20 us at 3.35 TB/s, against 2.5-5 us of f32-accurate products
// at 165 TFLOP/s (below). On the card the kernel is held back by how its
// tensor-core phases issue (mma.sync's dependent chains, below the rate
// mma.sync reaches with enough warps, itself below the 495 TFLOP/s that
// only wgmma reaches) and by each block's start (its panel of w), more
// than by bytes: with x warm in L2 it takes about as long. At M <= 512 (the tower,
// 256^3, 512^3) a call is a few microseconds, and its time goes with the
// bytes one SM has to pull: an SM keeps only so many loads in flight.
//
// The arithmetic: 3xTF32 on the tensor cores. Each operand is split as
// a = hi + lo, hi = rna_tf32(a), lo = rna_tf32(a - hi) (round to nearest,
// ties away from zero, at TF32's 10-bit mantissa: what cvt.rna.tf32.f32
// does, in two integer operations here, where ptxas would emulate the cvt
// in five), and x_lo*w_hi + x_hi*w_lo + x_hi*w_hi is taken with
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, the small terms first. The
// products of 16 columns of k sum into a fresh fragment, which is then
// added to the f32 accumulator with a rounded f32 add: chaining every
// product into the accumulator itself, as a GEMM usually does, lets the
// tensor core's truncating alignment against the large running sum cost
// several times the error (measured on the card). A term's error is about
// 2^-21 relative; over a sum of K >= 32 terms the product's error is
// within 2x that of an f32 matmul, below 32 it is not (measured on the
// card). So below K = 32, or for N < 8 (the tower's 80 x 1 output, where an
// n8 tile would be mostly padding), lanes of a warp compute a row in f32
// FMA on the CUDA cores ("rows" below), each lane's terms in blocks of 16.
// A column whose surviving stripes hold fewer than 32 rows of k in all (a
// ragged last stripe, alone) keeps the tensor cores and that per-term
// error. wgmma would need the split operands K-major in shared memory and
// a rewrite around its asynchronous warpgroups; that is the next step.
//
// Three kernels, and the wrapper picks one (`tile`) from the shape:
//
// The tall kernel (tile 1; the encoder's 51,200-token calls). A block owns
// 64 x 64 tiles of out: 8 warps of 16 rows x 32 columns. BN = 64 divides
// 128, so a block's columns lie in one column stripe of the mask. The
// block walks M tiles blockIdx.y, blockIdx.y + grid_m, ...:
//   * a surviving 128-row stripe of w is loaded into shared memory once,
//     split into hi/lo there in the mma B-fragment order (a lane writes and
//     later reads its {b0, b1} x {hi, lo} as one 16-byte access, free of
//     bank conflicts), and kept for every M tile; a column stripe with more
//     than one surviving stripe loads them in turn, every M tile (correct,
//     and slow: no path of the model has one);
//   * x comes in steps of 64 columns through a double buffer, by cp.async
//     (16 bytes a copy where K % 4 == 0 and x is 16-byte aligned, else 4;
//     rows and columns past the edge are zero-filled by the copy itself);
//     the next step's x is in flight while this one is multiplied and the
//     finished tile stored; the panel's loads go out before the first x;
//   * 3 blocks an SM (67 KB of shared memory for K <= 64, 99 KB above: 2).
//
// The small kernel (tiles 2 and 3: 32 x 64 and 32 x 32 of out; M <= 512 and
// the like). A tile's K is a chain of steps of 16 columns, so it is split
// twice: `splits` blocks of a thread-block cluster take contiguous runs of
// the steps, and inside a block 2 or 4 warp groups take every 2nd or 4th
// step of a round of 6 or 8. x and w both come through a ring of two
// rounds (both in flight) and are split in registers; two blocks fit an SM. At the end a block adds its groups'
// partial tiles in group order through shared memory, and the cluster's
// rank 0 adds the blocks' partial tiles in rank order, read from their
// shared memory (distributed shared memory), and stores the tile.
//
// All: pruned stripes are skipped, loads and products (the rows path adds
// fma(x, 0, acc) = acc there); a block whose stripes are all pruned writes
// its zeros. Out is written with one 16-byte store a lane where N % 4 == 0
// (elementwise at a ragged edge). Every sum runs in a fixed order (columns
// in k order, the three products in a fixed order, warp groups and cluster
// ranks in order, the rows path's lanes in a fixed shuffle tree), so two
// launches on the same inputs give the same bits. Each surviving stripe's
// mask entry is read once, by a lane of every warp (a ballot).
//
// Interface: plain C, loaded with ctypes (kernels/block_pruned_matmul/
// block_pruned_matmul.py). x, w, block_mask and out contiguous and
// row-major; M, K, N >= 1; tile 0 (rows), 1 (tall), 2 or 3 (small);
// 1 <= grid_m <= 65535 (blocks along M; the rows path ignores it); splits
// 1, or 2, 4 or 8 for tiles 2 and 3; tiles 1-3 need K >= 32. Anything else
// returns cudaErrorInvalidValue and launches nothing. It launches on
// `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 = launched).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;    // the mask's tile: repro's pruned_linear and prune_tree's
constexpr int kChunk = 16;     // columns of k whose products sum in one fragment: two k8 steps
constexpr int kRowsWarps = 4;  // warps a block on the rows path
constexpr int kRowsK = 4;      // terms of k a lane adds on the rows path: one 16-byte load
constexpr int kRowsBlock = 16;  // a rows-path lane's terms summed apart, then added
constexpr unsigned kFull = 0xffffffffu;

// round to nearest, ties away from zero, at TF32's 10-bit mantissa (the
// result is an f32 bit pattern whose low 13 bits are 0); finite inputs
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }

// a = hi + lo, each a TF32 value in an f32 register
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(__float_as_uint(a));
  lo = rna_tf32(__float_as_uint(a - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += x_lo*w_hi + x_hi*w_lo + x_hi*w_hi, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The block's place in the flat sequence of ring steps: M tile, surviving
// stripe, first column of the step.
struct Cursor {
  int mt, kb, k0;
};

// What a block knows of the mask: its column stripe, the stripes that
// survive. Every warp reads the column once, a lane a stripe, and keeps it
// as a bitmask (a ballot), so finding the next surviving stripe waits on
// no load; past 32 stripes (K > 4,096) the rest are read as they are needed.
struct Stripes {
  const int* col;  // block_mask + this block's column stripe; stride ncb
  int ncb, nkb, first, K;
  unsigned live;   // bit kb: stripe kb survives (kb < 32)
  __device__ __forceinline__ Stripes(const int* block_mask, int n0, int K_, int N)
      : col(block_mask + n0 / kBlock), ncb((N + kBlock - 1) / kBlock),
        nkb((K_ + kBlock - 1) / kBlock), first(0), K(K_) {
    const int lane = threadIdx.x & 31;
    live = __ballot_sync(kFull, lane < nkb && __ldg(col + static_cast<long long>(lane) * ncb) != 0);
    first = next_live(0);
  }
  __device__ __forceinline__ int next_live(int kb) const {
    if (kb < 32) {
      const unsigned rest = live >> kb;
      if (rest != 0 || nkb <= 32) return rest ? kb + __ffs(rest) - 1 : nkb;
      kb = 32;
    }
    while (kb < nkb && __ldg(col + static_cast<long long>(kb) * ncb) == 0) ++kb;
    return kb;
  }
  __device__ __forceinline__ int k_end(int kb) const { return min(K, (kb + 1) * kBlock); }
  template <int KSTEP>
  __device__ __forceinline__ int steps() const {  // ring steps of one M tile
    int n = 0;
    for (int kb = first; kb < nkb; kb = next_live(kb + 1))
      n += (k_end(kb) - kb * kBlock + KSTEP - 1) / KSTEP;
    return n;
  }
  template <int KSTEP>
  __device__ __forceinline__ void advance(Cursor& c, int stride) const {
    c.k0 += KSTEP;
    if (c.k0 < k_end(c.kb)) return;
    c.kb = next_live(c.kb + 1);
    if (c.kb >= nkb) {
      c.kb = first;
      c.mt += stride;
    }
    c.k0 = c.kb * kBlock;
  }
};

// Rows [m0, m0 + BM) and columns [k0, k0 + cols) of x (cols <= KSTEP, a
// multiple of 4) into a stage [BM][KSTEP + 4]; columns past K are zeros.
template <int BM, int KSTEP, int THREADS>
__device__ __forceinline__ void load_x(float* stage, const float* __restrict__ x, long long m0,
                                       int k0, int cols, int M, int K, bool vec_x) {
  constexpr int kLd = KSTEP + 4;
  if (vec_x) {
    const int per_row = cols / 4;
    for (int e = threadIdx.x; e < BM * per_row; e += THREADS) {
      const int r = e / per_row, k = k0 + (e % per_row) * 4;
      const bool ok = m0 + r < M && k < K;  // K % 4 == 0: a chunk is all in or all out
      cp_async16(stage + r * kLd + (k - k0), ok ? x + (m0 + r) * K + k : x, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BM * cols; e += THREADS) {
      const int r = e / cols, k = k0 + e % cols;
      const bool ok = m0 + r < M && k < K;
      cp_async4(stage + r * kLd + (k - k0), ok ? x + (m0 + r) * K + k : x, ok ? 4 : 0);
    }
  }
}

// Four neighbouring columns of one row from an m16n8 accumulator fragment:
// lanes t and t ^ 1 swap halves, so even lanes hold row g, odd lanes row
// g + 8. Returns the row offset (0 or 8) and the column offset in the tile.
__device__ __forceinline__ float4 row_quad(const float (&c)[4], int lane, int& dr, int& dc) {
  const int t = lane & 3;
  const bool odd = t & 1;
  const float r0 = __shfl_xor_sync(kFull, odd ? c[0] : c[2], 1);
  const float r1 = __shfl_xor_sync(kFull, odd ? c[1] : c[3], 1);
  dr = (lane >> 2) + (odd ? 8 : 0);
  dc = (t >> 1) * 4;
  return odd ? make_float4(r0, r1, c[2], c[3]) : make_float4(c[0], c[1], r0, r1);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ void store4(float* __restrict__ out, long long m, int n, int M, int N,
                                       float4 v, bool vec_out) {
  if (m >= M || n >= N) return;
  float* dst = out + m * N + n;
  if (vec_out) {
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    dst[0] = v.x;
    if (n + 1 < N) dst[1] = v.y;
    if (n + 2 < N) dst[2] = v.z;
    if (n + 3 < N) dst[3] = v.w;
  }
}

// ---------------------------------------------------------------- tall kernel

template <int BM, int BN, int WARPS_N, int KSTEP, int STAGES, int MIN_BLOCKS>
struct Tall {
  static constexpr int kBM = BM, kBN = BN, kKStep = KSTEP, kMinBlocks = MIN_BLOCKS;
  static constexpr int kWarpsN = WARPS_N;  // a warp: 16 rows x BN / WARPS_N columns
  static constexpr int kWarps = BM / 16 * WARPS_N;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kNB8 = BN / 8;       // n8 tiles of the block
  static constexpr int kNT = kNB8 / WARPS_N;  // n8 tiles of a warp
  static constexpr int kXLd = KSTEP + 4;  // 16-byte aligned rows, conflict-free A reads
  static constexpr int kStageFloats = BM * kXLd;
  static constexpr int kStages = STAGES;  // STAGES - 1 steps of x in flight
  static_assert(kBlock % BN == 0 && kBlock % KSTEP == 0 && KSTEP % kChunk == 0, "tile shape");
  static_assert(BM % 16 == 0 && BN % 8 == 0 && kXLd % 32 == 4, "tile shape");
  // rows of the panel, one surviving stripe: whole chunks, at most the mask's tile
  static __host__ __device__ int panel_rows(int K) {
    const int rows = (K + kChunk - 1) / kChunk * kChunk;
    return rows < kBlock ? rows : kBlock;
  }
  static __host__ __device__ int panel_floats(int K) { return panel_rows(K) * BN * 2; }  // hi, lo
  static int smem_bytes(int K) { return 4 * (panel_floats(K) + kStages * kStageFloats); }
};

// The surviving stripe `kb` of w into the panel, split into hi/lo in the
// mma B-fragment order: fragment f = (k8, n8, lane) is the float4
// {hi(k, n), hi(k + 4, n), lo(k, n), lo(k + 4, n)} at k = 8*k8 + lane % 4,
// n = 8*n8 + lane / 4, stored at float4 index f. `between` runs once, after
// the first batch of loads is issued and before any of it is used.
template <class T, class F>
__device__ __forceinline__ void load_panel(float* panel, const float* __restrict__ w,
                                           const Stripes& s, int kb, int N, int n0, F&& between) {
  constexpr int kBatch = 8;  // fragments a thread loads before it splits any: 16 loads in flight
  const int frags = T::panel_rows(s.K) / 8 * T::kNB8 * 32;
  float4* dst = reinterpret_cast<float4*>(panel);
  for (int base = 0; base < frags; base += kBatch * T::kThreads) {
    float v[kBatch][2];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int f = base + i * T::kThreads + threadIdx.x;
      const int lane = f & 31, n8 = (f >> 5) % T::kNB8, k8 = (f >> 5) / T::kNB8;
      const long long k = static_cast<long long>(kb) * kBlock + k8 * 8 + (lane & 3);
      const int n = n0 + n8 * 8 + (lane >> 2);
      const bool in = f < frags && n < N;
      v[i][0] = in && k < s.K ? __ldg(w + k * N + n) : 0.f;
      v[i][1] = in && k + 4 < s.K ? __ldg(w + (k + 4) * N + n) : 0.f;
    }
    if (base == 0) between();
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int f = base + i * T::kThreads + threadIdx.x;
      if (f >= frags) break;
      uint32_t h0, l0, h1, l1;
      split(v[i][0], h0, l0);
      split(v[i][1], h1, l1);
      dst[f] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                           __uint_as_float(l1));
    }
  }
}

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
block_pruned_matmul_tall_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                const int* __restrict__ block_mask, float* __restrict__ out,
                                int M, int K, int N, bool vec_x, bool vec_out) {
  constexpr int BM = T::kBM, BN = T::kBN, NT = T::kNT, NB8 = T::kNB8, KSTEP = T::kKStep;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int wm = (threadIdx.x >> 5) / T::kWarpsN, wn = (threadIdx.x >> 5) % T::kWarpsN;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m_tiles = (M + BM - 1) / BM, stride = gridDim.y;
  const Stripes s(block_mask, n0, K, N);

  float acc[NT][4];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[ni][r] = 0.f;

  const auto store_tile = [&](int mt) {
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      int dr, dc;
      const float4 v = row_quad(acc[ni], lane, dr, dc);
      store4(out, static_cast<long long>(mt) * BM + wm * 16 + dr, n0 + (wn * NT + ni) * 8 + dc, M,
             N, v, vec_out);
    }
  };
  if (s.first >= s.nkb) {  // every stripe of this column stripe pruned: zeros
    for (int mt = blockIdx.y; mt < m_tiles; mt += stride) store_tile(mt);
    return;
  }

  float* panel = smem;
  float* ring = smem + T::panel_floats(K);
  // columns of a step: whole 16-column chunks, up to KSTEP, inside its stripe
  const auto step_cols = [&](const Cursor& c) {
    return min(KSTEP, (s.k_end(c.kb) - c.k0 + kChunk - 1) / kChunk * kChunk);
  };
  const auto issue = [&](const Cursor& c, int stage) {
    if (c.mt < m_tiles)
      load_x<BM, KSTEP, T::kThreads>(ring + stage * T::kStageFloats, x,
                                     static_cast<long long>(c.mt) * BM, c.k0, step_cols(c), M, K,
                                     vec_x);
    cp_async_commit();
  };

  Cursor p{static_cast<int>(blockIdx.y), s.first, s.first * kBlock};  // producer
  Cursor c = p;                                                         // consumer
  int loaded = s.first;  // the stripe in the panel
  // the panel's first loads go out before the x of the first steps, so they
  // do not wait behind every block's x
  load_panel<T>(panel, w, s, loaded, N, n0, [&] {
    for (int i = 0; i < T::kStages - 1; ++i) {
      issue(p, i);
      s.advance<KSTEP>(p, stride);
    }
  });

#pragma unroll 1
  for (int step = 0; c.mt < m_tiles; ++step) {
    if (c.kb != loaded) {  // a tile with two or more surviving stripes: the next one
      __syncthreads();     // every warp is done with the panel
      loaded = c.kb;
      load_panel<T>(panel, w, s, loaded, N, n0, [] {});
    }
    cp_async_wait<T::kStages - 2>();
    __syncthreads();  // this step's x has landed; every warp is done with the stage it refills
    issue(p, (step + T::kStages - 1) % T::kStages);
    s.advance<KSTEP>(p, stride);

    const float* xs = ring + (step % T::kStages) * T::kStageFloats + (wm * 16 + g) * T::kXLd + t;
    const float4* pan = reinterpret_cast<const float4*>(panel) +
                        (((c.k0 - c.kb * kBlock) >> 3) * NB8 + wn * NT) * 32 + lane;
    const int chunks = step_cols(c) / kChunk;
#pragma unroll 1
    for (int q = 0; q < chunks; ++q) {
      float d[NT][4];  // the chunk's products, added to acc once
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) d[ni][r] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        const float* a = xs + q * kChunk + ks * 8;
        uint32_t ah[4], al[4];
        split(a[0], ah[0], al[0]);
        split(a[8 * T::kXLd], ah[1], al[1]);
        split(a[4], ah[2], al[2]);
        split(a[8 * T::kXLd + 4], ah[3], al[3]);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const float4 b = pan[((q * 2 + ks) * NB8 + ni) * 32];
          mma_3xtf32(d[ni], ah, al, __float_as_uint(b.x), __float_as_uint(b.y),
                     __float_as_uint(b.z), __float_as_uint(b.w));
        }
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[ni][r] += d[ni][r];
    }

    const int mt = c.mt;
    s.advance<KSTEP>(c, stride);
    if (c.mt != mt) {  // the M tile is done: store it, start the next from zero
      store_tile(mt);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[ni][r] = 0.f;
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// --------------------------------------------------------------- small kernel

// A block: BM x BN of out, WM x WN warps over the tile, WK warp groups over
// the steps of K (group v takes steps v, v + WK, ... of each round of ROUND).
template <int BM, int BN, int WM, int WN, int WK, int ROUND>
struct Small {
  static constexpr int kBM = BM, kBN = BN, kWM = WM, kWN = WN, kWK = WK;
  static constexpr int kWarps = WM * WN * WK;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kMT = BM / WM / 16, kNT = BN / WN / 8;  // mma tiles a warp
  static constexpr int kKStep = kChunk;            // a step: one chunk of 16 columns
  static constexpr int kRound = ROUND;             // steps a round
  static constexpr int kStages = 2 * kRound;       // two rounds in flight
  static constexpr int kXLd = kKStep + 4;          // 80-byte rows: conflict-free A reads
  static constexpr int kWLd = BN + 8;              // w stage rows: conflict-free B reads
  static constexpr int kStageFloats = BM * kXLd + kKStep * kWLd;
  static_assert(kBlock % BN == 0 && kMT >= 1 && kNT >= 1 && kWLd % 32 != 0 && kRound % WK == 0,
                "tile shape");
  static_assert(WK * BM * BN <= kStages * kStageFloats, "the reduction reuses the ring");
  static int smem_bytes() { return 4 * kStages * kStageFloats; }
};

// Rows [k0, k0 + 16) and columns [n0, n0 + BN) of w into a stage [16][kWLd].
template <class T>
__device__ __forceinline__ void load_w(float* stage, const float* __restrict__ w, int k0, int n0,
                                       int K, int N, bool vec_w) {
  constexpr int kBK = T::kKStep;
  if (vec_w) {
    for (int e = threadIdx.x; e < kBK * (T::kBN / 4); e += T::kThreads) {
      const int r = e / (T::kBN / 4), n = n0 + (e % (T::kBN / 4)) * 4;
      const bool ok = k0 + r < K && n < N;  // N % 4 == 0
      cp_async16(stage + r * T::kWLd + (n - n0),
                 ok ? w + static_cast<long long>(k0 + r) * N + n : w, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kBK * T::kBN; e += T::kThreads) {
      const int r = e / T::kBN, n = n0 + e % T::kBN;
      const bool ok = k0 + r < K && n < N;
      cp_async4(stage + r * T::kWLd + (n - n0),
                ok ? w + static_cast<long long>(k0 + r) * N + n : w, ok ? 4 : 0);
    }
  }
}

template <class T>
__global__ void __launch_bounds__(T::kThreads)
block_pruned_matmul_small_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                 const int* __restrict__ block_mask, float* __restrict__ out,
                                 int M, int K, int N, bool vec_x, bool vec_w, bool vec_out) {
  constexpr int BM = T::kBM, BN = T::kBN, MT = T::kMT, NT = T::kNT, WK = T::kWK;
  constexpr int KSTEP = T::kKStep, kXLd = T::kXLd, R = T::kRound;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wk = warp / (T::kWM * T::kWN), wm = warp % (T::kWM * T::kWN) / T::kWN,
            wn = warp % T::kWN;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m_tiles = (M + BM - 1) / BM;
  const Stripes s(block_mask, n0, K, N);
  // this block's share of the steps: the cluster's blocks (along z) split
  // them in contiguous runs, in rank order
  const int all_steps = s.first < s.nkb ? s.steps<KSTEP>() : 0;
  const int splits = gridDim.z, rank = blockIdx.z;
  const int begin = all_steps * rank / splits;
  const int steps = all_steps * (rank + 1) / splits - begin;
  const int rounds = (steps + R - 1) / R;

  for (int mt = blockIdx.y; mt < m_tiles; mt += gridDim.y) {
    const long long m0 = static_cast<long long>(mt) * BM;
    float acc[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

    // round r's steps in half r % 2 of the ring, its step j in stage j of the half
    Cursor p{0, s.first, s.first * kBlock};
    for (int i = 0; i < begin; ++i) s.advance<KSTEP>(p, 1);
    const auto issue_round = [&](int r) {
      for (int j = 0; j < R && r * R + j < steps; ++j, s.advance<KSTEP>(p, 1)) {
        float* st = smem + ((r % 2) * R + j) * T::kStageFloats;
        load_x<BM, KSTEP, T::kThreads>(st, x, m0, p.k0, KSTEP, M, K, vec_x);
        load_w<T>(st + BM * kXLd, w, p.k0, n0, K, N, vec_w);
      }
      cp_async_commit();
    };
    issue_round(0);
    issue_round(1);
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
      cp_async_wait<1>();
      __syncthreads();  // round r has landed
#pragma unroll
      for (int j = wk; j < R; j += WK) {
        if (r * R + j >= steps) break;
        const float* st = smem + ((r % 2) * R + j) * T::kStageFloats;
        const float* xs = st + (wm * MT * 16 + g) * kXLd + t;
        const float* ws = st + BM * kXLd + t * T::kWLd + wn * NT * 8 + g;
        float d[MT][NT][4];  // the step's products, added to acc once
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
#pragma unroll
            for (int q = 0; q < 4; ++q) d[mi][ni][q] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEP / 8; ++ks) {
          uint32_t ah[MT][4], al[MT][4];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            const float* a = xs + mi * 16 * kXLd + ks * 8;
            split(a[0], ah[mi][0], al[mi][0]);
            split(a[8 * kXLd], ah[mi][1], al[mi][1]);
            split(a[4], ah[mi][2], al[mi][2]);
            split(a[8 * kXLd + 4], ah[mi][3], al[mi][3]);
          }
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
            uint32_t bh0, bl0, bh1, bl1;
            split(ws[ks * 8 * T::kWLd + ni * 8], bh0, bl0);
            split(ws[(ks * 8 + 4) * T::kWLd + ni * 8], bh1, bl1);
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
              mma_3xtf32(d[mi][ni], ah[mi], al[mi], bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mi][ni][q] += d[mi][ni][q];
      }
      __syncthreads();  // every warp is done with half r % 2
      issue_round(r + 2);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: it holds the warp groups' partial tiles now

    // group v's partial tile at red[v][BM][BN]; then their sum in group order
    float* red = smem;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        int dr, dc;
        const float4 v = row_quad(acc[mi][ni], lane, dr, dc);
        *reinterpret_cast<float4*>(red + (wk * BM + (wm * MT + mi) * 16 + dr) * BN +
                                   (wn * NT + ni) * 8 + dc) = v;
      }
    __syncthreads();
    for (int e = threadIdx.x; e < BM * BN / 4; e += T::kThreads) {
      float4 sum = reinterpret_cast<const float4*>(red)[e];
#pragma unroll
      for (int v = 1; v < WK; ++v) sum = add4(sum, reinterpret_cast<const float4*>(red + v * BM * BN)[e]);
      const int row = (4 * e) / BN, col = (4 * e) % BN;
      if (splits == 1) {
        store4(out, m0 + row, n0 + col, M, N, sum, vec_out);
      } else {
        reinterpret_cast<float4*>(red)[e] = sum;  // the block's partial tile, for rank 0
      }
    }
    if (splits > 1) {  // rank 0 adds the cluster's partial tiles in rank order
      namespace cg = cooperative_groups;
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // every block's partial tile is in its shared memory
      if (rank == 0) {
        for (int e = threadIdx.x; e < BM * BN / 4; e += T::kThreads) {
          float4 sum = reinterpret_cast<const float4*>(red)[e];
          for (int v = 1; v < splits; ++v)
            sum = add4(sum, reinterpret_cast<const float4*>(cluster.map_shared_rank(red, v))[e]);
          const int row = (4 * e) / BN, col = (4 * e) % BN;
          store4(out, m0 + row, n0 + col, M, N, sum, vec_out);
        }
      }
      cluster.sync();  // rank 0 is done reading the others' shared memory
    }
    __syncthreads();  // red is read before the next M tile's loads overwrite it
  }
}

// ---------------------------------------------------------------- rows kernel

// N < 8 or K < 32: `lanes` lanes a row of out (32 / lanes rows a warp);
// `nl` of them over n, lanes / nl over k, a lane's k in runs of VK
// neighbouring columns (one 16-byte load of x where VK = 4); each lane's
// terms in k order, kRowsBlock at a time into a partial sum that is then
// added to the lane's (a blocked sum: an f32 error that grows with K /
// kRowsBlock additions, not K), then a fixed shuffle tree over the k lanes.
template <int VK>
__global__ void __launch_bounds__(kRowsWarps * 32)
block_pruned_matmul_rows_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                const int* __restrict__ block_mask, float* __restrict__ out,
                                int M, int K, int N, int lanes, int nl) {
  // lanes and nl are powers of two: shifts and masks, not divisions
  const int log_lanes = __ffs(lanes) - 1, log_nl = __ffs(nl) - 1;
  const int lane = threadIdx.x & 31, lr = lane & (lanes - 1);
  const long long m = (((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5)
                       << (5 - log_lanes)) + (lane >> log_lanes);
  const int kl = lanes >> log_nl, ln = lr & (nl - 1), lk = lr >> log_nl;
  const int ncb = (N + kBlock - 1) / kBlock, nkb = (K + kBlock - 1) / kBlock;
  const float* xr = x + m * K;
  for (int n_base = 0; n_base < N; n_base += nl) {  // rows past M still take part in the tree
    const int n = n_base + ln;
    float acc = 0.f, part = 0.f;
    int terms = 0;
    if (m < M && n < N) {
      for (int kb = 0; kb < nkb; ++kb) {
        // the mask, x and w are read together (one round trip, not two); a
        // pruned stripe adds fma(x, 0, part) = part
        const bool live = __ldg(block_mask + kb * ncb + n / kBlock) != 0;
        const int k_end = min(K, (kb + 1) * kBlock);
#pragma unroll 2
        for (int k = kb * kBlock + lk * VK; k < k_end; k += kl * VK) {
          float xv[VK];
          if constexpr (VK == 4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(xr + k));  // K % 4 == 0
            xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w;
          } else {
            xv[0] = __ldg(xr + k);
          }
#pragma unroll
          for (int j = 0; j < VK; ++j) {
            const float wv = __ldg(w + static_cast<long long>(k + j) * N + n);
            part = fmaf(xv[j], live ? wv : 0.f, part);
          }
          if ((terms += VK) >= kRowsBlock) {
            acc += part;
            part = 0.f;
            terms = 0;
          }
        }
      }
    }
    acc += part;
    for (int off = lanes / 2; off >= nl; off >>= 1) acc += __shfl_down_sync(kFull, acc, off, lanes);
    if (lk == 0 && m < M && n < N) out[m * N + n] = acc;
  }
}

// ------------------------------------------------------------------- launches

template <class Kernel>
int allow_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed = bytes;
  return static_cast<int>(e);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class T>
int launch_tall(const float* x, const float* w, const int* bm, float* out, int M, int K, int N,
                int grid_m, cudaStream_t stream) {
  const auto kernel = block_pruned_matmul_tall_kernel<T>;
  static int allowed = 0;
  const int smem = T::smem_bytes(K);
  if (const int e = allow_smem(kernel, smem, allowed)) return e;
  const int n_tiles = (N + T::kBN - 1) / T::kBN, m_tiles = (M + T::kBM - 1) / T::kBM;
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(grid_m < m_tiles ? grid_m : m_tiles));
  kernel<<<grid, T::kThreads, smem, stream>>>(x, w, bm, out, M, K, N, K % 4 == 0 && aligned16(x),
                                              N % 4 == 0 && aligned16(out));
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_small(const float* x, const float* w, const int* bm, float* out, int M, int K, int N,
                 int grid_m, int splits, cudaStream_t stream) {
  const auto kernel = block_pruned_matmul_small_kernel<T>;
  static int allowed = 0;
  const int smem = T::smem_bytes();
  if (const int e = allow_smem(kernel, smem, allowed)) return e;
  const int n_tiles = (N + T::kBN - 1) / T::kBN, m_tiles = (M + T::kBM - 1) / T::kBM;
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_tiles),
                     static_cast<unsigned>(grid_m < m_tiles ? grid_m : m_tiles),
                     static_cast<unsigned>(splits));
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;  // the blocks that split one tile's K form a cluster
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = static_cast<unsigned>(splits);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const bool vec_x = K % 4 == 0 && aligned16(x), vec_w = N % 4 == 0 && aligned16(w),
             vec_out = N % 4 == 0 && aligned16(out);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, w, bm, out, M, K, N, vec_x, vec_w, vec_out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// <BM, BN, warps along N, columns a step, ring stages, blocks an SM>: 8
// warps of 16 x 32; 67 KB of shared memory for K <= 64 (3 blocks an SM),
// 99 KB above (2)
using TallTile = Tall<64, 64, 2, 64, 2, 3>;
// <BM, BN, warps along M, along N, over K, steps a round>: 8 warps
using Small32x64 = Small<32, 64, 2, 2, 2, 6>;  // warps of 16 x 32, K in two; 86 KB
using Small32x32 = Small<32, 32, 1, 2, 4, 8>;  // warps of 32 x 16, K in four; 80 KB

}  // namespace

extern "C" int block_pruned_matmul_f32(const void* x, const void* w, const void* block_mask,
                                       void* out, int M, int K, int N, int tile, int grid_m,
                                       int splits, void* stream) {
  if (M < 1 || K < 1 || N < 1 || grid_m < 1 || (tile != 0 && (grid_m > 65535 || K < 32)) ||
      !(splits == 1 || (tile >= 2 && (splits == 2 || splits == 4 || splits == 8)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bm = static_cast<const int*>(block_mask);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: {
      // lanes over n: all of a row's when K < 8, else enough for N; lanes over
      // k: about kRowsK terms a lane
      const bool vec = K % 4 == 0 && aligned16(xp);
      int nl = 1, lanes = 1;
      if (K < 8) nl = 32;
      else while (nl < N && nl < 32) nl <<= 1;
      while (lanes < nl || (lanes < 32 && lanes / nl * kRowsK < K)) lanes <<= 1;
      const long long rows_per_block = kRowsWarps * (32 / lanes);
      const long long blocks = (static_cast<long long>(M) + rows_per_block - 1) / rows_per_block;
      if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
      const auto kernel = vec ? block_pruned_matmul_rows_kernel<4> : block_pruned_matmul_rows_kernel<1>;
      kernel<<<static_cast<unsigned>(blocks), kRowsWarps * 32, 0, s>>>(xp, wp, bm, op, M, K, N,
                                                                        lanes, nl);
      return static_cast<int>(cudaGetLastError());
    }
    case 1: return launch_tall<TallTile>(xp, wp, bm, op, M, K, N, grid_m, s);
    case 2: return launch_small<Small32x64>(xp, wp, bm, op, M, K, N, grid_m, splits, s);
    case 3: return launch_small<Small32x32>(xp, wp, bm, op, M, K, N, grid_m, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
