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
// What bounds it: at the ranker's FFN w1 shape (51,200 x 64 x 256) bytes,
// 94% of them the f32 output (52.4 of 55.7 MB, 0.0166 ms at 3.35 TB/s);
// at the kernel benchmark's 512³ the launch and the trips to memory, since
// its 1.57 MB take 0.0005 ms and its 0.27 GOP 0.00014 ms at the int8
// tensor-core rate. The previous design staged a_q and b_q a byte a load
// and took its products on __dp4a, four to a CUDA-core instruction.
//
// What the design does about it:
//   * products on the int8 tensor cores: mma.sync m16n8k32 s8·s8 -> s32.
//     Int32 sums are exact in any order, so the accumulator equals the
//     plain version's bit for bit;
//   * a block owns BM x BN tiles of out (the launch plan's `tile`,
//     kernels/int8_matmul/int8_matmul.py:launch_plan: 64 x 256 where that
//     gives a wave of tiles, as at the ranker's shape, whose N it covers,
//     so a_q is read once; else 32 x 64: 128 tiles at 512³). The grid
//     holds as many blocks as the SMs run at once; a block walks its M
//     tiles, all of K each, through one 3-stage cp.async ring of (tile,
//     64-byte K step) stages, so the next tile's loads are in flight while
//     it stores this one. a_q rows (K-major) and b_q rows (N-major) come
//     as they lie in memory, 16-byte copies where
//     K (for a_q) or N (for b_q) is a multiple of 16, 4-byte where of 4,
//     else bytes, out-of-range bytes 0. Where all of K is one stage (the
//     ranker's K = 64), b_q's stage is the same for every tile of the
//     block: it is read once and each warp keeps its B fragments in
//     registers, so a tile's MMAs read only a_q from shared memory while
//     the other blocks of the SM store. A tile's a_s rides in the ring;
//     the block's b_s is read once;
//   * the s8 MMA takes B K-major, and b_q is N-major. So a lane reads four
//     k rows of one 32-bit word each (four columns) and transposes the 4 x 4
//     bytes in registers (8 byte_perm), which gives its B fragment for four
//     n8 tiles at once. This permutes the columns of a 32-column group:
//     n8 tile j, MMA column p holds column 16·(p & 1) + 4·(p >> 1) + j. A's
//     fragments come by ldmatrix;
//   * the same permutation hands each lane, over the four tiles, four
//     adjacent columns of a row twice: the epilogue f32(acc) · (a_s[m] ·
//     b_s[n]), the Pallas association, is stored as 16-byte float4s, four
//     lanes writing 64 contiguous bytes of a row (whole 32-byte sectors),
//     with no staging in shared memory. Ragged N takes 4-byte stores.
//     At the ranker's shape the stores then decide the time: after the
//     first tile's loads, the blocks store as fast as the card takes
//     writes, about the rate of a plain `fill_` of the same 52 MB.
//
// Interface: plain C, loaded with ctypes (kernels/int8_matmul/int8_matmul.py),
// which passes the plan's tile, grid and load widths. Arrays contiguous and
// row-major; M, K, N >= 1. A plan or width it does not take returns
// cudaErrorInvalidValue and launches nothing. It launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after the launch (0 = launched).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 64;     // k bytes a stage
constexpr int kStages = 3;  // stages of the cp.async ring
constexpr int kPad = 16;    // bytes after each row of a stage: ldmatrix without bank conflicts
constexpr int kDefaultSmem = 48 * 1024;

// A block of WARPS_M x WARPS_N warps, each a WM x WN tile of out; at most
// 65,536 / (threads · MIN_BLOCKS) registers a thread.
template <int WM, int WN, int WARPS_M, int WARPS_N, int MIN_BLOCKS>
struct Tile {
  static constexpr int kWM = WM, kWN = WN, kWarpsM = WARPS_M, kMinBlocks = MIN_BLOCKS;
  static constexpr int kBM = WM * WARPS_M, kBN = WN * WARPS_N;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int kMT = WM / 16;  // m16 tiles a warp
  static constexpr int kNG = WN / 32;  // groups of four n8 tiles a warp
  static constexpr int kALd = kBK + kPad;  // bytes a row of a_q's stage
  static constexpr int kBLd = kBN + kPad;  // bytes a row (one k) of b_q's stage
  static constexpr int kAStage = kBM * kALd;
  static constexpr int kBStage = kBK * kBLd;
  // the rings of a_q and b_q stages, a ring of a_s [kBM] (one a tile), b_s [kBN]
  static constexpr int kSmem = kStages * (kAStage + kBStage + 4 * kBM) + 4 * kBN;
  static_assert(WM % 16 == 0 && WN % 32 == 0, "warp tiles of m16 x (4 x n8)");
};

// the C entry's tiles (kernels/int8_matmul/int8_matmul.py:TILES), each
// with registers for 2 or 4 blocks an SM
using TileWide = Tile<32, 64, 2, 4, 2>;   // 0: 64 x 256, 8 warps
using TileSmall = Tile<16, 32, 2, 2, 4>;  // 1: 32 x 64, 4 warps

template <int V>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(ok ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(ok ? 4 : 0) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols bytes of src (row stride ld_src, rows r0.., columns c0..)
// into dst (row stride ld_dst), V bytes a copy; bytes past rows_in or
// cols_in are 0. cols_in % V == 0 and the rows V-byte aligned, so a copy
// is wholly in or out.
template <int V, int Rows, int Cols, int Threads>
__device__ __forceinline__ void load_rows(int8_t* dst, int ld_dst, const int8_t* src,
                                          long long ld_src, long long r0, long long rows_in,
                                          int c0, int cols_in) {
  constexpr int per_row = Cols / V;
  for (int i = threadIdx.x; i < Rows * per_row; i += Threads) {
    const int r = i / per_row, c = (i - (i / per_row) * per_row) * V;
    const long long row = r0 + r;
    const int col = c0 + c;
    const bool ok = row < rows_in && col < cols_in;
    int8_t* d = dst + r * ld_dst + c;
    if constexpr (V == 1) {
      *d = ok ? src[row * ld_src + col] : 0;
    } else {
      cp_async<V>(d, ok ? src + row * ld_src + col : src, ok);
    }
  }
}

template <int Rows, int Cols, int Threads>
__device__ __forceinline__ void load_stage(int8_t* dst, int ld_dst, const int8_t* src,
                                           long long ld_src, long long r0, long long rows_in,
                                           int c0, int cols_in, int v) {
  if (v == 16) {
    load_rows<16, Rows, Cols, Threads>(dst, ld_dst, src, ld_src, r0, rows_in, c0, cols_in);
  } else if (v == 4) {
    load_rows<4, Rows, Cols, Threads>(dst, ld_dst, src, ld_src, r0, rows_in, c0, cols_in);
  } else {
    load_rows<1, Rows, Cols, Threads>(dst, ld_dst, src, ld_src, r0, rows_in, c0, cols_in);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w[i] holds four bytes (columns) of row i; r[j] gets byte j of each row,
// row i in byte i.
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// The warp's B fragments of a stage: for each 32-k half and 32-column
// group, lane g's four k rows of one word each (columns 16·(g & 1) +
// 4·(g >> 1) + j of the group), transposed so that bf[..][h][j] holds
// column j's four k values, rows 4·tig + 16·h + (0..3).
template <class T>
__device__ __forceinline__ void load_b_frags(const int8_t* Bs,
                                             uint32_t (&bf)[kBK / 32][T::kNG][2][4], int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int bcol = wn * T::kWN + 16 * (g & 1) + 4 * (g >> 1);
#pragma unroll
  for (int kh = 0; kh < kBK / 32; ++kh) {
#pragma unroll
    for (int ng = 0; ng < T::kNG; ++ng) {
      const int8_t* bp = Bs + (32 * kh + 4 * tig) * T::kBLd + bcol + 32 * ng;
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = *reinterpret_cast<const uint32_t*>(bp + i * T::kBLd);
        hi[i] = *reinterpret_cast<const uint32_t*>(bp + (16 + i) * T::kBLd);
      }
      transpose4x4(lo, bf[kh][ng][0]);
      transpose4x4(hi, bf[kh][ng][1]);
    }
  }
}

// acc += A (a stage of a_q, by ldmatrix) x the B fragments.
template <class T>
__device__ __forceinline__ void mma_tile(const int8_t* As,
                                         const uint32_t (&bf)[kBK / 32][T::kNG][2][4],
                                         int (&acc)[T::kMT][4 * T::kNG][4], int wm) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kh = 0; kh < kBK / 32; ++kh) {
    uint32_t af[T::kMT][4];
#pragma unroll
    for (int mt = 0; mt < T::kMT; ++mt) {
      const int row = wm * T::kWM + mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      ldmatrix_x4(af[mt], As + row * T::kALd + 32 * kh + 16 * (lane >> 4));
    }
#pragma unroll
    for (int ng = 0; ng < T::kNG; ++ng)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mt = 0; mt < T::kMT; ++mt) {
          mma_s8(acc[mt][4 * ng + j], af[mt], bf[kh][ng][0][j], bf[kh][ng][1][j]);
        }
  }
}

// f32(acc) · (a_s[m] · b_s[n]) of the warp's tile at rows m0.., columns
// n0..; sa and sb hold the block's a_s and b_s from row and column r0, c0
// of the warp's tile. Lane (g, tig) holds, over the four n8 tiles j of a
// group, columns 4·tig + j (c0, c2) and 16 + 4·tig + j (c1, c3) of rows g
// and g + 8.
template <class T>
__device__ __forceinline__ void epilogue(const int (&acc)[T::kMT][4 * T::kNG][4],
                                         const float* sa, const float* sb,
                                         float* __restrict__ out, long long m0, int n0, int M,
                                         int N, bool vec_out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      const long long m = m0 + r;
      if (m >= M) continue;
      const float a = sa[r];
#pragma unroll
      for (int ng = 0; ng < T::kNG; ++ng) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 32 * ng + 16 * h + 4 * tig;
          const int n = n0 + c;
          const float4 b = *reinterpret_cast<const float4*>(sb + c);
          const float v[4] = {__int2float_rn(acc[mt][4 * ng][2 * half + h]) * (a * b.x),
                              __int2float_rn(acc[mt][4 * ng + 1][2 * half + h]) * (a * b.y),
                              __int2float_rn(acc[mt][4 * ng + 2][2 * half + h]) * (a * b.z),
                              __int2float_rn(acc[mt][4 * ng + 3][2 * half + h]) * (a * b.w)};
          float* o = out + m * N + n;
          if (vec_out && n + 3 < N) {
            *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < N) o[j] = v[j];
          }
        }
      }
    }
  }
}

// Block (x, y) owns the M tiles x, x + gridDim.x, ... of column tile y. It
// walks the (M tile, K step) stages of all of them through one cp.async
// ring, so the first stages of its next tiles are in flight while it
// stores this one. A tile's a_s rides in the ring with its first stage;
// the block's b_s is read once. KeepB (all of K is one stage): the
// block's b_q stage is the same for every tile, so it is read once and
// each warp keeps its B fragments in registers.
template <class T, bool KeepB>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   const float* __restrict__ a_s, const float* __restrict__ b_s,
                   float* __restrict__ out, int M, int K, int N, int va, int vb, bool vec_out) {
  constexpr int S = kStages;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;
  int8_t* Bs = As + S * T::kAStage;
  float* sa_ring = reinterpret_cast<float*>(Bs + S * T::kBStage);  // [S][kBM]
  float* sb = sa_ring + S * T::kBM;                                // [kBN]
  const int warp = threadIdx.x >> 5;
  const int wm = warp % T::kWarpsM, wn = warp / T::kWarpsM;
  const long long m_tiles = (M + static_cast<long long>(T::kBM) - 1) / T::kBM;
  const int n0 = blockIdx.y * T::kBN;
  const int nk = KeepB ? 1 : (K + kBK - 1) / kBK;
  const long long mine = (m_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;  // M tiles it walks
  const long long stages = mine * nk;

  for (int i = threadIdx.x; i < T::kBN; i += T::kThreads) {  // lands with stage 0
    const bool ok = n0 + i < N;
    cp_async<4>(sb + i, ok ? b_s + n0 + i : b_s, ok);
  }

  auto tile_m0 = [&](long long s) { return (blockIdx.x + (s / nk) * gridDim.x) * T::kBM; };
  auto load = [&](long long s) {
    const int slot = static_cast<int>(s % S);
    const long long m0 = tile_m0(s);
    const int kt = static_cast<int>(s % nk);
    load_stage<T::kBM, kBK, T::kThreads>(As + slot * T::kAStage, T::kALd, a, K, m0, M, kt * kBK,
                                         K, va);
    if (!KeepB || s == 0) {
      load_stage<kBK, T::kBN, T::kThreads>(Bs + slot * T::kBStage, T::kBLd, b, N, kt * kBK, K,
                                           n0, N, vb);
    }
    if (kt == 0) {
      float* dst = sa_ring + ((s / nk) % S) * T::kBM;
      for (int i = threadIdx.x; i < T::kBM; i += T::kThreads) {
        const bool ok = m0 + i < M;
        cp_async<4>(dst + i, ok ? a_s + m0 + i : a_s, ok);
      }
    }
  };

  int acc[T::kMT][4 * T::kNG][4];
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int j = 0; j < 4 * T::kNG; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0;
  uint32_t bf[kBK / 32][T::kNG][2][4];

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < stages) load(s);
    cp_async_commit();
  }
  for (long long s = 0; s < stages; ++s) {
    cp_async_wait<S - 2>();  // stage s has landed (this thread's copies)
    __syncthreads();         // ... and every thread's; stage s-1's slot is free again
    if (s + S - 1 < stages) load(s + S - 1);
    cp_async_commit();
    const int slot = static_cast<int>(s % S);
    if (!KeepB || s == 0) load_b_frags<T>(Bs + (KeepB ? 0 : slot) * T::kBStage, bf, wn);
    mma_tile<T>(As + slot * T::kAStage, bf, acc, wm);
    if (s % nk == nk - 1) {
      epilogue<T>(acc, sa_ring + ((s / nk) % S) * T::kBM + wm * T::kWM, sb + wn * T::kWN, out,
                  tile_m0(s) + wm * T::kWM, n0 + wn * T::kWN, M, N, vec_out);
#pragma unroll
      for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
        for (int j = 0; j < 4 * T::kNG; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0;
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <class T>
int launch(const void* a_q, const void* b_q, const void* a_scale, const void* b_scale, void* out,
           int M, int K, int N, int grid_m, int va, int vb, cudaStream_t stream) {
  const long long m_tiles = (M + static_cast<long long>(T::kBM) - 1) / T::kBM;
  const long long grid_n = (N + static_cast<long long>(T::kBN) - 1) / T::kBN;
  if (grid_m < 1 || grid_m > m_tiles || grid_n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(grid_m), static_cast<unsigned>(grid_n));
  const auto kernel = K <= kBK ? int8_matmul_kernel<T, true> : int8_matmul_kernel<T, false>;
  if (T::kSmem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const int8_t*>(a_q), static_cast<const int8_t*>(b_q),
      static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
      static_cast<float*>(out), M, K, N, va, vb, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// A load width v (16, 4 or 1 bytes) the rows of `p`, `len` bytes long, take.
bool width_ok(int v, const void* p, int len) {
  return (v == 16 || v == 4 || v == 1) && len % v == 0 &&
         reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(v) == 0;
}

}  // namespace

// `tile` (0 wide 64 x 256, 1 small 32 x 64), `grid_m`
// (blocks along M, each walking M tiles grid_m apart), `va` and `vb`
// (bytes a copy of a_q's and b_q's rows) are the caller's plan
// (kernels/int8_matmul/int8_matmul.py:launch_plan and load_widths).
extern "C" int int8_matmul_s8(const void* a_q, const void* b_q, const void* a_scale,
                              const void* b_scale, void* out, int M, int K, int N, int tile,
                              int grid_m, int va, int vb, void* stream) {
  if (M < 1 || K < 1 || N < 1 || !width_ok(va, a_q, K) || !width_ok(vb, b_q, N) ||
      reinterpret_cast<uintptr_t>(a_scale) % 4 || reinterpret_cast<uintptr_t>(b_scale) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INT8_CASE(ID, T) \
  case ID: return launch<T>(a_q, b_q, a_scale, b_scale, out, M, K, N, grid_m, va, vb, st);
  switch (tile) {
    INT8_CASE(0, TileWide) INT8_CASE(1, TileSmall)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef INT8_CASE
}
