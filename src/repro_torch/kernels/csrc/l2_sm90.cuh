// Main loop shared by the port's two squared-L2 kernels on Hopper's TF32
// tensor cores at float32 accuracy (pairwise_l2_sm90.cu, the verify step,
// and bucket_assign_sm90.cu, the build's nearest-center scan): the dot
// products of one (64 kWG x 64 kWG) tile of A rows x B rows, and the
// squared row norms of both operands, from TMA-fed float32 chunks.
//
// Precision: plain TF32 keeps 11 significant bits of each operand, which
// the d2 tolerance does not absorb. Each operand is split into
// x_hi = rna_tf32(x) and x_lo = rna_tf32(x - x_hi) (22 bits in all), and
// every 8-deep k step takes three products: a_lo.b_hi, a_hi.b_lo and
// a_hi.b_hi (a_lo.b_lo is below float32's last bit). The tensor cores
// round their float32 sums toward zero, so a dot product accumulated over
// all of D in one register comes out a few ulps small, and d2 too large
// (PERF.md, PR 14). So each 32-deep chunk's 12 products go into a fresh
// partial sum, in one fixed order: the 8 small products (lo.hi, hi.lo, k
// step by k step) while the sum is still small, then the 4 hi.hi; the
// partial is added to the running total in float32 (round to nearest).
// The squared norms are float32 FMAs in k order, as the CUDA-core kernels
// sum them: the norms of both routes are the same floats.
//
// Deciding as the CUDA-core kernels do. Shorter partials shrink the
// truncation's error but never remove it, so near a decision (verify's
// d2 <= eps2, assign's argmin) the tensor cores' d2 t may fall on the other
// side from the CUDA-core kernels' s (l2_tile.cuh: the dot as one FMA chain
// in k order, then the same d2 expression). Where that can happen the
// kernels recompute s (simt_d2) and decide, and write, with it. The bound
// on |t - s|, from the arithmetic: let u = 2^-23, nk = ceil(D / 32) and
// S = sum_k |a_k b_k| <= (|a|^2 + |b|^2) / 2. Then
//  * the split drops a_lo.b_lo and the bits below each lo: under
//    3 * 2^-22 |a_k b_k| a term, 6u S in all;
//  * a wgmma k step adds its 8 exact TF32 products to the partial in one or
//    more fused sums, each aligning its terms to the largest, truncating
//    below the 24th bit and rounding the sum toward zero: a sum of n
//    products errs by under (n + 2) u times its terms, so a step by under
//    24u times its products and the partial. A chunk's 4 hi.hi steps err by
//    under 96.3u S_c, its 8 small ones (terms under 2^-10 S_c) by under
//    0.2u S_c; the nk partials' round-to-nearest additions by (nk - 1) u S/2;
//  * the CUDA-core chain errs by under D u S / 2 (D roundings to nearest,
//    each of a partial sum below S);
//  * each route's fl(na + nb - 2 dot) rounds by under u (na + nb).
// So |t - s| <= ((102.5 + (D + nk) / 2)(1 + D 2^-24) + 2.01) u (na + nb),
// below the band
//   kappa(D) u (na + nb) + 2^-100,  kappa(D) = 112 + 33 (D + nk) / 64
// for every D below 2^19 (2^-100 covers operands flushed below float32's
// normal range). Outside the band t and s lie on the same side
// of any threshold; inside it verify recomputes the pair.
// Pairs whose norms sum to 2^100 or more are left as computed: the
// callers pad slabs with rows of 1e15 (|x|^2 >= 4e30 from D = 4), whose
// band would take in every pair of two pad rows, and no caller reads them.
//
// Assign bounds the centers it did not recompute (simt_floor): for such a
// center c with tensor-core d2 t, |x - c|^2 <= t + band and |c| <= |x| +
// |x - c| give nx + nc <= (2 nx + 2 sqrt(nx t) + t)(1 + 3 sqrt(kappa u)),
// so c's CUDA-core d2 is at least
//   t - (9/8) kappa u (2 nx + 2 sqrt(nx t) + t) - 2^-99
// while kappa u <= 2^-10 (D up to about 15,000); the bound increases with
// t wherever it is positive.
//
// The loop: a block of kThreads = kRows + kCols threads, kWG warpgroups,
// each owning 64 rows and every column of the tile (kWG wgmma m64n64k8
// products of its rows). Thread 0 keeps a two-stage ring of float32
// chunks, 32 deep (one 128-byte swizzle row), filled by TMA from 3-D maps
// over (D, rows, E): rows past the operand and depth past D arrive as
// zeros, so no caller pads. Per chunk, thread t takes row t of the staged
// (A; B) chunk: it adds the row's squares to its norm, rounds the row to
// hi in place and writes lo beside it in the same swizzled layout; then
// every warpgroup runs the chunk's products (4 k steps x 3 products, per
// 64 columns into a partial sum added to the total) and releases the
// stage, which thread 0 refills two chunks ahead (past a tile's last
// chunk, with the first chunks of the block's next tile, so that a block
// walking several tiles waits on no load between them). Every output
// comes from the same n64 product and the same k order whatever the tile,
// so its bytes never depend on where it landed.
#pragma once

#include <cstdint>
#include <cstring>

#include "sm90.cuh"

namespace l2sm90 {

using namespace sm90;

constexpr int kChunk = 32;   // floats of depth per staged chunk (128 bytes)
constexpr int kStages = 2;   // float32 chunk ring

template <int kWG>
struct Tile {
  static constexpr int kRows = 64 * kWG;       // output rows of a block
  static constexpr int kCols = 64 * kWG;       // output columns of a block
  static constexpr int kThreads = 128 * kWG;   // = kRows + kCols staged rows
  static constexpr int kABytes = kRows * kChunk * 4;
  static constexpr int kStageBytes = kABytes + kCols * kChunk * 4;
  // [stage] (A rows, then B rows): float32 as loaded, then hi in place
  static constexpr int kRaw = 0;
  static constexpr int kLo = kRaw + kStages * kStageBytes;  // lo of a stage
  static constexpr int kNorm = kLo + kStageBytes;  // |a|^2 [kRows], |b|^2
  static constexpr int kBar = kNorm + 4 * (kRows + kCols);  // full[kStages]
  static constexpr int kBytes = kBar + 8 * kStages;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d (64 x 64) = scale_d * d + A (64 x 8) B (64 x 8)^T, tf32, both K-major
// in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// norm += x.x^2 + ... in k order; x <- hi in place; lo <- rna(x - hi)
__device__ __forceinline__ void split4(float4& x, float4& lo, float& norm) {
  norm = fmaf(x.x, x.x, norm);
  norm = fmaf(x.y, x.y, norm);
  norm = fmaf(x.z, x.z, norm);
  norm = fmaf(x.w, x.w, norm);
  const float4 hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                                tf32_rna(x.w));
  lo = make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y),
                   tf32_rna(x.z - hi.z), tf32_rna(x.w - hi.w));
  x = hi;
}

// thread 0, once per block before the first tile: the ring's barriers
template <int kWG>
__device__ __forceinline__ void init_ring(uint32_t base) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i)
      mbar_init(base + Tile<kWG>::kBar + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// thread 0: the copies of depth chunk c of A and B into ring slot g's
// stage (g counts the block's chunks over all its tiles)
template <int kWG>
__device__ __forceinline__ void load_chunk(const CUtensorMap* tm_a,
                                           const CUtensorMap* tm_b,
                                           uint32_t base, int g, int c,
                                           int row0, int col0, int e) {
  using L = Tile<kWG>;
  const uint32_t full = base + L::kBar + 8 * (g % kStages);
  const uint32_t dst = base + L::kRaw + (g % kStages) * L::kStageBytes;
  mbar_expect_tx(full, L::kStageBytes);
  tma_load_3d(dst, tm_a, full, c * kChunk, row0, e);
  tma_load_3d(dst + L::kABytes, tm_b, full, c * kChunk, col0, e);
}

// acc[h][i] <- dot products of the tile at A rows row0.., B rows col0..
// of lane e, in wgmma's accumulator layout (h: 64-column group); returns
// the squared norm of row threadIdx.x of the (A; B) tile. base / sbase:
// the block's shared memory aligned to 1024 bytes (128-byte swizzling
// repeats every 1024), as a shared-space address and as a pointer, both
// derived in the kernel from its dynamic shared memory (carried in a
// struct instead, they cost the verify kernel spilled registers and
// time). nk = chunks of depth; g0 = chunks this block consumed before
// this tile (the ring's barrier phases carry on from them).
// next_col0 >= 0: the B rows of the tile (same A rows) that the block
// takes next; its first chunks are loaded while this tile's last ones
// are consumed, and the next call (g0 + nk) finds them in flight. Every
// thread of the block calls it.
template <int kWG>
__device__ __forceinline__ float tile_dots(const CUtensorMap* tm_a,
                                           const CUtensorMap* tm_b,
                                           uint32_t base, uint8_t* sbase,
                                           int row0, int col0, int next_col0,
                                           int e, int nk, int g0,
                                           float (&acc)[kWG][32]) {
  using L = Tile<kWG>;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // the tile's first chunks, unless the previous tile prefetched them
  const bool prefetch = nk >= kStages;
  if (tid == 0 && (g0 == 0 || !prefetch))
    for (int c = 0; c < min(kStages, nk); ++c)
      load_chunk<kWG>(tm_a, tm_b, base, g0 + c, c, row0, col0, e);

#pragma unroll
  for (int h = 0; h < kWG; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  // thread t splits row t of the staged (A; B) chunk, 128 bytes a row; the
  // swizzle puts 16-byte unit u of row r at position u ^ (r % 8)
  float norm = 0.f;
  float4* const lo_row = reinterpret_cast<float4*>(sbase + L::kLo + tid * 128);
  const uint64_t k_bits = desc_bits(16);
  const uint32_t a_lo = base + L::kLo + wg * 64 * 128;
  const uint32_t b_lo = base + L::kLo + L::kABytes;

  for (int c = 0; c < nk; ++c) {
    const int g = g0 + c;
    const int st = g % kStages;
    mbar_wait(base + L::kBar + 8 * st, (g / kStages) & 1);
    float4* const x_row = reinterpret_cast<float4*>(
        sbase + L::kRaw + st * L::kStageBytes + tid * 128);
#pragma unroll
    for (int u = 0; u < kChunk / 4; ++u) {
      const int p = u ^ (tid & 7);
      float4 x = x_row[p], lo;
      split4(x, lo, norm);
      x_row[p] = x;
      lo_row[p] = lo;
    }
    fence_proxy_async();
    __syncthreads();

    const uint32_t stage = base + L::kRaw + st * L::kStageBytes;
    const uint32_t a_hi = stage + wg * 64 * 128;
    const uint32_t b_hi = stage + L::kABytes;
    // per 64 columns: the chunk's 12 products into a fresh partial sum,
    // the small ones first, then one round-to-nearest add into the total
#pragma unroll
    for (int h = 0; h < kWG; ++h) {
      float part[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 8; ++kk) {
        const uint32_t ak = kk * 32, bk = h * 64 * 128 + kk * 32;
        wgmma_tf32(part, make_desc(a_lo + ak, k_bits),
                   make_desc(b_hi + bk, k_bits), kk > 0);
        wgmma_tf32(part, make_desc(a_hi + ak, k_bits),
                   make_desc(b_lo + bk, k_bits), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kChunk / 8; ++kk) {
        const uint32_t ak = kk * 32, bk = h * 64 * 128 + kk * 32;
        wgmma_tf32(part, make_desc(a_hi + ak, k_bits),
                   make_desc(b_hi + bk, k_bits), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] += part[i];
    }
    __syncthreads();  // every warpgroup is done with the stage and lo
    if (tid == 0) {
      if (c + kStages < nk)
        load_chunk<kWG>(tm_a, tm_b, base, g + kStages, c + kStages, row0,
                        col0, e);
      else if (prefetch && next_col0 >= 0)
        load_chunk<kWG>(tm_a, tm_b, base, g + kStages, c + kStages - nk,
                        row0, next_col0, e);
    }
  }
  return norm;
}

// ---- deciding as the CUDA-core kernels do (see the top of the file) --------
constexpr float kNoRecheck = 0x1p100f;  // na + nb from which pairs keep t
constexpr float kBandFloor = 0x1p-100f;  // the band's absolute term

// kappa(D) u: the band's share of na + nb at depth D
__host__ __device__ inline float band_scale(int D) {
  const int nk = (D + kChunk - 1) / kChunk;
  return (112.f + static_cast<float>(D + nk) * (33.f / 64.f)) * 0x1p-23f;
}

// the least CUDA-core d2 of any center whose tensor-core d2 is at least t
// (ku = band_scale(D) <= 2^-10); -inf where it cannot tell, NaN where t is
// +inf (no such center), which no comparison passes
__device__ __forceinline__ float simt_floor(float ku, float nx, float t) {
  if (ku > 0x1p-10f) return -__int_as_float(0x7f800000);
  const float w = 2.f * nx + 2.f * sqrtf(nx * t) + t;
  return t - fmaf(1.125f * ku, w, 0x1p-99f);
}

// The CUDA-core kernels' d2 of row x against rows c[0..K), each D floats
// (D % 4 == 0, 16-byte aligned), in global or shared memory: the norms and
// the dot products as float32 FMA chains in k order from 0 (l2_tile.cuh),
// then max(nx + nc - 2 dot, 0), whose doubling is exact, so that it is the
// same float whether or not nvcc contracts it into fmaf(-2, dot, nx + nc).
// The K chains run side by side. Returns nx.
template <int K>
__device__ __forceinline__ float simt_d2(const float* __restrict__ x,
                                         const float* const (&c)[K], int D,
                                         float (&d2)[K]) {
  const float4* const xv = reinterpret_cast<const float4*>(x);
  float nx = 0.f, nc[K], dot[K];
#pragma unroll
  for (int j = 0; j < K; ++j) nc[j] = dot[j] = 0.f;
  constexpr int kUnroll = K == 1 ? 8 : 4;  // (K + 1) kUnroll loads in flight
#pragma unroll kUnroll
  for (int k = 0; k < D / 4; ++k) {
    const float4 a4 = xv[k];
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    float b[K][4];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float4 b4 = reinterpret_cast<const float4*>(c[j])[k];
      b[j][0] = b4.x;
      b[j][1] = b4.y;
      b[j][2] = b4.z;
      b[j][3] = b4.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      nx = fmaf(a[q], a[q], nx);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        nc[j] = fmaf(b[j][q], b[j][q], nc[j]);
        dot[j] = fmaf(a[q], b[j][q], dot[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    d2[j] = fmaxf(fmaf(-2.f, dot[j], nx + nc[j]), 0.f);
  return nx;
}

// ---- host side ---------------------------------------------------------------
// a contiguous float32 (E, rows, D) tensor as a 3-D map over (D, rows, E)
// with a box of 32 x box_rows x 1 and the 128-byte swizzle; reads past the
// edges return zeros
inline cudaError_t encode(EncodeTiled fn, CUtensorMap* map, const float* ptr,
                          int D, int rows, int E, int box_rows) {
  std::memset(map, 0, sizeof(*map));
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(rows),
                              cuuint64_t(E)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 4,
                                 cuuint64_t(rows) * cuuint64_t(D) * 4};
  const cuuint32_t box[3] = {cuuint32_t(kChunk), cuuint32_t(box_rows), 1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// once per kernel instantiation and device: the dynamic shared memory a
// block takes, and the largest carveout, so that two blocks fit an SM
template <typename Kernel>
cudaError_t configure(Kernel kernel, int bytes, int* configured_for) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || *configured_for == dev) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) *configured_for = dev;
  return err;
}

}  // namespace l2sm90
