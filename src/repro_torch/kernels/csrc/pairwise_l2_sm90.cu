// Batched pairwise squared-L2 distance with an epsilon threshold on
// Hopper's TF32 tensor cores at float32 accuracy: the verify step of every
// DiskJoin flush (host and device compute modes) and the device-mode point
// queries' (Qp, cap) tile, wherever rows are 16-byte aligned (D % 4 == 0;
// kernels/pairwise_l2.py::launch_plan). pairwise_l2.cu serves the rest.
//
// Replaces: src/repro/kernels/pairwise_l2.py:86,
// pairwise_l2_threshold_batched (body _pairwise_kernel_batched), and its
// unbatched twin at :128, pairwise_l2_threshold, as the E = 1 launch.
//
// Computes the function of pairwise_l2.cu, for every lane e < E, row
// i < M of A[e] and row j < N of B[e]:
//   d2[e,i,j]   = max(|a|^2 + |b|^2 - 2 a.b, 0)
//   mask[e,i,j] = d2[e,i,j] <= eps2               (int8)
// with the squared norms summed in float32 FMAs in k order.
//
// Precision: plain TF32 keeps 11 significant bits of each operand, which
// the verify tolerance does not absorb. Each operand is split into
// x_hi = rna_tf32(x) and x_lo = rna_tf32(x - x_hi) (22 bits in all), and
// every 8-deep k step takes three products: a_lo.b_hi, a_hi.b_lo and
// a_hi.b_hi (a_lo.b_lo is below float32's last bit). The tensor cores
// round their float32 sums toward zero, so a dot product accumulated over
// all of D in one register comes out a few ulps small, and d2 too large:
// at the main path's shape a single accumulator disagreed with the
// float32 reference's mask on 2,916 pairs, 15 times as many as the
// CUDA-core kernel (chip_smoke.py on an H100 80GB HBM3; PERF.md). So each
// 32-deep chunk's 12 products go into a fresh partial sum, in one fixed
// order: the 8 small products (lo.hi, hi.lo, k step by k step) while the
// sum is still small, then the 4 hi.hi; the partial is added to the
// running total in float32 (round to nearest). The d2 error is then close
// to the float32 reference's, which the |a|^2 + |b|^2 - 2ab cancellation
// sets.
//
// What bounds it on an H100: at the main shape (E 32 lanes of 2048 x 2048
// x 128) the products are 34.4 GFLOP, issued three times (0.208 ms at
// 494.7 TFLOP/s dense TF32), against 738 MB of traffic, almost all of it
// the 5-byte d2 + mask output (0.220 ms at 3.35 TB/s). Bytes and
// operations nearly tie, so one tile's stores have to overlap another's
// products: each block takes under half of an SM's shared memory and 128
// registers a thread, so two run on every SM.
//
// Design. One block per (lane, 64 kWG x 64 kWG output tile): kWG
// warpgroups, each owning 64 rows and every column of the tile (kWG wgmma
// m64n64k8 products of its rows). kWG = 2 (128 x 128, 256 threads) for the
// batched verify; kWG = 1 (64 x 64) where M <= 64, so the query tile
// (Qp <= 64 rows x 2048) computes no pad rows and runs 32 blocks where
// 128-column tiles would give 16. Every output comes from the same n64
// product and the same k order whatever the tile, lane or E, which keeps
// host-mode and device-mode joins byte-identical. Thread 0 keeps a
// two-stage ring of float32 chunks, 32 deep (one 128-byte swizzle row),
// filled by TMA from 3-D maps over (D, rows, E): rows past M or N and
// depth past D arrive as zeros, so no caller pads. Per chunk, thread t
// takes row t of the staged (A; B) chunk: it adds the row's squares to its
// norm, rounds the row to hi in place and writes lo beside it in the same
// swizzled layout; then both warpgroups run the chunk's products (4 k
// steps x 3 products, per 64 columns into a partial sum added to the
// total) and release the stage, which thread 0 refills two chunks ahead. The epilogue swaps pairs of columns between
// neighbouring lanes so each thread writes 4 consecutive outputs: 16-byte
// d2 and 4-byte mask stores.
#include <cstdint>
#include <cstring>

#include "sm90.cuh"

namespace {

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

// thread 0: the copies of depth chunk c of A and B into its ring stage
template <int kWG>
__device__ __forceinline__ void load_chunk(const CUtensorMap* tm_a,
                                           const CUtensorMap* tm_b,
                                           uint32_t base, int c, int row0,
                                           int col0, int e) {
  using L = Tile<kWG>;
  const uint32_t full = base + L::kBar + 8 * (c % kStages);
  const uint32_t dst = base + L::kRaw + (c % kStages) * L::kStageBytes;
  mbar_expect_tx(full, L::kStageBytes);
  tma_load_3d(dst, tm_a, full, c * kChunk, row0, e);
  tma_load_3d(dst + L::kABytes, tm_b, full, c * kChunk, col0, e);
}

template <int kWG>
__global__ void __launch_bounds__(Tile<kWG>::kThreads, 2)
    pairwise_l2_tc_kernel(const __grid_constant__ CUtensorMap tm_a,
                          const __grid_constant__ CUtensorMap tm_b,
                          float* __restrict__ d2, int8_t* __restrict__ mask,
                          int M, int N, int D, float eps2) {
  using L = Tile<kWG>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzling repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  float* const norms = reinterpret_cast<float*>(sbase + L::kNorm);
  const uint32_t bar_full = base + L::kBar;  // + 8 * stage

  const int e = blockIdx.z;
  const int row0 = blockIdx.y * L::kRows, col0 = blockIdx.x * L::kCols;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int nk = (D + kChunk - 1) / kChunk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar_full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < min(kStages, nk); ++c)
      load_chunk<kWG>(&tm_a, &tm_b, base, c, row0, col0, e);

  float acc[kWG][32];
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
    const int s = c % kStages;
    mbar_wait(bar_full + 8 * s, (c / kStages) & 1);
    float4* const x_row = reinterpret_cast<float4*>(
        sbase + L::kRaw + s * L::kStageBytes + tid * 128);
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

    const uint32_t stage = base + L::kRaw + s * L::kStageBytes;
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
    __syncthreads();  // both warpgroups are done with the stage and lo
    if (tid == 0 && c + kStages < nk)
      load_chunk<kWG>(&tm_a, &tm_b, base, c + kStages, row0, col0, e);
  }

  // norms: threads [0, kRows) hold the A rows', the rest the B rows'
  norms[tid] = norm;
  __syncthreads();
  const float* const nb = norms + L::kRows;

  // C fragment: lane holds rows lane/4 and lane/4 + 8 of its warp's 16,
  // columns 8j + 2q, 8j + 2q + 1 of every 8 (q = lane % 4). Per 16 columns
  // (groups j = 2p, 2p + 1), even q keeps group 2p's pair and takes its odd
  // neighbour's, odd q keeps group 2p+1's pair and takes its even
  // neighbour's: 4 consecutive columns a lane.
  const int warp = (tid % 128) / 32, lane = tid % 32, q = lane % 4;
  const bool even = (q & 1) == 0;
  const bool vec = (N % 4) == 0;  // 16-byte aligned rows: vector stores
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rl = wg * 64 + warp * 16 + lane / 4 + 8 * half;
    const int r = row0 + rl;
    const float na = norms[rl];
    const size_t row_base = (static_cast<size_t>(e) * M + r) * N;
#pragma unroll
    for (int h = 0; h < kWG; ++h)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int ca = h * 64 + 16 * p + 2 * q;  // group 2p's pair
        float v[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          v[i] = fmaxf(fmaf(-2.f, acc[h][8 * p + 2 * half + i],
                            na + nb[ca + i]), 0.f);
          v[2 + i] = fmaxf(fmaf(-2.f, acc[h][8 * p + 4 + 2 * half + i],
                                na + nb[ca + 8 + i]), 0.f);
        }
        const float s0 = even ? v[2] : v[0], s1 = even ? v[3] : v[1];
        const float t0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float t1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        const float4 o = even ? make_float4(v[0], v[1], t0, t1)
                              : make_float4(t0, t1, v[2], v[3]);
        const int c = col0 + (even ? ca : ca + 6);
        if (r >= M) continue;
        const char4 m = make_char4(o.x <= eps2, o.y <= eps2, o.z <= eps2,
                                   o.w <= eps2);
        if (vec && c + 3 < N) {
          *reinterpret_cast<float4*>(d2 + row_base + c) = o;
          *reinterpret_cast<char4*>(mask + row_base + c) = m;
        } else {
          const float ov[4] = {o.x, o.y, o.z, o.w};
          const char mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (c + i < N) {
              d2[row_base + c + i] = ov[i];
              mask[row_base + c + i] = mv[i];
            }
        }
      }
  }
}

// ---- host side ---------------------------------------------------------------
// a contiguous float32 (E, rows, D) tensor as a 3-D map over (D, rows, E)
// with a box of 32 x box_rows x 1 and the 128-byte swizzle; reads past the
// edges return zeros
cudaError_t encode(EncodeTiled fn, CUtensorMap* map, const float* ptr, int D,
                   int rows, int E, int box_rows) {
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

template <int kWG>
cudaError_t launch(EncodeTiled fn, const float* a, const float* b, float* d2,
                   int8_t* mask, int E, int M, int N, int D, float eps2,
                   cudaStream_t stream) {
  using L = Tile<kWG>;
  auto kernel = pairwise_l2_tc_kernel<kWG>;
  static int configured_for = -1;  // once per instantiation and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (configured_for != dev) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kAlloc);
    if (err != cudaSuccess) return err;
    // two blocks an SM need the largest shared-memory carveout
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured_for = dev;
  }
  CUtensorMap ta, tb;
  std::memset(&ta, 0, sizeof(ta));
  std::memset(&tb, 0, sizeof(tb));
  err = encode(fn, &ta, a, D, M, E, L::kRows);
  if (err != cudaSuccess) return err;
  err = encode(fn, &tb, b, D, N, E, L::kCols);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + L::kCols - 1) / L::kCols, (M + L::kRows - 1) / L::kRows,
                  E);
  kernel<<<grid, L::kThreads, L::kAlloc, stream>>>(ta, tb, d2, mask, M, N, D,
                                                    eps2);
  return cudaGetLastError();
}

}  // namespace

// a: (E, M, D), b: (E, N, D), d2: (E, M, N) float32, mask: (E, M, N) int8,
// all contiguous on device `device` with 16-byte aligned base addresses;
// D % 4 == 0 (TMA reads rows at 16-byte strides). block_m: output rows of
// a block, 128 or 64 (kernels/pairwise_l2.py::launch_plan). Launches on
// `stream` without synchronising; returns the first nonzero cudaError_t
// (0 = launched).
extern "C" int pairwise_l2_sm90_launch(const float* a, const float* b,
                                       float* d2, int8_t* mask, int E, int M,
                                       int N, int D, float eps2, int block_m,
                                       int device, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0 || D <= 0 || D % 4 != 0 ||
      (block_m != 64 && block_m != 128) || !aligned16(a) || !aligned16(b) ||
      !aligned16(d2) || !aligned16(mask))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  EncodeTiled fn = nullptr;
  err = encoder(&fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = block_m == 128
            ? launch<2>(fn, a, b, d2, mask, E, M, N, D, eps2, st)
            : launch<1>(fn, a, b, d2, mask, E, M, N, D, eps2, st);
  return static_cast<int>(err);
}
