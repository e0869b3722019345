// Fused nearest-center assignment on Hopper's TF32 tensor cores, decided
// in float32: scan 2 of bucketization, wherever rows are 16-byte aligned
// (D % 4 == 0; kernels/bucket_assign.py::launch_plan). bucket_assign.cu
// serves the rest.
//
// Replaces: src/repro/kernels/bucket_assign.py:49, bucket_assign (body
// _assign_kernel).
//
// Computes the function of bucket_assign.cu, for every row i < M of X
// against the center table C (B, D):
//   mind2[i] = min_b max(|x|^2 + |c_b|^2 - 2 x.c_b, 0)   (float32)
//   idx[i]   = the lowest b attaining that minimum       (int32)
//
// What bounds it on an H100: at the main path's shape (8192 rows x 1000
// centers x 128) a launch is 2.1 GFLOP of products, issued three times by
// the 3xTF32 split (0.0127 ms at 494.7 TFLOP/s dense TF32), against 4.7 MB
// in and 64 KB out (1.4 us at 3.35 TB/s): operations bound it, and more so
// at the reference's center-index crossover, 65,536 centers a scan block
// (137 GFLOP issued three times, 0.83 ms).
//
// Design. Two passes in one C call, on one stream:
//
// 1. assign_tc_kernel: grid (row tiles, center splits S). A block takes
//    128 rows (64 where M <= 64) and a contiguous range of center tiles
//    of as many columns, walked in ascending order; l2_sm90.cuh's
//    tile_dots computes each tile's dot products and norms (the verify
//    kernel's main loop). The split count S (a pure function of M, B, D:
//    launch_plan) gives about two blocks for every SM where B allows: at
//    (8192, 1000) 64 row tiles x 4 splits, where one block per row tile
//    left 124 of 132 SMs with one block and 8 warps. No distance tile
//    leaves the block: per tile, each thread takes, for each of its two
//    rows, the best two (d2, index) pairs of its columns, ties to the
//    lower index (as 64-bit keys whose unsigned order is that order:
//    branchless min and max), skipping every column whose d2 exceeds the
//    row's second best so far; the four lanes that share a row merge
//    theirs, and one of them merges the result into the row's best two of
//    the earlier tiles, kept in shared memory (so they hold no registers
//    through the main loop). The block writes its rows' two candidates to
//    a scratch (M, S, 2).
// 2. assign_recheck_kernel, one thread a row: merges the row's 2S
//    candidates by their tensor-core d2, ties to the lower index, then
//    recomputes the best two in float32 FMAs in k order (norms and dot
//    product, bucket_assign.cu's formula) and keeps the lower, the lower
//    index on a tie. The tensor cores round their sums toward zero, so
//    their d2 runs a few ulps high and unevenly (PERF.md, PR 14); an
//    argmin decided on it could flip on near-ties where float32 does not.
//    With the re-check both the index and mind2 are float32 FMA results,
//    bucket_assign.cu's own whenever its winner is among the tensor cores'
//    best two (it can miss only where three centers lie within the tensor
//    cores' error of each other). Neither the split count nor the tile a
//    center lands in changes a result: every candidate's tensor-core d2
//    comes from the same n64 product and k order wherever it is computed,
//    and the best two of a total order are those of its parts' best twos.
#include <cstdint>

#include "l2_sm90.cuh"

namespace {

using namespace l2sm90;

constexpr int kNone = 0x7fffffff;  // index of an empty candidate slot
typedef unsigned long long Key;

// (d2, index) as one unsigned 64-bit key whose order is theirs: the
// smaller d2, the lower index on a tie. d2 >= 0 here (max(..., 0)), whose
// bits order as unsigned integers; the sign bit is cleared so that a -0
// counts as 0.
__device__ __forceinline__ Key make_key(float v, int i) {
  return (Key(__float_as_uint(v) & 0x7fffffffu) << 32) | unsigned(i);
}
__device__ __forceinline__ int key_index(Key k) {
  return int(unsigned(k));
}
constexpr Key kEmpty = (Key(0x7f800000u) << 32) | unsigned(kNone);  // +inf

// (v, i) before (bv, bi): the smaller d2, the lower index on a tie
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// the best two keys k1 <= k2 of a set, one member pushed at a time
struct Best2 {
  Key k1 = kEmpty, k2 = kEmpty;
  __device__ __forceinline__ void push(Key k) {
    const Key hi = k1 > k ? k1 : k;
    k1 = k1 < k ? k1 : k;
    k2 = k2 < hi ? k2 : hi;
  }
  // merge the best two of lane (lane ^ off)
  __device__ __forceinline__ void merge_xor(int off) {
    const Key o1 = __shfl_xor_sync(0xffffffffu, k1, off);
    const Key o2 = __shfl_xor_sync(0xffffffffu, k2, off);
    push(o1);
    push(o2);
  }
};

// shared memory of a block: the tile's (Tile<kWG>), then each row's best
// two keys so far
template <int kWG>
struct AssignSmem {
  static constexpr int kRun = Tile<kWG>::kBytes;
  static constexpr int kAlloc = Tile<kWG>::kAlloc + Tile<kWG>::kRows * 16;
};

template <int kWG>
__global__ void __launch_bounds__(Tile<kWG>::kThreads, 2)
    assign_tc_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_c,
                     Key* __restrict__ cand, int M, int B, int D, int per) {
  using L = Tile<kWG>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzling repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  float* const norms = reinterpret_cast<float*>(sbase + L::kNorm);
  const float* const nb = norms + L::kRows;
  Key* const run = reinterpret_cast<Key*>(sbase + AssignSmem<kWG>::kRun);

  const int row0 = blockIdx.x * L::kRows;
  const int split = blockIdx.y, splits = gridDim.y;
  const int n_tiles = (B + L::kCols - 1) / L::kCols;
  const int t0 = split * per, t1 = min(n_tiles, t0 + per);
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int q = lane % 4;
  const int nk = (D + kChunk - 1) / kChunk;
  // C fragment: lane holds rows lane/4 and lane/4 + 8 (half 0, 1) of its
  // warp's 16, and in every 8 columns (group j) the pair 8j + 2q + {0, 1},
  // at acc[h][4j + 2 half + {0, 1}]
  const int rl0 = wg * 64 + warp * 16 + lane / 4;  // + 8 half

  if (tid < 2 * L::kRows) run[tid] = kEmpty;
  init_ring<kWG>(base);  // its __syncthreads covers the line above
  for (int t = t0; t < t1; ++t) {
    const int col0 = t * L::kCols;
    float acc[kWG][32];
    const int next = t + 1 < t1 ? col0 + L::kCols : -1;
    norms[tid] = tile_dots<kWG>(&tm_x, &tm_c, base, sbase, row0, col0, next,
                                0, nk, (t - t0) * nk, acc);
    __syncthreads();
    // the rows' second best so far: no column above it can enter the best
    // two, so only the few at or below it are pushed (every one on the
    // block's first tile, then, as the best two settle, few)
    float na[2], cut[2];
    Best2 best[2];  // this lane's columns of the tile, for each row
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      na[half] = norms[rl0 + 8 * half];
      const Key second = run[2 * (rl0 + 8 * half) + 1];
      cut[half] = __uint_as_float(unsigned(second >> 32));
    }
#pragma unroll
    for (int h = 0; h < kWG; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int cl = h * 64 + 8 * j + 2 * q + i;
          const float nc = nb[cl];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float v = fmaxf(
                fmaf(-2.f, acc[h][4 * j + 2 * half + i], na[half] + nc), 0.f);
            if (v <= cut[half] && col0 + cl < B)
              best[half].push(make_key(v, col0 + cl));
          }
        }
    // each row's four lanes, then the block's earlier tiles; one lane a row
    // owns its running best two, and all four read them only after the
    // next tile's loop has passed a __syncthreads
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = rl0 + 8 * half;
      best[half].merge_xor(1);
      best[half].merge_xor(2);
      if (q == 0) {
        best[half].push(run[2 * rl]);
        best[half].push(run[2 * rl + 1]);
        run[2 * rl] = best[half].k1;
        run[2 * rl + 1] = best[half].k2;
      }
    }
    // the next tile's loop passes a __syncthreads before it rewrites norms
  }
  if (q == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = rl0 + 8 * half, r = row0 + rl;
      if (r >= M) continue;
      const size_t o = (static_cast<size_t>(r) * splits + split) * 2;
      cand[o] = run[2 * rl];
      cand[o + 1] = run[2 * rl + 1];
    }
  }
}

// one thread a row: the best two of its 2S candidates by tensor-core d2,
// re-computed in float32 FMAs in k order; the lower wins, ties to the
// lower index
__global__ void __launch_bounds__(128)
    assign_recheck_kernel(const float* __restrict__ X,
                          const float* __restrict__ C,
                          const Key* __restrict__ cand,
                          float* __restrict__ mind2, int32_t* __restrict__ idx,
                          int M, int B, int D, int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  Best2 best;
  const size_t o = static_cast<size_t>(r) * splits * 2;
  for (int k = 0; k < 2 * splits; ++k) best.push(cand[o + k]);
  // an empty slot (B = 1, or a split of one center) repeats the best
  const int i1 = key_index(best.k1);
  const int i2 = key_index(best.k2) < B ? key_index(best.k2) : i1;
  const float4* const x = reinterpret_cast<const float4*>(X) +
                          static_cast<size_t>(r) * (D / 4);
  const float4* const c1 = reinterpret_cast<const float4*>(C) +
                           static_cast<size_t>(i1) * (D / 4);
  const float4* const c2 = reinterpret_cast<const float4*>(C) +
                           static_cast<size_t>(i2) * (D / 4);
  float nx = 0.f, n1 = 0.f, n2 = 0.f, dot1 = 0.f, dot2 = 0.f;
  for (int k = 0; k < D / 4; ++k) {
    const float4 xv = __ldg(x + k), a = __ldg(c1 + k), b = __ldg(c2 + k);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    const float as[4] = {a.x, a.y, a.z, a.w};
    const float bs[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      nx = fmaf(xs[u], xs[u], nx);
      n1 = fmaf(as[u], as[u], n1);
      n2 = fmaf(bs[u], bs[u], n2);
      dot1 = fmaf(xs[u], as[u], dot1);
      dot2 = fmaf(xs[u], bs[u], dot2);
    }
  }
  const float v1 = fmaxf(fmaf(-2.f, dot1, nx + n1), 0.f);
  const float v2 = fmaxf(fmaf(-2.f, dot2, nx + n2), 0.f);
  const bool second = before(v2, i2, v1, i1);
  mind2[r] = second ? v2 : v1;
  idx[r] = second ? i2 : i1;
}

template <int kWG>
cudaError_t launch(EncodeTiled fn, const float* x, const float* c,
                   Key* cand, float* mind2, int32_t* idx,
                   int M, int B, int D, int splits, cudaStream_t stream) {
  using L = Tile<kWG>;
  constexpr int kAlloc = AssignSmem<kWG>::kAlloc;
  auto kernel = assign_tc_kernel<kWG>;
  static int configured_for = -1;  // once per instantiation and device
  cudaError_t err = configure(kernel, kAlloc, &configured_for);
  if (err != cudaSuccess) return err;
  CUtensorMap tx, tc;
  err = encode(fn, &tx, x, D, M, 1, L::kRows);
  if (err != cudaSuccess) return err;
  err = encode(fn, &tc, c, D, B, 1, L::kCols);
  if (err != cudaSuccess) return err;
  const int n_tiles = (B + L::kCols - 1) / L::kCols;
  const int per = (n_tiles + splits - 1) / splits;
  const dim3 grid((M + L::kRows - 1) / L::kRows, splits);
  kernel<<<grid, L::kThreads, kAlloc, stream>>>(tx, tc, cand, M, B, D, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  assign_recheck_kernel<<<(M + 127) / 128, 128, 0, stream>>>(
      x, c, cand, mind2, idx, M, B, D, splits);
  return cudaGetLastError();
}

}  // namespace

// x: (M, D), centers: (B, D) float32, mind2: (M,) float32, idx: (M,)
// int32, cand: (M, splits, 2) 64-bit scratch, all
// contiguous on device `device` with 16-byte aligned base addresses;
// D % 4 == 0 (TMA reads rows at 16-byte strides). block_m: rows of a block
// and columns of a center tile, 128 or 64; splits: center ranges per row
// tile, 1 ..= the center tiles (kernels/bucket_assign.py::launch_plan).
// Launches both passes on `stream` without synchronising; returns the
// first nonzero cudaError_t (0 = launched).
extern "C" int bucket_assign_sm90_launch(const float* x, const float* centers,
                                         Key* cand, float* mind2,
                                         int32_t* idx, int M,
                                         int B, int D, int block_m,
                                         int splits, int device,
                                         void* stream) {
  if (M <= 0 || B <= 0 || D <= 0 || D % 4 != 0 ||
      (block_m != 64 && block_m != 128) || splits < 1 ||
      splits > (B + block_m - 1) / block_m || splits > 65535 ||
      !aligned16(x) || !aligned16(centers))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  EncodeTiled fn = nullptr;
  err = encoder(&fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = block_m == 128
            ? launch<2>(fn, x, centers, cand, mind2, idx, M, B, D, splits, st)
            : launch<1>(fn, x, centers, cand, mind2, idx, M, B, D, splits, st);
  return static_cast<int>(err);
}
