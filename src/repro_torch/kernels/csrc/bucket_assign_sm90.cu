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
//    branchless min and max), and the third least d2, skipping every
//    column whose d2 exceeds the row's third least so far; the four lanes
//    that share a row merge theirs, and one of them merges the result into
//    the row's of the earlier tiles, kept in shared memory (so they hold
//    no registers through the main loop). The block writes its rows' two
//    candidates and third d2 to a scratch (M, S, 3).
// 2. assign_recheck_kernel, one thread a row: recomputes the row's best
//    two candidates by tensor-core d2 in bucket_assign.cu's arithmetic
//    (simt_d2), side by side. The tensor cores round their sums toward
//    zero, so their d2 runs a few ulps high and unevenly (l2_sm90.cuh):
//    on near-ties their ranking is not float32's, and the CUDA-core winner
//    can lie anywhere among the centers within l2_sm90.cuh's band of each
//    other. So every other candidate whose CUDA-core d2 could reach the
//    winner so far (simt_floor of its tensor-core d2 not above it) is
//    recomputed too, and the least (d2, index) wins, ties to the lower
//    index as in bucket_assign.cu. A split's dropped centers lie at or
//    above its third d2; where that one's floor does not lie above the
//    winner (three centers of one split within the band of each other),
//    a center pass 1 dropped could win, and the row goes on a list in the
//    block's shared memory. Once every row of the block is decided, the
//    block's threads rescan each listed row over the centers of each such
//    split, four a thread at a time, in bucket_assign.cu's arithmetic. So
//    the index and mind2 are bucket_assign.cu's, byte for byte, on every
//    row, however many centers tie. A list per block, walked by that
//    block, needs no third launch, no capacity and no reset, and nothing
//    waits on the host; rows on it are rare. Why the third d2: with only
//    each split's best two, a near-tie of two centers in one split (one
//    row in 8,192 on random data) had to be rescanned, some 9 us at 1,000
//    centers, and keeping the best three keys instead cost pass 1 10 %
//    (PERF.md). `rescanned`, where not null, counts the listed rows.
//    Neither the split count nor the tile a center lands in changes a
//    result: every candidate's tensor-core d2 comes from the same n64
//    product and k order wherever it is computed, the best two and the
//    third of a total order are those of its parts', and the rescan and
//    the recomputations are the CUDA-core arithmetic, wherever they run.
#include <cmath>
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

__device__ __forceinline__ float key_d2(Key k) {
  return __uint_as_float(unsigned(k >> 32));
}

// the best two keys k1 <= k2 of a set, and the third least d2 v3, one
// member pushed at a time
struct Best2 {
  Key k1 = kEmpty, k2 = kEmpty;
  float v3 = INFINITY;
  __device__ __forceinline__ void push(Key k) {
    const Key hi = k1 > k ? k1 : k;
    k1 = k1 < k ? k1 : k;
    const Key hi2 = k2 > hi ? k2 : hi;
    k2 = k2 < hi ? k2 : hi;
    v3 = fminf(v3, key_d2(hi2));
  }
  // merge those of lane (lane ^ off)
  __device__ __forceinline__ void merge_xor(int off) {
    const Key o1 = __shfl_xor_sync(0xffffffffu, k1, off);
    const Key o2 = __shfl_xor_sync(0xffffffffu, k2, off);
    const float o3 = __shfl_xor_sync(0xffffffffu, v3, off);
    push(o1);
    push(o2);
    v3 = fminf(v3, o3);
  }
};

// shared memory of a block: the tile's (Tile<kWG>), then each row's best
// two keys and third d2 so far
template <int kWG>
struct AssignSmem {
  static constexpr int kRun = Tile<kWG>::kBytes;
  static constexpr int kThird = kRun + Tile<kWG>::kRows * 16;
  static constexpr int kAlloc = Tile<kWG>::kAlloc + Tile<kWG>::kRows * 20;
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
  float* const third =
      reinterpret_cast<float*>(sbase + AssignSmem<kWG>::kThird);

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
  if (tid < L::kRows) third[tid] = __int_as_float(0x7f800000);
  init_ring<kWG>(base);  // its __syncthreads covers the lines above
  for (int t = t0; t < t1; ++t) {
    const int col0 = t * L::kCols;
    float acc[kWG][32];
    const int next = t + 1 < t1 ? col0 + L::kCols : -1;
    norms[tid] = tile_dots<kWG>(&tm_x, &tm_c, base, sbase, row0, col0, next,
                                0, nk, (t - t0) * nk, acc);
    __syncthreads();
    // the rows' third least d2 so far: no column above it can enter the
    // best two or change the third, so only the few at or below it are
    // pushed (every one on the block's first tile, then, as the best
    // settle, few)
    float na[2], cut[2];
    Best2 best[2];  // this lane's columns of the tile, for each row
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      na[half] = norms[rl0 + 8 * half];
      cut[half] = third[rl0 + 8 * half];
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
        best[half].v3 = fminf(best[half].v3, third[rl]);
        run[2 * rl] = best[half].k1;
        run[2 * rl + 1] = best[half].k2;
        third[rl] = best[half].v3;
      }
    }
    // the next tile's loop passes a __syncthreads before it rewrites norms
  }
  if (q == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = rl0 + 8 * half, r = row0 + rl;
      if (r >= M) continue;
      const size_t o = (static_cast<size_t>(r) * splits + split) * 3;
      cand[o] = run[2 * rl];
      cand[o + 1] = run[2 * rl + 1];
      cand[o + 2] = make_key(third[rl], kNone);
    }
  }
}

constexpr int kRecheckThreads = 128;

// the least key of a block: every thread calls it with its own; the
// result reaches thread 0 (`part`: a word a warp in shared memory)
__device__ __forceinline__ Key block_min(Key k, Key* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Key o = __shfl_xor_sync(0xffffffffu, k, off);
    k = o < k ? o : k;
  }
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = k;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kRecheckThreads / 32; ++w)
      k = part[w] < k ? part[w] : k;
  return k;
}

// one thread a row: its best two candidates by tensor-core d2 and every
// other candidate that could come within reach of the winner so far,
// recomputed in bucket_assign.cu's arithmetic, the least (d2, index)
// winning; rows where a split's dropped centers could come within reach go
// on a list, and the block rescans those splits over their centers
__global__ void __launch_bounds__(kRecheckThreads)
    assign_recheck_kernel(const float* __restrict__ X,
                          const float* __restrict__ C,
                          const Key* __restrict__ cand,
                          float* __restrict__ mind2, int32_t* __restrict__ idx,
                          int M, int B, int D, int splits, int span,
                          unsigned long long* __restrict__ rescanned) {
  __shared__ int listed[kRecheckThreads];
  __shared__ Key listed_win[kRecheckThreads];
  __shared__ float listed_nx[kRecheckThreads];
  __shared__ int n_listed;
  __shared__ Key part[kRecheckThreads / 32];
  const int r = blockIdx.x * kRecheckThreads + threadIdx.x;
  const float ku = band_scale(D);
  if (threadIdx.x == 0) n_listed = 0;
  __syncthreads();
  if (r < M) {
    const Key* const cr = cand + static_cast<size_t>(r) * splits * 3;
    const float* const x = X + static_cast<size_t>(r) * D;
    // the best two candidates, the least d2 of the others and of anything
    // a split dropped
    Best2 best;
    float dropped = __int_as_float(0x7f800000);
    for (int sp = 0; sp < splits; ++sp) {
      best.push(cr[3 * sp]);
      best.push(cr[3 * sp + 1]);
      dropped = fminf(dropped, key_d2(cr[3 * sp + 2]));
    }
    // the best two side by side (an empty second, B = 1, repeats the
    // first)
    const int i1 = key_index(best.k1);
    const int i2 = best.k2 != kEmpty ? key_index(best.k2) : i1;
    const float* const c2[2] = {C + static_cast<size_t>(i1) * D,
                                C + static_cast<size_t>(i2) * D};
    float v[2];
    const float nx = simt_d2<2>(x, c2, D, v);
    Key win = make_key(v[0], i1);
    if (make_key(v[1], i2) < win) win = make_key(v[1], i2);
    // any other candidate whose floor does not lie above the winner so far
    // could win or tie: recomputed too (floors rise with d2, so none can
    // unless the third candidate's can)
    if (simt_floor(ku, nx, best.v3) <= key_d2(win))
      for (int k = 0; k < 3 * splits; ++k)
        if (k % 3 != 2 && cr[k] != best.k1 && cr[k] != best.k2 &&
            simt_floor(ku, nx, key_d2(cr[k])) <= key_d2(win)) {
          const int i = key_index(cr[k]);
          const float* const c1[1] = {C + static_cast<size_t>(i) * D};
          float v1[1];
          simt_d2<1>(x, c1, D, v1);
          if (make_key(v1[0], i) < win) win = make_key(v1[0], i);
        }
    // a split's dropped centers lie at or above its third least d2
    if (simt_floor(ku, nx, dropped) <= key_d2(win)) {
      const int l = atomicAdd(&n_listed, 1);
      listed[l] = r;
      listed_win[l] = win;
      listed_nx[l] = nx;
    } else {
      mind2[r] = key_d2(win);
      idx[r] = key_index(win);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && rescanned != nullptr && n_listed > 0)
    atomicAdd(rescanned, static_cast<unsigned long long>(n_listed));
  // the listed rows, one at a time, over the centers of each split that
  // could reach: each thread takes centers j, j + T, j + 2T, j + 3T (T
  // threads), then the next 4T
  for (int l = 0; l < n_listed; ++l) {
    const int row = listed[l];
    const float* const x = X + static_cast<size_t>(row) * D;
    const Key* const cr = cand + static_cast<size_t>(row) * splits * 3;
    Key mine = listed_win[l];
    for (int sp = 0; sp < splits; ++sp) {
      if (!(simt_floor(ku, listed_nx[l], key_d2(cr[3 * sp + 2])) <=
            key_d2(listed_win[l])))  // (a floor of +inf is NaN)
        continue;
      const int end = min(B, (sp + 1) * span);
      for (int j0 = sp * span + threadIdx.x; j0 < end;
           j0 += 4 * kRecheckThreads) {
        // past the split's end: its last center, the result unused
        const auto center = [&](int q) {
          const int j = min(j0 + q * kRecheckThreads, end - 1);
          return C + static_cast<size_t>(j) * D;
        };
        const float* const c[4] = {center(0), center(1), center(2),
                                   center(3)};
        float v[4];
        simt_d2<4>(x, c, D, v);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + q * kRecheckThreads;
          const Key k = make_key(v[q], j);
          if (j < end && k < mine) mine = k;
        }
      }
    }
    mine = block_min(mine, part);
    if (threadIdx.x == 0) {
      mind2[row] = key_d2(mine);
      idx[row] = key_index(mine);
    }
    __syncthreads();  // part is rewritten by the next row
  }
}

template <int kWG>
cudaError_t launch(EncodeTiled fn, const float* x, const float* c,
                   Key* cand, float* mind2, int32_t* idx, int M, int B,
                   int D, int splits, unsigned long long* rescanned,
                   cudaStream_t stream) {
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
  assign_recheck_kernel<<<(M + kRecheckThreads - 1) / kRecheckThreads,
                          kRecheckThreads, 0, stream>>>(
      x, c, cand, mind2, idx, M, B, D, splits, per * L::kCols, rescanned);
  return cudaGetLastError();
}

}  // namespace

// x: (M, D), centers: (B, D) float32, mind2: (M,) float32, idx: (M,)
// int32, cand: (M, splits, 3) 64-bit scratch, all
// contiguous on device `device` with 16-byte aligned base addresses;
// D % 4 == 0 (TMA reads rows at 16-byte strides). block_m: rows of a block
// and columns of a center tile, 128 or 64; splits: center ranges per row
// tile, 1 ..= the center tiles (kernels/bucket_assign.py::launch_plan).
// rescanned: null, or a device counter that gains the launch's rescanned
// rows. Launches both passes on `stream` without synchronising; returns
// the first nonzero cudaError_t (0 = launched).
extern "C" int bucket_assign_sm90_launch(const float* x, const float* centers,
                                         Key* cand, float* mind2,
                                         int32_t* idx, int M,
                                         int B, int D, int block_m,
                                         int splits,
                                         unsigned long long* rescanned,
                                         int device, void* stream) {
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
            ? launch<2>(fn, x, centers, cand, mind2, idx, M, B, D, splits,
                        rescanned, st)
            : launch<1>(fn, x, centers, cand, mind2, idx, M, B, D, splits,
                        rescanned, st);
  return static_cast<int>(err);
}
