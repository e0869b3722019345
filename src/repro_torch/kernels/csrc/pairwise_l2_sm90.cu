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
// Precision and main loop: l2_sm90.cuh (3xTF32 split in shared memory,
// per-chunk partial sums against the tensor cores' truncation), which
// bucket_assign_sm90.cu shares. The mask is pairwise_l2.cu's on every pair
// (and so is d2 wherever the mask could differ): an output whose d2 lies
// within l2_sm90.cuh's band of eps2 is flagged as the epilogue forms it,
// and after the tile's stores the lane that formed it recomputes it in
// pairwise_l2.cu's arithmetic (simt_d2, reading both rows from global
// memory, where the tile's loads have just left them in L2) and writes
// that d2 and mask over the tensor cores'. Nothing waits on the host. A
// recomputation holds its block through the rows' loads and a chain of D
// FMAs, so where eps2 sits among dense pairs the launch runs longer
// (PERF.md). Measured against this, and no faster: staging the rows in
// the freed ring, prefetching them, and a second launch that recomputes
// every flagged output of the grid at once (its chain of dependent loads
// cost as much, and more on the E = 1 tile). The flag test costs the
// epilogue a few instructions an output and the recomputation sits
// outside its unrolled loop, which keeps its registers. `inband`, where
// not null, counts the recomputed outputs.
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
// warpgroups, each owning 64 rows and every column of the tile. kWG = 2
// (128 x 128, 256 threads) for the batched verify; kWG = 1 (64 x 64)
// where M <= 64, so the query tile (Qp <= 64 rows x 2048) computes no pad
// rows and runs 32 blocks where 128-column tiles would give 16. Every
// output comes from the same n64 product and the same k order whatever
// the tile, lane or E, which keeps host-mode and device-mode joins
// byte-identical. The tile's dot products and norms come from
// l2_sm90.cuh's tile_dots over 3-D maps (D, rows, E). The epilogue swaps
// pairs of columns between neighbouring lanes so each thread writes 4
// consecutive outputs: 16-byte d2 and 4-byte mask stores.
#include <cstdint>

#include "l2_sm90.cuh"

namespace {

using namespace l2sm90;

// pairwise_l2.cu's d2 and mask of the output at offset `at` of (E, M, N)
__device__ __forceinline__ void recheck_at(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           float* __restrict__ d2,
                                           int8_t* __restrict__ mask, int M,
                                           int N, int D, float eps2,
                                           size_t at) {
  const size_t er = at / N;  // e M + r
  const int c = static_cast<int>(at - er * N);
  const float* const bc[1] = {b + (er / M * N + c) * D};
  float v[1];
  simt_d2<1>(a + er * D, bc, D, v);
  d2[at] = v[0];
  mask[at] = v[0] <= eps2;
}

template <int kWG>
__global__ void __launch_bounds__(Tile<kWG>::kThreads, 2)
    pairwise_l2_tc_kernel(const __grid_constant__ CUtensorMap tm_a,
                          const __grid_constant__ CUtensorMap tm_b,
                          const float* __restrict__ a,
                          const float* __restrict__ b,
                          float* __restrict__ d2, int8_t* __restrict__ mask,
                          int M, int N, int D, float eps2,
                          unsigned long long* __restrict__ inband) {
  using L = Tile<kWG>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzling repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  float* const norms = reinterpret_cast<float*>(sbase + L::kNorm);

  const int e = blockIdx.z;
  const int row0 = blockIdx.y * L::kRows, col0 = blockIdx.x * L::kCols;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int nk = (D + kChunk - 1) / kChunk;

  init_ring<kWG>(base);
  float acc[kWG][32];
  const float norm = tile_dots<kWG>(&tm_a, &tm_b, base, sbase, row0, col0,
                                    -1, e, nk, 0, acc);

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
  const float ku = band_scale(D);
  // bit ((half kWG + h) 4 + p) 4 + j: this lane's output j (columns ca,
  // ca + 1, ca + 8, ca + 9) of (half, h, p) lies within the band of eps2
  unsigned long long flagged = 0;
  const auto out_row = [&](int bit) {
    return row0 + wg * 64 + warp * 16 + lane / 4 + 8 * ((bit >> 4) / kWG);
  };
  const auto out_col = [&](int bit) {
    const int p = (bit >> 2) & 3, h = (bit >> 4) % kWG, j = bit & 3;
    return col0 + h * 64 + 16 * p + 2 * q + (j & 1) + 8 * (j >> 1);
  };
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
        for (int j = 0; j < 4; ++j) {
          const int cl = ca + (j & 1) + 8 * (j >> 1);
          const float s = na + nb[cl];
          v[j] = fmaxf(fmaf(-2.f, acc[h][8 * p + 4 * (j >> 1) + 2 * half
                                         + (j & 1)], s), 0.f);
          if (fabsf(v[j] - eps2) <= fmaf(ku, s, kBandFloor) &&
              s < kNoRecheck)
            flagged |= 1ull << (((half * kWG + h) * 4 + p) * 4 + j);
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
  // the outputs within the band, after the warp's stores (this lane's or
  // its neighbour's): pairwise_l2.cu's d2 and mask over the tensor cores'
  __syncwarp();
  if (!__any_sync(0xffffffffu, flagged != 0)) return;
  const auto lowest = [](unsigned long long f) {
    return __ffsll(static_cast<long long>(f)) - 1;
  };
  for (unsigned long long f = flagged; f != 0; f &= f - 1) {  // in range
    const int bit = lowest(f);
    if (out_row(bit) >= M || out_col(bit) >= N) flagged &= ~(1ull << bit);
  }
  if (inband != nullptr) {
    const unsigned n = __reduce_add_sync(0xffffffffu, __popcll(flagged));
    if (lane == 0 && n > 0)
      atomicAdd(inband, static_cast<unsigned long long>(n));
  }
  const auto offset = [&](int bit) {
    return (static_cast<size_t>(e) * M + out_row(bit)) * N + out_col(bit);
  };
  for (; flagged != 0; flagged &= flagged - 1)
    recheck_at(a, b, d2, mask, M, N, D, eps2, offset(lowest(flagged)));
}

// ---- host side ---------------------------------------------------------------
template <int kWG>
cudaError_t launch(EncodeTiled fn, const float* a, const float* b, float* d2,
                   int8_t* mask, int E, int M, int N, int D, float eps2,
                   unsigned long long* inband, cudaStream_t stream) {
  using L = Tile<kWG>;
  auto kernel = pairwise_l2_tc_kernel<kWG>;
  static int configured_for = -1;  // once per instantiation and device
  cudaError_t err = configure(kernel, L::kAlloc, &configured_for);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  err = encode(fn, &ta, a, D, M, E, L::kRows);
  if (err != cudaSuccess) return err;
  err = encode(fn, &tb, b, D, N, E, L::kCols);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + L::kCols - 1) / L::kCols, (M + L::kRows - 1) / L::kRows,
                  E);
  kernel<<<grid, L::kThreads, L::kAlloc, stream>>>(ta, tb, a, b, d2, mask, M,
                                                    N, D, eps2, inband);
  return cudaGetLastError();
}

}  // namespace

// a: (E, M, D), b: (E, N, D), d2: (E, M, N) float32, mask: (E, M, N) int8,
// all contiguous on device `device` with 16-byte aligned base addresses;
// D % 4 == 0 (TMA reads rows at 16-byte strides). block_m: output rows of
// a block, 128 or 64 (kernels/pairwise_l2.py::launch_plan). inband: null,
// or a device counter that gains the launch's recomputed outputs. Launches
// on `stream` without synchronising; returns the first nonzero
// cudaError_t (0 = launched).
extern "C" int pairwise_l2_sm90_launch(const float* a, const float* b,
                                       float* d2, int8_t* mask, int E, int M,
                                       int N, int D, float eps2, int block_m,
                                       unsigned long long* inband, int device,
                                       void* stream) {
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
            ? launch<2>(fn, a, b, d2, mask, E, M, N, D, eps2, inband, st)
            : launch<1>(fn, a, b, d2, mask, E, M, N, D, eps2, inband, st);
  return static_cast<int>(err);
}
