// Shared tile core of the port's two distance kernels (pairwise_l2.cu and
// bucket_assign.cu): one thread block computes the dot products of a
// ROWS x 128 output tile in float32 CUDA-core FMAs, plus the squared row
// norms of both operand tiles, summed from the same staged slices.
//
// Layout: 256 threads as a 16 x 16 grid (tx = t % 16, ty = t / 16). A
// thread owns rows ty*4 + g*64 + {0..3} (g < ROWS/64) and columns
// tx*4 + h*64 + {0..3} (h < 2) of the tile: an (ROWS/16) x 8 register
// micro-tile. The depth loop stages BK-deep slices of both operands in
// shared memory, k-major, double-buffered: the next slice's global loads
// are issued into registers before the current slice is consumed.
//
// Ragged edges are masked here: rows past the matrix and depth past D
// load as 0, so no caller pads (a zero column adds 0 to every dot and
// norm). Every output's reduction runs over k in one fixed order, with
// no split and no atomics, so a value never depends on the grid, the
// batch lane or the tile it landed in.
#pragma once

#include <cstddef>
#include <cuda_runtime.h>

namespace l2tile {

constexpr int kThreads = 256;
constexpr int kBN = 128;  // tile columns
constexpr int kBK = 8;    // depth of one staged slice
constexpr int kPad = 4;   // keeps the transposed stores free of bank conflicts

template <int ROWS>
struct __align__(16) Smem {
  float a[2][kBK][ROWS + kPad];
  float b[2][kBK][kBN + kPad];
  float na[ROWS];  // squared norms of the tile's A rows
  float nb[kBN];   // squared norms of the tile's B rows
};

// acc[i][j] <- dot(A[row0 + r(i)], B[col0 + c(j)]) with
// r(i) = ty*4 + (i/4)*64 + i%4 and c(j) = tx*4 + (j/4)*64 + j%4;
// s.na / s.nb hold the tile's squared row norms on return.
template <int ROWS>
__device__ __forceinline__ void tile_dot(const float* __restrict__ A, int M,
                                         int row0,
                                         const float* __restrict__ B, int N,
                                         int col0, int D, Smem<ROWS>& s,
                                         float (&acc)[ROWS / 16][8]) {
  constexpr int RG = ROWS / 64;
  constexpr int EA = ROWS * kBK / kThreads;  // A elements a thread stages
  constexpr int EB = kBN * kBK / kThreads;   // B elements a thread stages
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int ar = t / (kBK / EA), ak = (t % (kBK / EA)) * EA;
  const int br = t / (kBK / EB), bk = (t % (kBK / EB)) * EB;
  const bool a_row_ok = row0 + ar < M, b_row_ok = col0 + br < N;
  const float* a_src = A + static_cast<size_t>(row0 + ar) * D;
  const float* b_src = B + static_cast<size_t>(col0 + br) * D;

#pragma unroll
  for (int i = 0; i < RG * 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[EA], rb[EB];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < EA; ++j) {
      const int k = k0 + ak + j;
      ra[j] = (a_row_ok && k < D) ? a_src[k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < EB; ++j) {
      const int k = k0 + bk + j;
      rb[j] = (b_row_ok && k < D) ? b_src[k] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < EA; ++j) s.a[buf][ak + j][ar] = ra[j];
#pragma unroll
    for (int j = 0; j < EB; ++j) s.b[buf][bk + j][br] = rb[j];
  };

  // threads [0, ROWS) sum the A row norms, [kThreads - kBN, kThreads) the
  // B row norms (the two ranges overlap nowhere for ROWS <= 128)
  const bool norm_a = t < ROWS, norm_b = t >= kThreads - kBN;
  const int nrow = norm_a ? t : t - (kThreads - kBN);
  float norm = 0.f;

  const int nk = (D + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int it = 0; it < nk; ++it) {
    const int cur = it & 1;
    if (it + 1 < nk) load((it + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      if (norm_a) {
        const float v = s.a[cur][kk][nrow];
        norm = fmaf(v, v, norm);
      } else if (norm_b) {
        const float v = s.b[cur][kk][nrow];
        norm = fmaf(v, v, norm);
      }
      float av[RG * 4], bv[8];
#pragma unroll
      for (int g = 0; g < RG; ++g)
        *reinterpret_cast<float4*>(&av[g * 4]) =
            *reinterpret_cast<const float4*>(&s.a[cur][kk][ty * 4 + g * 64]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(&bv[h * 4]) =
            *reinterpret_cast<const float4*>(&s.b[cur][kk][tx * 4 + h * 64]);
#pragma unroll
      for (int i = 0; i < RG * 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (it + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
  if (norm_a) s.na[nrow] = norm;
  else if (norm_b) s.nb[nrow] = norm;
  __syncthreads();
}

}  // namespace l2tile
