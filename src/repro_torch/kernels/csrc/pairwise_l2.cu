// Batched pairwise squared-L2 distance with an epsilon threshold on the
// CUDA cores: the verify route for rows that are not 16-byte aligned
// (D % 4 != 0, kernels/pairwise_l2.py::launch_plan). Aligned rows, the
// whole main path, take pairwise_l2_sm90.cu on the tensor cores, which
// computes the same function.
//
// Replaces: src/repro/kernels/pairwise_l2.py, pairwise_l2_threshold_batched
// (body _pairwise_kernel_batched) and its unbatched twin
// pairwise_l2_threshold (body _pairwise_kernel), which here is the E = 1
// launch of the same kernel.
//
// Computes, for every lane e < E, row i < M of A[e] and row j < N of B[e]:
//   d2[e,i,j]   = max(|a|^2 + |b|^2 - 2 a.b, 0)   (float32 accumulation)
//   mask[e,i,j] = d2[e,i,j] <= eps2               (int8)
// eps2 arrives as the float32 rounding of the float64 product eps*eps.
//
// What bounds it on an H100: at a shape like the main path's (E = 32
// lanes of 2048 x 2048 x 128) a lane is 1.07 GFLOP against ~23 MB of
// traffic (2.1 MB in, 21 MB of d2 + mask out), so it is bound by float32
// FMA throughput outside the tensor cores (67 TFLOP/s: ~16 us a lane;
// memory ~7 us). Plain TF32 on the tensor cores keeps ~3 decimal digits,
// which the verify tolerances do not absorb; the tensor-core route splits
// each operand into two TF32 halves (3xTF32) to keep float32's accuracy.
//
// Design: the TPU kernel's sequential k grid axis becomes the depth loop
// inside one thread block per (lane, 128 x 128 output tile) (l2_tile.cuh);
// each thread keeps an 8 x 8 register micro-tile, so every shared-memory
// operand feeds 8 FMAs. The norms come from the same staged slices and the
// threshold is fused into the epilogue, so d2 is written once and never
// re-read. Each output's reduction order is fixed and independent of the
// lane and of E, which makes host-mode and device-mode joins byte-identical.
#include <cstdint>

#include "l2_tile.cuh"

namespace {

constexpr int kBM = 128;

__global__ void __launch_bounds__(l2tile::kThreads, 2)
    pairwise_l2_threshold_kernel(const float* __restrict__ A,
                                 const float* __restrict__ B,
                                 float* __restrict__ d2,
                                 int8_t* __restrict__ mask, int M, int N,
                                 int D, float eps2) {
  __shared__ l2tile::Smem<kBM> s;
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * l2tile::kBN;
  const float* Ae = A + static_cast<size_t>(e) * M * D;
  const float* Be = B + static_cast<size_t>(e) * N * D;
  float acc[kBM / 16][8];
  l2tile::tile_dot<kBM>(Ae, M, row0, Be, N, col0, D, s, acc);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool vec = (N % 4) == 0;  // 16-byte aligned rows: vector stores
#pragma unroll
  for (int i = 0; i < kBM / 16; ++i) {
    const int rl = ty * 4 + (i / 4) * 64 + i % 4;
    const int r = row0 + rl;
    if (r >= M) continue;
    const float na = s.na[rl];
    const size_t base = (static_cast<size_t>(e) * M + r) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cl = tx * 4 + h * 64;
      const int c = col0 + cl;
      float v[4];
      char m[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = fmaxf(na + s.nb[cl + j] - 2.0f * acc[i][h * 4 + j], 0.f);
        m[j] = v[j] <= eps2 ? 1 : 0;
      }
      if (vec && c + 3 < N) {
        *reinterpret_cast<float4*>(d2 + base + c) =
            make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<char4*>(mask + base + c) =
            make_char4(m[0], m[1], m[2], m[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j < N) {
            d2[base + c + j] = v[j];
            mask[base + c + j] = m[j];
          }
        }
      }
    }
  }
}

}  // namespace

// a: (E, M, D), b: (E, N, D), d2: (E, M, N) float32, mask: (E, M, N) int8,
// all contiguous on device `device`. Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 = launched).
extern "C" int pairwise_l2_threshold_launch(const float* a, const float* b,
                                            float* d2, int8_t* mask, int E,
                                            int M, int N, int D, float eps2,
                                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + l2tile::kBN - 1) / l2tile::kBN, (M + kBM - 1) / kBM,
                  E);
  pairwise_l2_threshold_kernel<<<grid, l2tile::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      a, b, d2, mask, M, N, D, eps2);
  return static_cast<int>(cudaGetLastError());
}
