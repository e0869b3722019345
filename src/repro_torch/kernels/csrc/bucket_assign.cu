// Fused nearest-center assignment: scan 2 of bucketization.
//
// Replaces: src/repro/kernels/bucket_assign.py, bucket_assign (body
// _assign_kernel).
//
// Computes, for every row i < M of X against the center table C (B, D):
//   mind2[i] = min_b max(|x|^2 + |c_b|^2 - 2 x.c_b, 0)   (float32)
//   idx[i]   = the lowest b attaining that minimum       (int32)
//
// What bounds it on an H100: at the main path's shape (8192 rows x 1000
// centers x 128) a launch is ~2.1 GFLOP against ~4.7 MB in and 64 KB out,
// so float32 FMA throughput bounds it (67 TFLOP/s: ~31 us; memory ~1.4 us).
//
// Design: one thread block per 64-row tile of X walks every 128-center
// tile inside the block (l2_tile.cuh computes each 64 x 128 dot tile), so
// no running minimum has to carry across blocks as the TPU grid's
// sequential center axis did. Only 2 values per row leave the block; the
// (64 x 128) distance tile never reaches device memory. Ties go to the
// lower center index at every step: ascending within a thread, lower index
// on equal values across the 16 threads of a row, and a strict < across
// center tiles, which come in ascending order. Ragged rows and centers are
// masked in-kernel, so no far-away pad centers are needed.
#include <cstdint>

#include "l2_tile.cuh"

namespace {

constexpr int kBM = 64;

__global__ void __launch_bounds__(l2tile::kThreads)
    bucket_assign_kernel(const float* __restrict__ X,
                         const float* __restrict__ C,
                         float* __restrict__ mind2, int32_t* __restrict__ idx,
                         int M, int B, int D) {
  __shared__ l2tile::Smem<kBM> s;
  const int row0 = blockIdx.x * kBM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float run_v[4];
  int run_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run_v[i] = __int_as_float(0x7f800000);  // +inf
    run_i[i] = 0;
  }
  for (int col0 = 0; col0 < B; col0 += l2tile::kBN) {
    float acc[kBM / 16][8];
    l2tile::tile_dot<kBM>(X, M, row0, C, B, col0, D, s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float nx = s.na[ty * 4 + i];
      float bv = __int_as_float(0x7f800000);
      int bi = 0x7fffffff;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = tx * 4 + h * 64 + j;
          if (col0 + cl < B) {
            const float v =
                fmaxf(nx + s.nb[cl] - 2.0f * acc[i][h * 4 + j], 0.f);
            if (v < bv) {
              bv = v;
              bi = col0 + cl;
            }
          }
        }
      }
      // the 16 threads sharing these rows are lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov < bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (bv < run_v[i]) {
        run_v[i] = bv;
        run_i[i] = bi;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r < M) {
        mind2[r] = run_v[i];
        idx[r] = run_i[i];
      }
    }
  }
}

}  // namespace

// x: (M, D), centers: (B, D) float32, mind2: (M,) float32, idx: (M,) int32,
// all contiguous on device `device`. Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 = launched).
extern "C" int bucket_assign_launch(const float* x, const float* centers,
                                    float* mind2, int32_t* idx, int M, int B,
                                    int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM);
  bucket_assign_kernel<<<grid, l2tile::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, centers, mind2, idx, M, B, D);
  return static_cast<int>(cudaGetLastError());
}
