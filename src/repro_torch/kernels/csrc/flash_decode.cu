// Split-KV grouped-head attention for decode: every attention layer of the
// LM whose query rows (Sq * g) fit one decode tile (<= 16), bf16 or
// float32, any head dim the port takes (a multiple of 16 up to 256).
//
// Replaces: src/repro/kernels/flash_attention.py:77, flash_attention (body
// _flash_kernel), and computes the function of the region the JAX model
// runs in its place, src/repro/models/layers.py:134, gqa_scores_chunked.
//
// The function, as flash_attention.cu states it: for q (B, Sq, H, D) and
// k, v (B, T, Hkv, D), query head h reads KV head h / g. With p_c the
// position of key c (kv_pos[c], or c when kv_pos is null) and q_pos =
// q_offset + s, key c is seen by query s iff p_c >= 0, (causal) q_pos >=
// p_c and (window > 0) p_c > q_pos - window. A key not seen takes the
// finite score -1e30, a key past T takes -inf, the softmax sum is clamped
// at 1e-30, and o is written contiguous (B, Sq, H, D) in q's type. Rows
// with no visible key are outside the contract.
//
// What bounds it on an H100: at the decode shape (B 4, Sq 1, H 16, Hkv 8,
// D 128, a 512-slot cache with 301 positions written) the K and V rows a
// query sees are 4.9 MB of bf16 against 2.5 MFLOP: bytes bound it (1.5 us
// at 3.35 TB/s). What such a small launch takes is latency: the number of
// blocks in flight and the dependent steps each block walks.
//
// Design, two launches on one stream:
//   pass 1, one 128-thread block per (64-key split, KV head, batch): the
//     block reads its split's positions first; a split no query row sees
//     writes an empty partial (m = -inf, l = 0) and loads no K or V (the
//     unwritten slots of a cache cost their positions only). Otherwise it
//     copies the K and V rows some row sees with cp.async, 16 bytes a
//     thread along D (the rest are zeros), and computes only the R = Sq*g
//     real rows: S = Q K^T with a thread per key (K rows padded by 16 bytes
//     so the reads are free of bank conflicts), the mask, the split's max
//     m and sum l (float32, expf), and acc = P V with a thread per column
//     pair. It writes the float32 partial (m, l, acc[D]) of every
//     (batch, KV head, split, row) to scratch the caller allocates.
//   pass 2, one block per (row, KV head, batch): merges the splits,
//     o = sum_s exp(m_s - M) acc_s / max(sum_s exp(m_s - M) l_s, 1e-30)
//     with M the largest m_s, skipping empty splits, and writes o in q's
//     type (or float32, for a merge across ranks) and, where asked, the
//     row's log-sum-exp M + log(sum_s exp(m_s - M) l_s) (-inf for a row
//     that sees no key).
// Across ranks: a decode cache split over its sequence is attended one
// slice a rank (flash_decode_launch with lse), and the slices' outputs
// merge by pass 2 alone (flash_decode_merge_launch): slice r's partial is
// (m, l) = (lse_r, 1) with acc = o_r, so the merge weighs o_r by
// exp(lse_r - lse) and gives a slice with lse -inf no weight.
// For the decode shape that is 8 splits x 8 KV heads x 4 = 256 blocks.
// All arithmetic is float32 on the CUDA cores.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSplit = 64;     // keys per split (launch_plan's SPLIT_KEYS)
constexpr int kMaxRows = 16;   // R = Sq * g at most (DECODE_MAX_ROWS)
constexpr float kNegFill = -1e30f;
constexpr int kAbsent = INT_MIN;  // key index past T

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;                  // contiguous (B, Sq, H, D), q's type
  const int32_t* kv_pos;    // (T,) or null: positions are the indices
  float* part_ml;           // (B, Hkv, n_splits, R, 2): m, l
  float* part_acc;          // (B, Hkv, n_splits, R, D)
  float* lse;               // (B, Sq, H) or null
  int o_f32;                // o is float32 whatever q's type
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int Sq, T, H, Hkv, D, g, n_splits;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

__device__ __forceinline__ bool visible(int p, int qpos, const Args& a) {
  return p >= 0 && (!a.causal || qpos >= p) &&
         (a.window <= 0 || p > qpos - a.window);
}

// 16 bytes (4 float32 or 8 bf16) widened to float32, exactly
__device__ __forceinline__ void widen16(const float* p, float* x) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int DMAX>
struct Layout {
  static constexpr int kE = 16 / sizeof(T);   // elements in 16 bytes
  static constexpr int kLdK = DMAX + kE;      // a K row, padded by 16 bytes
  static constexpr int kK = 0;                                 // T [kSplit][kLdK]
  static constexpr int kV = kK + kSplit * kLdK * sizeof(T);    // T [kSplit][DMAX]
  static constexpr int kQ = kV + kSplit * DMAX * sizeof(T);    // f32 [16][DMAX]
  static constexpr int kP = kQ + kMaxRows * DMAX * 4;          // f32 [16][kSplit]
  static constexpr int kPos = kP + kMaxRows * kSplit * 4;      // int [kSplit]
  static constexpr int kLoad = kPos + kSplit * 4;              // int [kSplit]
  static constexpr int kBytes = kLoad + kSplit * 4;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    decode_partial_kernel(const Args a) {
  using L = Layout<T, DMAX>;
  constexpr int kE = L::kE;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem + L::kK);
  T* vs = reinterpret_cast<T*>(smem + L::kV);
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* ps = reinterpret_cast<float*>(smem + L::kP);
  int* pos = reinterpret_cast<int*>(smem + L::kPos);
  int* load = reinterpret_cast<int*>(smem + L::kLoad);

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, g = a.g, R = a.Sq * g, D = a.D;
  const int c0 = split * kSplit;
  // partial row 0 of this (batch, KV head, split)
  const long long part =
      (static_cast<long long>(b * a.Hkv + hk) * a.n_splits + split) * R;

  // positions first: a key is loaded iff some query row sees it
  int seen = 0;
  if (tid < kSplit) {
    const int c = c0 + tid;
    const int p = c >= a.T ? kAbsent
                           : (a.kv_pos == nullptr ? c : a.kv_pos[c]);
    for (int s = 0; s < a.Sq && !seen; ++s)
      seen = visible(p, a.q_offset + s, a);
    pos[tid] = p;
    load[tid] = seen;
  }
  if (!__syncthreads_or(seen)) {  // no row sees this split: empty partial
    if (tid < R) {
      a.part_ml[2 * (part + tid)] = neg_inf();
      a.part_ml[2 * (part + tid) + 1] = 0.f;
    }
    return;
  }

  // K, then V, rows of the split, 16 bytes a thread along D
  const int chunks = D / kE;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  for (int i = tid; i < kSplit * chunks; i += kThreads) {
    const int j = i / chunks, d = (i % chunks) * kE;
    T* dst = ks + j * L::kLdK + d;
    if (load[j])
      cp_async16(dst, kg + (c0 + j) * a.k_ss + d);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  for (int i = tid; i < kSplit * chunks; i += kThreads) {
    const int j = i / chunks, d = (i % chunks) * kE;
    T* dst = vs + j * DMAX + d;
    if (load[j])
      cp_async16(dst, vg + (c0 + j) * a.v_ss + d);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  // Q rows (r = s * g + h % g), widened to float32, while K and V land
  for (int i = tid; i < R * chunks; i += kThreads) {
    const int r = i / chunks, d = (i % chunks) * kE;
    const int s = r / g, h = hk * g + r % g;
    widen16(static_cast<const T*>(a.q) + b * a.q_sb + s * a.q_ss +
                h * a.q_sh + d,
            qs + r * DMAX + d);
  }
  cp_async_wait<1>();
  __syncthreads();

  // S = Q K^T: thread (key j, rows r0, r0 + 2, ...)
  {
    constexpr int kGroups = kThreads / kSplit;     // 2
    constexpr int kRowsPer = kMaxRows / kGroups;   // 8
    const int j = tid % kSplit, r0 = tid / kSplit;
    float acc[kRowsPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) acc[i] = 0.f;
    const T* krow = ks + j * L::kLdK;
    for (int d = 0; d < D; d += kE) {
      float kx[kE];
      widen16(krow + d, kx);
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const int r = r0 + kGroups * i;
        if (r < R) {
          const float* qr = qs + r * DMAX + d;
          float t = acc[i];
#pragma unroll
          for (int e = 0; e < kE; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            t = fmaf(qv.x, kx[e], t);
            t = fmaf(qv.y, kx[e + 1], t);
            t = fmaf(qv.z, kx[e + 2], t);
            t = fmaf(qv.w, kx[e + 3], t);
          }
          acc[i] = t;
        }
      }
    }
    const int p = pos[j];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int r = r0 + kGroups * i;
      if (r < R) {
        float s;
        if (p == kAbsent)
          s = neg_inf();
        else
          s = visible(p, a.q_offset + r / g, a) ? acc[i] * a.scale : kNegFill;
        ps[r * kSplit + j] = s;
      }
    }
  }
  __syncthreads();

  // the split's softmax per row: a warp a row, two keys a lane
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < R; r += kThreads / 32) {
      const float s0 = ps[r * kSplit + lane], s1 = ps[r * kSplit + lane + 32];
      float m = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float e0 = expf(s0 - m), e1 = expf(s1 - m);
      float l = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      ps[r * kSplit + lane] = e0;
      ps[r * kSplit + lane + 32] = e1;
      if (lane == 0) {
        a.part_ml[2 * (part + r)] = m;
        a.part_ml[2 * (part + r) + 1] = l;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // acc = P V: thread (column pair, rows rg, rg + kGroups, ...)
  {
    constexpr int kPairs = DMAX / 2;
    constexpr int kGroups = kThreads / kPairs;     // 4, 2, 1
    constexpr int kRowsPer = kMaxRows / kGroups;   // 4, 8, 16
    const int col = 2 * (tid % kPairs), rg = tid / kPairs;
    if (col < D) {
      float acc[kRowsPer][2];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) acc[i][0] = acc[i][1] = 0.f;
      for (int j = 0; j < kSplit; j += 4) {
        float2 vx[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vx[u] = load2(vs + (j + u) * DMAX + col);
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          const int r = rg + kGroups * i;
          if (r < R) {
            const float4 pw = *reinterpret_cast<const float4*>(
                ps + r * kSplit + j);
            float x0 = acc[i][0], x1 = acc[i][1];
            x0 = fmaf(pw.x, vx[0].x, x0);
            x1 = fmaf(pw.x, vx[0].y, x1);
            x0 = fmaf(pw.y, vx[1].x, x0);
            x1 = fmaf(pw.y, vx[1].y, x1);
            x0 = fmaf(pw.z, vx[2].x, x0);
            x1 = fmaf(pw.z, vx[2].y, x1);
            x0 = fmaf(pw.w, vx[3].x, x0);
            x1 = fmaf(pw.w, vx[3].y, x1);
            acc[i][0] = x0;
            acc[i][1] = x1;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const int r = rg + kGroups * i;
        if (r < R)
          *reinterpret_cast<float2*>(a.part_acc + (part + r) * D + col) =
              make_float2(acc[i][0], acc[i][1]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const Args a) {
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int R = a.Sq * a.g, D = a.D;
  // partial of split 0 for this row; splits are R rows apart
  const long long part0 =
      static_cast<long long>(b * a.Hkv + hk) * a.n_splits * R + r;
  float M = neg_inf();
  for (int sp = 0; sp < a.n_splits; ++sp)
    M = fmaxf(M, a.part_ml[2 * (part0 + static_cast<long long>(sp) * R)]);
  const int s = r / a.g, h = hk * a.g + r % a.g;
  const long long orow = (static_cast<long long>(b) * a.Sq + s) * a.H + h;
  float l = 0.f;
  if (M != neg_inf()) {
    for (int sp = 0; sp < a.n_splits; ++sp) {
      const long long pr = part0 + static_cast<long long>(sp) * R;
      const float m = a.part_ml[2 * pr];
      if (m == neg_inf()) continue;
      l = fmaf(expf(m - M), a.part_ml[2 * pr + 1], l);
    }
  }
  if (a.lse != nullptr && threadIdx.x == 0)
    a.lse[orow] = M == neg_inf() ? neg_inf() : M + logf(l);
  const float den = fmaxf(l, 1e-30f);
  for (int col = 2 * threadIdx.x; col < D; col += 2 * kThreads) {
    float x0 = 0.f, x1 = 0.f;
    if (M != neg_inf()) {
      for (int sp = 0; sp < a.n_splits; ++sp) {
        const long long pr = part0 + static_cast<long long>(sp) * R;
        const float m = a.part_ml[2 * pr];
        if (m == neg_inf()) continue;  // empty split: acc never written
        const float w = expf(m - M);
        const float2 acc =
            *reinterpret_cast<const float2*>(a.part_acc + pr * D + col);
        x0 = fmaf(w, acc.x, x0);
        x1 = fmaf(w, acc.y, x1);
      }
    }
    if (a.o_f32) {
      float* out = static_cast<float*>(a.o) + orow * D;
      store(out + col, x0 / den);
      store(out + col + 1, x1 / den);
    } else {
      T* out = static_cast<T*>(a.o) + orow * D;
      store(out + col, x0 / den);
      store(out + col + 1, x1 / den);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using L = Layout<T, DMAX>;
  auto kernel = decode_partial_kernel<T, DMAX>;
  static int configured_for = -1;  // once per instantiation and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (configured_for != dev) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
    if (err != cudaSuccess) return err;
    configured_for = dev;
  }
  kernel<<<dim3(a.n_splits, a.Hkv, B), kThreads, L::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T>
      <<<dim3(a.Sq * a.g, a.Hkv, B), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64>(a, B, stream);
  if (a.D <= 128) return launch<T, 128>(a, B, stream);
  return launch<T, 256>(a, B, stream);
}

}  // namespace

// q: (B, Sq, H, D), k, v: (B, T, Hkv, D), read through the element strides
// strides[0..8] = q's (b, s, h), k's (b, t, h), v's (b, t, h) (a host
// array; the last dimension has stride 1); o: contiguous (B, Sq, H, D) of
// q's type; kv_pos: (T,) int32 on the device or null; part_ml (B, Hkv,
// n_splits, Sq*g, 2) and part_acc (B, Hkv, n_splits, Sq*g, D) float32
// scratch. q, k, v, o are float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// D % 16 == 0, D <= 256, Sq * (H / Hkv) <= 16, split_len == 64 and
// n_splits == ceil(T / 64); strides and base addresses multiples of 16
// bytes. lse: (B, Sq, H) float32 or null, each row's log-sum-exp; o_f32:
// o is float32 whatever q's type. Launches both passes on `stream` without
// synchronising; returns the first nonzero cudaError_t (0 = launched).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, void* o,
                                   const int32_t* kv_pos,
                                   const long long* strides, int B, int Sq,
                                   int T, int H, int Hkv, int D, int causal,
                                   int window, int q_offset, float scale,
                                   int bf16, int split_len, int n_splits,
                                   float* part_ml, float* part_acc,
                                   float* lse, int o_f32,
                                   int device, void* stream) {
  if (D <= 0 || D % 16 != 0 || D > 256 || Hkv <= 0 || H % Hkv != 0 ||
      B <= 0 || Sq <= 0 || T <= 0 || Sq * (H / Hkv) > kMaxRows ||
      split_len != kSplit || n_splits != (T + kSplit - 1) / kSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.kv_pos = kv_pos;
  a.part_ml = part_ml;
  a.part_acc = part_acc;
  a.lse = lse;
  a.o_f32 = o_f32;
  a.q_sb = strides[0];
  a.q_ss = strides[1];
  a.q_sh = strides[2];
  a.k_sb = strides[3];
  a.k_ss = strides[4];
  a.k_sh = strides[5];
  a.v_sb = strides[6];
  a.v_ss = strides[7];
  a.v_sh = strides[8];
  a.Sq = Sq;
  a.T = T;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.g = H / Hkv;
  a.n_splits = n_splits;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? dispatch<__nv_bfloat16>(a, B, st) : dispatch<float>(a, B, st);
  return static_cast<int>(err);
}

// The merge of n slices' decode attention (pass 2 alone): part_ml
// (B, Hkv, n, Sq*g, 2) holds each slice's (lse, 1) and part_acc
// (B, Hkv, n, Sq*g, D) its float32 output, in the layout pass 1 writes;
// o: contiguous (B, Sq, H, D), float32 (bf16 = 0) or bfloat16 (bf16 = 1).
// D % 2 == 0, Sq * (H / Hkv) <= 16. Returns the launch's cudaError_t.
extern "C" int flash_decode_merge_launch(float* part_ml, float* part_acc,
                                         void* o, int B, int Sq, int H,
                                         int Hkv, int D, int n, int bf16,
                                         int device, void* stream) {
  if (D <= 0 || D % 2 != 0 || Hkv <= 0 || H % Hkv != 0 || B <= 0 ||
      Sq <= 0 || n <= 0 || Sq * (H / Hkv) > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a = {};
  a.o = o;
  a.part_ml = part_ml;
  a.part_acc = part_acc;
  a.Sq = Sq;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.g = H / Hkv;
  a.n_splits = n;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(Sq * a.g, Hkv, B);
  if (bf16)
    decode_combine_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    decode_combine_kernel<float><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
