// Online-softmax attention over grouped heads on the CUDA cores: the
// attention layers the tensor-core and split-KV kernels do not take, that
// is float32 prefill (the float32 model's) and bf16 prefill at head dims
// other than 64, 128 and 256. Prefill here means Sq * g > 16 query rows;
// decode (<= 16 rows) goes to flash_decode.cu in either type, and bf16
// prefill at D 64/128/256 to flash_prefill_sm90.cu (kernels/
// flash_attention.py's launch_plan chooses).
//
// Replaces: src/repro/kernels/flash_attention.py:77, flash_attention (body
// _flash_kernel), and computes the function of the region the JAX model
// runs in its place, src/repro/models/layers.py:134, gqa_scores_chunked.
//
// The contract every route keeps. For q (B, Sq, H, D) and k, v (B, T, Hkv,
// D), query head h reads KV head h / g (g = H / Hkv). With p_c the
// position of key c (kv_pos[c], or c when kv_pos is null) and q_pos =
// q_offset + s, key c is seen by query s iff  p_c >= 0,  (causal) q_pos >=
// p_c  and  (window > 0) p_c > q_pos - window.  Per (b, s, h):
//   s_c = scale * q.k_c (float32), or -1e30 where key c is not seen;
//   o = sum_c exp(s_c - m) v_c / max(sum_c exp(s_c - m), 1e-30)
// with m the running maximum of the online softmax, as _flash_kernel
// computes it (the same finite fill, the same clamp), written in q's type.
// Rows with no visible key are outside the contract (the reference gives
// them a uniform average, this kernel whatever its visited tiles give).
//
// What bounds it on an H100: at a prefill shape (B 4, S = T 2048, H 16,
// Hkv 8, D 128, causal) a launch is 4*B*H*D*(S(S+1)/2) = 68.8 GFLOP of
// float32 CUDA-core work against 134 MB of float32 Q, K, V and O:
// operations bound it (67 TFLOP/s: ~1.03 ms; memory ~40 us).
//
// Design: one 256-thread block per (64-row tile, KV head, batch). A row
// tile packs the g query heads that share a KV head (row r = s*g + h%g),
// so a K/V tile is read once per KV head, not once per query head. The
// block stages its Q tile once, then walks 64-key tiles of K and V in a
// loop inside the block (the TPU grid's sequential kv axis): S = Q K^T in
// registers (4 x 4 a thread, columns strided by 16 so the float4 reads of
// K are free of bank conflicts), the online softmax per row with the 16
// lanes of a half-warp reducing each row, P through shared memory, then
// O += P V (4 rows x D/16 columns a thread). Inputs are read in place
// through their strides (the model's (B, S, H, D) layout and the cache's
// (B, steps, Hkv, D) layout, no transpose or copy), bf16 or float32, and
// widened to float32 as they land in shared memory; all arithmetic is
// float32 FMAs on the CUDA cores (no tensor cores, so no TF32 question).
// When key positions are the indices (kv_pos null), key tiles wholly above
// the causal diagonal or wholly before the window are skipped, as
// flash_attention.py:66 does. Ragged rows and keys are masked in-kernel:
// keys past T take -inf (exp gives exactly 0), so no caller pads.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;           // query rows per block
constexpr int kBKV = 64;          // keys per tile
constexpr int kPad = 4;           // keeps float4 rows aligned, banks apart
constexpr int kLdP = kBKV + kPad;
constexpr float kNegFill = -1e30f;
constexpr int kAbsent = INT_MIN;  // key index past T

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;                  // contiguous (B, Sq, H, D), q's type
  const int32_t* kv_pos;    // (T,) or null: positions are the indices
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, Sq, T, H, Hkv, D, g;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four bf16 -> float32, exactly (a bf16 is the top half of a float32)
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <int DMAX>
struct Layout {
  static constexpr int kLd = DMAX + kPad;
  static constexpr int kQ = 0;                        // [kBQ][kLd]
  static constexpr int kK = kQ + kBQ * kLd;            // [kBKV][kLd]
  static constexpr int kV = kK + kBKV * kLd;          // [kBKV][DMAX]
  static constexpr int kP = kV + kBKV * DMAX;         // [kBQ][kLdP]
  static constexpr int kPos = kP + kBQ * kLdP;         // [kBKV] int
  static constexpr size_t kBytes = sizeof(float) * (kPos + kBKV);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Args a) {
  using L = Layout<DMAX>;
  constexpr int RI = kBQ / 16;     // rows a thread owns
  constexpr int CO = DMAX / 16;   // output columns a thread owns
  constexpr int D4 = DMAX / 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::kQ;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* ps = smem + L::kP;
  int* kp = reinterpret_cast<int*>(smem + L::kPos);

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kBQ, hk = blockIdx.y, b = blockIdx.z;
  const int g = a.g, R = a.Sq * g, D = a.D;

  // Q tile, widened to float32; rows past R and columns past D are 0
  for (int i = tid; i < kBQ * D4; i += kThreads) {
    const int r = i / D4, d = (i % D4) * 4, row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < R && d < D) {
      const int s = row / g, h = hk * g + row % g;
      x = load4(q + b * a.q_sb + s * a.q_ss + h * a.q_sh + d);
    }
    *reinterpret_cast<float4*>(qs + r * L::kLd + d) = x;
  }

  // key tiles to visit: all of them, less (kv_pos null) those wholly above
  // the causal diagonal or wholly before the window of every row here
  int t_lo = 0, t_hi = a.T;
  if (a.kv_pos == nullptr) {
    const int s_lo = row0 / g, s_hi = (min(row0 + kBQ, R) - 1) / g;
    if (a.causal) t_hi = min(a.T, a.q_offset + s_hi + 1);
    if (a.window > 0) t_lo = max(0, a.q_offset + s_lo - a.window + 1);
    t_lo = (t_lo / kBKV) * kBKV;
  }

  float m[RI], l[RI], acc[RI][CO];
  int qpos[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegFill;
    l[i] = 0.f;
    qpos[i] = a.q_offset + (row0 + ty + 16 * i) / g;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  for (int col0 = t_lo; col0 < t_hi; col0 += kBKV) {
    __syncthreads();  // the previous tile's K, V, P are consumed
    for (int i = tid; i < kBKV * D4; i += kThreads) {
      const int j = i / D4, d = (i % D4) * 4, col = col0 + j;
      float4 xk = make_float4(0.f, 0.f, 0.f, 0.f), xv = xk;
      if (col < a.T && d < D) {
        xk = load4(k + b * a.k_sb + col * a.k_ss + hk * a.k_sh + d);
        xv = load4(v + b * a.v_sb + col * a.v_ss + hk * a.v_sh + d);
      }
      *reinterpret_cast<float4*>(ks + j * L::kLd + d) = xk;
      *reinterpret_cast<float4*>(vs + j * DMAX + d) = xv;
    }
    if (tid < kBKV) {
      const int col = col0 + tid;
      kp[tid] = col >= a.T ? kAbsent
                           : (a.kv_pos == nullptr ? col : a.kv_pos[col]);
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, keys tx + 16 j
    float sc[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[RI], kb[4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qa[i] = *reinterpret_cast<const float4*>(
            qs + (ty + 16 * i) * L::kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(
            ks + (tx + 16 * j) * L::kLd + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = sc[i][j];
          s = fmaf(qa[i].x, kb[j].x, s);
          s = fmaf(qa[i].y, kb[j].y, s);
          s = fmaf(qa[i].z, kb[j].z, s);
          s = fmaf(qa[i].w, kb[j].w, s);
          sc[i][j] = s;
        }
    }

    // mask, online softmax; a row's 16 key lanes are one half-warp
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = kp[tx + 16 * j];
        float s;
        if (p == kAbsent) {
          s = neg_inf();
        } else {
          const bool seen = p >= 0 && (!a.causal || qpos[i] >= p) &&
                            (a.window <= 0 || p > qpos[i] - a.window);
          s = seen ? sc[i][j] * a.scale : kNegFill;
        }
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // O += P V for rows ty + 16 i, columns tx + 16 c
#pragma unroll 2
    for (int j = 0; j < kBKV; j += 4) {
      float4 pp[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pp[i] = *reinterpret_cast<const float4*>(
            ps + (ty + 16 * i) * kLdP + j);
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float* vc = vs + j * DMAX + tx + 16 * c;
        const float v0 = vc[0], v1 = vc[DMAX], v2 = vc[2 * DMAX],
                    v3 = vc[3 * DMAX];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          float o = acc[i][c];
          o = fmaf(pp[i].x, v0, o);
          o = fmaf(pp[i].y, v1, o);
          o = fmaf(pp[i].z, v2, o);
          o = fmaf(pp[i].w, v3, o);
          acc[i][c] = o;
        }
      }
    }
  }

  T* __restrict__ out = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= R) continue;
    const int s = row / g, h = hk * g + row % g;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = out + ((static_cast<long long>(b) * a.Sq + s) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store(orow + col, acc[i][c] / den);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<DMAX>;
  auto kernel = flash_attention_kernel<T, DMAX>;
  // above 48 KB a block's shared memory must be asked for; asking once
  // per instantiation and device is enough
  static int configured_for = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (configured_for != dev) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return err;
    configured_for = dev;
  }
  const dim3 grid((a.Sq * a.g + kBQ - 1) / kBQ, a.Hkv, a.B);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64>(a, stream);
  if (a.D <= 128) return launch<T, 128>(a, stream);
  return launch<T, 256>(a, stream);
}

}  // namespace

// q: (B, Sq, H, D), k, v: (B, T, Hkv, D), read through the element strides
// strides[0..8] = q's (b, s, h), k's (b, t, h), v's (b, t, h) (a host
// array; the last dimension has stride 1); o: contiguous (B, Sq, H, D) of
// q's type; kv_pos: (T,) int32 on the device or null. All of q, k, v, o
// are float32 (bf16 = 0) or bfloat16 (bf16 = 1). D % 16 == 0, D <= 256,
// H % Hkv == 0, strides and base addresses multiples of 4 elements.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 = launched).
extern "C" int flash_simt_launch(const void* q, const void* k, const void* v,
                                 void* o, const int32_t* kv_pos,
                                 const long long* strides, int B, int Sq,
                                 int T, int H, int Hkv, int D, int causal,
                                 int window, int q_offset, float scale,
                                 int bf16, int device, void* stream) {
  if (D <= 0 || D % 16 != 0 || D > 256 || Hkv <= 0 || H % Hkv != 0 ||
      B <= 0 || Sq <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.kv_pos = kv_pos;
  a.q_sb = strides[0];
  a.q_ss = strides[1];
  a.q_sh = strides[2];
  a.k_sb = strides[3];
  a.k_ss = strides[4];
  a.k_sh = strides[5];
  a.v_sb = strides[6];
  a.v_ss = strides[7];
  a.v_sh = strides[8];
  a.B = B;
  a.Sq = Sq;
  a.T = T;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.g = H / Hkv;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? dispatch<__nv_bfloat16>(a, st) : dispatch<float>(a, st);
  return static_cast<int>(err);
}
