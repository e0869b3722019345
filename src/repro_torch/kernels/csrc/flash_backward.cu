// The gradient of grouped-head attention on the CUDA cores: dQ, dK and dV
// of the function the forward kernels compute (flash_attention.cu,
// flash_prefill_sm90.cu, flash_decode.cu), given the forward's output O and
// the output's gradient dO. The training path's every attention backward
// (kernels/ops.py, the autograd Function around gqa_attention) runs here.
//
// Replaces: nothing on the TPU. The JAX package differentiates its plain
// attention region, src/repro/models/layers.py:134, gqa_scores_chunked,
// with autograd (its Pallas kernel, src/repro/kernels/flash_attention.py:77,
// has no backward). This kernel computes the gradient that autograd gives
// there, for the same mask and the same -1e30 fill:
//   s_c = scale * q.k_c, or -1e30 where key c is not seen (the forward's
//   contract: p_c >= 0, (causal) q_pos >= p_c, (window > 0) p_c > q_pos -
//   window); P = softmax(s) over the keys; delta = sum_d dO.O;
//   dS_c = P_c (dO.v_c - delta) where key c is seen, 0 where it is masked
//   (the fill passes no gradient); dQ = scale sum_c dS_c k_c,
//   dK_c = scale sum_q dS_c q, dV_c = sum_q P_c dO.
// A row with no visible key has a uniform P over the T keys (every score
// is the fill), as in the reference: its dV share is dO / T and its dS 0.
//
// What bounds it on an H100: at qwen3-0.6b's training shape (B 4, S = T
// 2048, H 16, Hkv 8, D 128, causal) the work is five products of
// 2*B*H*D*S(S+1)/2 (S, dP, dV, dK, dQ): 172 GFLOP, which at the bf16
// tensor-core rate is ~0.17 ms against 134 MB of bf16 operands (~0.04 ms):
// operations bound it. This kernel runs them in float32 on the CUDA cores
// (67 TFLOP/s) and recomputes S three times and dP twice (8 products), so
// it sits far above that bound; tensor cores are a later redesign.
//
// Design: three launches, no atomics, so every gradient is written once and
// the GQA sum over a KV head's g query heads is taken in a fixed order
// (two identical calls give the same bits).
//   1. prep: one block per (64-row tile, KV head, batch), rows packed as in
//      the forward (row r = s*g + h%g). It recomputes each row's softmax
//      max m and sum l over the keys it visits (Q K^T, the forward's online
//      softmax without P V) and delta = dO.O, all in float32, into scratch.
//      m and l stay apart (not one log-sum-exp): a row whose scores are all
//      the -1e30 fill has m = -1e30 and l = T, and m + log l would round
//      back to m in float32.
//   2. dkdv: one block per (key tile, KV head, batch). K and V stay in
//      shared memory; the block walks every row tile of the packed rows
//      (all g query heads), skips the tiles no row of which can see a key
//      of the tile, recomputes S^T and dP^T, forms P^T and dS^T in shared
//      memory and accumulates dV += P^T dO and dK += dS^T Q in registers.
//   3. dq: one block per row tile; it walks the key tiles its rows see and
//      accumulates dQ += dS K.
// Which key tiles a row visits: all of them when key positions are given
// (kv_pos), else [max(0, q_pos - window + 1), min(T, q_pos + 1)) (causal /
// window), or all of them where that range is empty (no visible key: the
// uniform row). Masked keys inside a visited tile take the fill, so their P
// is exp(-1e30 - m) = 0 for a row that sees a key; skipping a tile changes
// nothing. Inputs are read through their strides (q, k, v) or contiguous
// (O, dO), bf16 or float32, widened to float32 in shared memory; every
// product and sum is a float32 FMA; outputs are written once in the input
// type (bf16 rounded to nearest even). Tiles are 64 x 64 up to D 128 and
// 32 x 32 at D 256, so a block's shared memory stays under 227 KB.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 4;            // keeps float4 rows aligned, banks apart
constexpr float kNegFill = -1e30f;
constexpr int kAbsent = INT_MIN;   // key index past T, or row index past R

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;           // contiguous (B, Sq, H, D), q's type
  const void* dout;        // contiguous (B, Sq, H, D), q's type
  void* dq;                // contiguous (B, Sq, H, D), q's type
  void* dk;                // contiguous (B, T, Hkv, D)
  void* dv;                // contiguous (B, T, Hkv, D)
  float* stats;            // (B, Hkv, Sq*g, 2): m, l
  float* delta;            // (B, Hkv, Sq*g)
  const int32_t* kv_pos;   // (T,) or null: positions are the indices
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, Sq, T, H, Hkv, D, g;
  int causal, window, q_offset;
  float scale;
};

template <int DMAX>
struct Tiles {
  static constexpr int kBQ = DMAX > 128 ? 32 : 64;   // query rows
  static constexpr int kBK = DMAX > 128 ? 32 : 64;   // keys
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ bool seen(const Args& a, int p, int qpos) {
  return p >= 0 && (!a.causal || qpos >= p) &&
         (a.window <= 0 || p > qpos - a.window);
}

// the key indices [lo, hi) a row at query position qpos visits
__device__ __forceinline__ void row_range(const Args& a, int qpos, int& lo,
                                          int& hi) {
  lo = 0;
  hi = a.T;
  if (a.kv_pos != nullptr) return;
  int l = 0, h = a.T;
  if (a.causal) h = min(h, qpos + 1);
  if (a.window > 0) l = max(l, qpos - a.window + 1);
  if (l < h) {  // else no visible key: every key, the uniform row
    lo = l;
    hi = h;
  }
}

__device__ __forceinline__ int key_pos(const Args& a, int col) {
  return col >= a.T ? kAbsent : (a.kv_pos == nullptr ? col : a.kv_pos[col]);
}

// packed row -> element offset of (b, s, h, 0) in a contiguous
// (B, Sq, H, D) tensor
__device__ __forceinline__ long long dense_row(const Args& a, int b, int hk,
                                               int row) {
  const int s = row / a.g, h = hk * a.g + row % a.g;
  return ((static_cast<long long>(b) * a.Sq + s) * a.H + h) * a.D;
}

template <typename T>
__device__ __forceinline__ const T* q_row(const Args& a, int b, int hk,
                                          int row) {
  const int s = row / a.g, h = hk * a.g + row % a.g;
  return static_cast<const T*>(a.q) + b * a.q_sb + s * a.q_ss + h * a.q_sh;
}

// rows [row0, row0 + BQ) of Q (through its strides) and of the contiguous
// tensor `dense` (O or dO) into shared tiles of leading dimension LD,
// widened to float32; rows past R and columns past D are 0
template <typename T, int BQ, int DMAX>
__device__ __forceinline__ void load_rows(const Args& a, int b, int hk,
                                          int row0, const T* dense,
                                          float* qs, float* ds) {
  constexpr int LD = DMAX + kPad, D4 = DMAX / 4;
  const int R = a.Sq * a.g;
  for (int i = threadIdx.x; i < BQ * D4; i += kThreads) {
    const int r = i / D4, d = (i % D4) * 4, row = row0 + r;
    float4 xq = make_float4(0.f, 0.f, 0.f, 0.f), xd = xq;
    if (row < R && d < a.D) {
      xq = load4(q_row<T>(a, b, hk, row) + d);
      if (ds != nullptr) xd = load4(dense + dense_row(a, b, hk, row) + d);
    }
    *reinterpret_cast<float4*>(qs + r * LD + d) = xq;
    if (ds != nullptr) *reinterpret_cast<float4*>(ds + r * LD + d) = xd;
  }
}

// keys [col0, col0 + BK) of K and (if vs) V into shared tiles, and their
// positions into kp
template <typename T, int BK, int DMAX>
__device__ __forceinline__ void load_keys(const Args& a, int b, int hk,
                                          int col0, float* ks, float* vs,
                                          int* kp) {
  constexpr int LD = DMAX + kPad, D4 = DMAX / 4;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  for (int i = threadIdx.x; i < BK * D4; i += kThreads) {
    const int j = i / D4, d = (i % D4) * 4, col = col0 + j;
    float4 xk = make_float4(0.f, 0.f, 0.f, 0.f), xv = xk;
    if (col < a.T && d < a.D) {
      xk = load4(k + b * a.k_sb + col * a.k_ss + hk * a.k_sh + d);
      if (vs != nullptr)
        xv = load4(v + b * a.v_sb + col * a.v_ss + hk * a.v_sh + d);
    }
    *reinterpret_cast<float4*>(ks + j * LD + d) = xk;
    if (vs != nullptr) *reinterpret_cast<float4*>(vs + j * LD + d) = xv;
  }
  if (threadIdx.x < BK) kp[threadIdx.x] = key_pos(a, col0 + threadIdx.x);
}

// out[i][j] = sum_d A[ra + 16 i][d] B[rb + 16 j][d] over shared tiles of
// leading dimension LD (rows strided by 16: the float4 reads of a
// half-warp's 16 rows fall in distinct banks)
template <int NI, int NJ, int LD>
__device__ __forceinline__ void tile_dot(const float* A, int ra,
                                         const float* B, int rb, int D,
                                         float (&out)[NI][NJ]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[NI], y[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      x[i] = *reinterpret_cast<const float4*>(A + (ra + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      y[j] = *reinterpret_cast<const float4*>(B + (rb + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) out[i][j] = dot4(x[i], y[j], out[i][j]);
  }
}

// [lo, hi) over the valid rows [row0, row0 + BQ) of this block: the hull
// of the key ranges they visit
template <int BQ>
__device__ __forceinline__ void tile_range(const Args& a, int row0, int* lo,
                                           int* hi) {
  if (threadIdx.x == 0) {
    *lo = INT_MAX;
    *hi = INT_MIN;
  }
  __syncthreads();
  const int row = row0 + static_cast<int>(threadIdx.x);
  if (threadIdx.x < BQ && row < a.Sq * a.g) {
    int l, h;
    row_range(a, a.q_offset + row / a.g, l, h);
    atomicMin(lo, l);
    atomicMax(hi, h);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// 1. prep: per row, the softmax max m and sum l over its visited keys, and
//    delta = dO.O
// ---------------------------------------------------------------------------
template <int DMAX>
struct PrepLayout {
  static constexpr int kBQ = Tiles<DMAX>::kBQ, kBK = Tiles<DMAX>::kBK;
  static constexpr int kLd = DMAX + kPad;
  static constexpr int kQ = 0;                        // [kBQ][kLd]
  static constexpr int kK = kQ + kBQ * kLd;            // [kBK][kLd]
  static constexpr int kPos = kK + kBK * kLd;          // [kBK] int
  static constexpr size_t kBytes = sizeof(float) * (kPos + kBK);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) bwd_prep_kernel(const Args a) {
  using L = PrepLayout<DMAX>;
  constexpr int BQ = L::kBQ, BK = L::kBK, RI = BQ / 16, JK = BK / 16;
  extern __shared__ __align__(16) float smem[];
  __shared__ int range_lo, range_hi;
  float* qs = smem + L::kQ;
  float* ks = smem + L::kK;
  int* kp = reinterpret_cast<int*>(smem + L::kPos);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BQ, hk = blockIdx.y, b = blockIdx.z;
  const int R = a.Sq * a.g;

  load_rows<T, BQ, DMAX>(a, b, hk, row0, nullptr, qs, nullptr);
  tile_range<BQ>(a, row0, &range_lo, &range_hi);
  const int t_lo = (range_lo / BK) * BK, t_hi = range_hi;

  float m[RI], l[RI];
  int qpos[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegFill;
    l[i] = 0.f;
    qpos[i] = a.q_offset + (row0 + ty + 16 * i) / a.g;
  }
  for (int col0 = t_lo; col0 < t_hi; col0 += BK) {
    __syncthreads();  // the previous tile's K is consumed
    load_keys<T, BK, DMAX>(a, b, hk, col0, ks, nullptr, kp);
    __syncthreads();
    float sc[RI][JK];
    tile_dot<RI, JK, L::kLd>(qs, ty, ks, tx, a.D, sc);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const int p = kp[tx + 16 * j];
        const float s = p == kAbsent ? neg_inf()
                        : seen(a, p, qpos[i]) ? sc[i][j] * a.scale
                                              : kNegFill;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < JK; ++j) sum += expf(sc[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }

  // delta: the 16 lanes of a row's half-warp split D, then reduce
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  float* stats = a.stats + (static_cast<long long>(b) * a.Hkv + hk) * R * 2;
  float* delta = a.delta + (static_cast<long long>(b) * a.Hkv + hk) * R;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + ty + 16 * i;
    float part = 0.f;
    if (row < R) {
      const long long base = dense_row(a, b, hk, row);
      for (int d = tx * 4; d < a.D; d += 64)
        part = dot4(load4(dout + base + d), load4(o + base + d), part);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (row < R && tx == 0) {
      stats[2 * row] = m[i];
      stats[2 * row + 1] = l[i];
      delta[row] = part;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dkdv: per key tile, dV = sum P^T dO and dK = scale sum dS^T Q over
//    every row tile (all g query heads of the KV head)
// ---------------------------------------------------------------------------
template <int DMAX>
struct DkdvLayout {
  static constexpr int kBQ = Tiles<DMAX>::kBQ, kBK = Tiles<DMAX>::kBK;
  static constexpr int kLd = DMAX + kPad;
  static constexpr int kLdP = kBQ + kPad;
  static constexpr int kK = 0;                         // [kBK][kLd]
  static constexpr int kV = kK + kBK * kLd;             // [kBK][kLd]
  static constexpr int kQ = kV + kBK * kLd;             // [kBQ][kLd]
  static constexpr int kO = kQ + kBQ * kLd;             // [kBQ][kLd] dO
  static constexpr int kP = kO + kBQ * kLd;             // [kBK][kLdP] P^T
  static constexpr int kS = kP + kBK * kLdP;            // [kBK][kLdP] dS^T
  static constexpr int kM = kS + kBK * kLdP;            // [kBQ] m
  static constexpr int kL = kM + kBQ;                   // [kBQ] l
  static constexpr int kDelta = kL + kBQ;               // [kBQ] delta
  static constexpr int kQpos = kDelta + kBQ;            // [kBQ] int
  static constexpr int kPos = kQpos + kBQ;              // [kBK] int
  static constexpr size_t kBytes = sizeof(float) * (kPos + kBK);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(const Args a) {
  using L = DkdvLayout<DMAX>;
  constexpr int BQ = L::kBQ, BK = L::kBK, LD = L::kLd, LDP = L::kLdP;
  constexpr int KI = BK / 16, QJ = BQ / 16, CO = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* qs = smem + L::kQ;
  float* os = smem + L::kO;
  float* ps = smem + L::kP;
  float* dss = smem + L::kS;
  float* rm = smem + L::kM;
  float* rl = smem + L::kL;
  float* rd = smem + L::kDelta;
  int* rq = reinterpret_cast<int*>(smem + L::kQpos);
  int* kp = reinterpret_cast<int*>(smem + L::kPos);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int c1 = min(c0 + BK, a.T), R = a.Sq * a.g;
  const float* stats =
      a.stats + (static_cast<long long>(b) * a.Hkv + hk) * R * 2;
  const float* delta = a.delta + (static_cast<long long>(b) * a.Hkv + hk) * R;

  load_keys<T, BK, DMAX>(a, b, hk, c0, ks, vs, kp);

  float dk[KI][CO], dv[KI][CO];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int r0 = 0; r0 < R; r0 += BQ) {
    // skip the row tile when none of its rows visits a key of this tile
    int visits = 0;
    if (tid < BQ && r0 + tid < R) {
      int lo, hi;
      row_range(a, a.q_offset + (r0 + tid) / a.g, lo, hi);
      visits = lo < c1 && hi > c0;
    }
    // (also: the previous tile's Q, dO, P^T, dS^T are consumed)
    if (!__syncthreads_or(visits)) continue;
    load_rows<T, BQ, DMAX>(a, b, hk, r0, static_cast<const T*>(a.dout), qs,
                           os);
    if (tid < BQ) {
      const int row = r0 + tid;
      const bool ok = row < R;
      rm[tid] = ok ? stats[2 * row] : 0.f;
      rl[tid] = ok ? stats[2 * row + 1] : 1.f;
      rd[tid] = ok ? delta[row] : 0.f;
      rq[tid] = ok ? a.q_offset + row / a.g : kAbsent;
    }
    __syncthreads();

    float sc[KI][QJ], dp[KI][QJ];
    tile_dot<KI, QJ, LD>(ks, ty, qs, tx, a.D, sc);   // S^T
    tile_dot<KI, QJ, LD>(vs, ty, os, tx, a.D, dp);   // dP^T
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const int key = ty + 16 * i, r = tx + 16 * j;
        const int p = kp[key], qpos = rq[r];
        float pr = 0.f, ds = 0.f;
        if (p != kAbsent && qpos != kAbsent) {
          const bool sn = seen(a, p, qpos);
          const float s = sn ? sc[i][j] * a.scale : kNegFill;
          pr = expf(s - rm[r]) / rl[r];
          if (sn) ds = pr * (dp[i][j] - rd[r]);
        }
        ps[key * LDP + r] = pr;
        dss[key * LDP + r] = ds;
      }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BQ; j += 4) {
      float4 pp[KI], dd[KI];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        pp[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * LDP + j);
        dd[i] =
            *reinterpret_cast<const float4*>(dss + (ty + 16 * i) * LDP + j);
      }
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float* oc = os + j * LD + tx + 16 * c;
        const float* qc = qs + j * LD + tx + 16 * c;
        const float o0 = oc[0], o1 = oc[LD], o2 = oc[2 * LD], o3 = oc[3 * LD];
        const float q0 = qc[0], q1 = qc[LD], q2 = qc[2 * LD], q3 = qc[3 * LD];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          float x = dv[i][c];
          x = fmaf(pp[i].x, o0, x);
          x = fmaf(pp[i].y, o1, x);
          x = fmaf(pp[i].z, o2, x);
          x = fmaf(pp[i].w, o3, x);
          dv[i][c] = x;
          float y = dk[i][c];
          y = fmaf(dd[i].x, q0, y);
          y = fmaf(dd[i].y, q1, y);
          y = fmaf(dd[i].z, q2, y);
          y = fmaf(dd[i].w, q3, y);
          dk[i][c] = y;
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int key = c0 + ty + 16 * i;
    if (key >= a.T) continue;
    const long long base =
        ((static_cast<long long>(b) * a.T + key) * a.Hkv + hk) * a.D;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      const int col = tx + 16 * c;
      if (col < a.D) {
        store(dk_out + base + col, dk[i][c] * a.scale);
        store(dv_out + base + col, dv[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq: per row tile, dQ = scale sum dS K over the key tiles it visits
// ---------------------------------------------------------------------------
template <int DMAX>
struct DqLayout {
  static constexpr int kBQ = Tiles<DMAX>::kBQ, kBK = Tiles<DMAX>::kBK;
  static constexpr int kLd = DMAX + kPad;
  static constexpr int kLdS = kBK + kPad;
  static constexpr int kQ = 0;                          // [kBQ][kLd]
  static constexpr int kO = kQ + kBQ * kLd;              // [kBQ][kLd] dO
  static constexpr int kK = kO + kBQ * kLd;              // [kBK][kLd]
  static constexpr int kV = kK + kBK * kLd;              // [kBK][kLd]
  static constexpr int kS = kV + kBK * kLd;              // [kBQ][kLdS] dS
  static constexpr int kPos = kS + kBQ * kLdS;           // [kBK] int
  static constexpr size_t kBytes = sizeof(float) * (kPos + kBK);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(const Args a) {
  using L = DqLayout<DMAX>;
  constexpr int BQ = L::kBQ, BK = L::kBK, LD = L::kLd, LDS = L::kLdS;
  constexpr int RI = BQ / 16, JK = BK / 16, CO = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  __shared__ int range_lo, range_hi;
  float* qs = smem + L::kQ;
  float* os = smem + L::kO;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* dss = smem + L::kS;
  int* kp = reinterpret_cast<int*>(smem + L::kPos);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BQ, hk = blockIdx.y, b = blockIdx.z;
  const int R = a.Sq * a.g;
  const float* stats =
      a.stats + (static_cast<long long>(b) * a.Hkv + hk) * R * 2;
  const float* delta = a.delta + (static_cast<long long>(b) * a.Hkv + hk) * R;

  load_rows<T, BQ, DMAX>(a, b, hk, row0, static_cast<const T*>(a.dout), qs,
                         os);
  tile_range<BQ>(a, row0, &range_lo, &range_hi);
  const int t_lo = (range_lo / BK) * BK, t_hi = range_hi;

  float m[RI], l[RI], dl[RI], acc[RI][CO];
  int qpos[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + ty + 16 * i;
    const bool ok = row < R;
    m[i] = ok ? stats[2 * row] : 0.f;
    l[i] = ok ? stats[2 * row + 1] : 1.f;
    dl[i] = ok ? delta[row] : 0.f;
    qpos[i] = ok ? a.q_offset + row / a.g : kAbsent;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  for (int col0 = t_lo; col0 < t_hi; col0 += BK) {
    __syncthreads();  // the previous tile's K, V, dS are consumed
    load_keys<T, BK, DMAX>(a, b, hk, col0, ks, vs, kp);
    __syncthreads();
    float sc[RI][JK], dp[RI][JK];
    tile_dot<RI, JK, LD>(qs, ty, ks, tx, a.D, sc);   // S
    tile_dot<RI, JK, LD>(os, ty, vs, tx, a.D, dp);   // dP
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const int p = kp[tx + 16 * j];
        float ds = 0.f;
        if (p != kAbsent && qpos[i] != kAbsent && seen(a, p, qpos[i])) {
          const float pr = expf(sc[i][j] * a.scale - m[i]) / l[i];
          ds = pr * (dp[i][j] - dl[i]);
        }
        dss[(ty + 16 * i) * LDS + tx + 16 * j] = ds;
      }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 dd[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        dd[i] =
            *reinterpret_cast<const float4*>(dss + (ty + 16 * i) * LDS + j);
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float* kc = ks + j * LD + tx + 16 * c;
        const float k0 = kc[0], k1 = kc[LD], k2 = kc[2 * LD], k3 = kc[3 * LD];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          float x = acc[i][c];
          x = fmaf(dd[i].x, k0, x);
          x = fmaf(dd[i].y, k1, x);
          x = fmaf(dd[i].z, k2, x);
          x = fmaf(dd[i].w, k3, x);
          acc[i][c] = x;
        }
      }
    }
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= R) continue;
    const long long base = dense_row(a, b, hk, row);
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      const int col = tx + 16 * c;
      if (col < a.D) store(dq + base + col, acc[i][c] * a.scale);
    }
  }
}

// above 48 KB a block's shared memory must be asked for; asking once per
// kernel and device is enough
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int dev, int& configured) {
  if (configured == dev) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) configured = dev;
  return err;
}

template <typename T, int DMAX>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using P = PrepLayout<DMAX>;
  using K = DkdvLayout<DMAX>;
  using Q = DqLayout<DMAX>;
  static int prep_for = -1, dkdv_for = -1, dq_for = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_prep_kernel<T, DMAX>, P::kBytes, dev, prep_for);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_dkdv_kernel<T, DMAX>, K::kBytes, dev, dkdv_for);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_dq_kernel<T, DMAX>, Q::kBytes, dev, dq_for);
  if (err != cudaSuccess) return err;
  const int R = a.Sq * a.g;
  const dim3 rows((R + P::kBQ - 1) / P::kBQ, a.Hkv, a.B);
  const dim3 keys((a.T + K::kBK - 1) / K::kBK, a.Hkv, a.B);
  bwd_prep_kernel<T, DMAX><<<rows, kThreads, P::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<T, DMAX><<<keys, kThreads, K::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, DMAX><<<rows, kThreads, Q::kBytes, stream>>>(a);
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
// array; the last dimension has stride 1); o and dout: contiguous
// (B, Sq, H, D); dq: contiguous (B, Sq, H, D); dk, dv: contiguous
// (B, T, Hkv, D); all of one type, float32 (bf16 = 0) or bfloat16
// (bf16 = 1). stats: float32 scratch of B * Hkv * Sq * (H / Hkv) * 2,
// delta of B * Hkv * Sq * (H / Hkv); kv_pos: (T,) int32 on the device or
// null. D % 16 == 0, D <= 256, H % Hkv == 0, strides and base addresses
// multiples of 4 elements. Three launches on `stream` without
// synchronising; returns the first failed launch's cudaError_t (0 = all
// three launched).
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* dout, void* dq,
                                void* dk, void* dv, const int32_t* kv_pos,
                                const long long* strides, int B, int Sq,
                                int T, int H, int Hkv, int D, int causal,
                                int window, int q_offset, float scale,
                                int bf16, float* stats, float* delta,
                                int device, void* stream) {
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
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.stats = stats;
  a.delta = delta;
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
